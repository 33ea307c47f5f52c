# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: direct.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0c\x64irect.proto\x12\x08mjpc_tpu\"5\n\x11\x44irectInitRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0f\n\x07horizon\x18\x02 \x01(\x05\"\x14\n\x12\x44irectInitResponse\"N\n\x11\x44irectDataRequest\x12\r\n\x05index\x18\x01 \x01(\x05\x12\x0c\n\x04qpos\x18\x02 \x03(\x01\x12\x0e\n\x06sensor\x18\x03 \x03(\x01\x12\x0c\n\x04\x63trl\x18\x04 \x03(\x01\"\"\n\x12\x44irectDataResponse\x12\x0c\n\x04qpos\x18\x01 \x03(\x01\"\\\n\x15\x44irectSettingsRequest\x12\x16\n\x0emax_iterations\x18\x01 \x01(\x05\x12\x15\n\rsensor_weight\x18\x02 \x01(\x01\x12\x14\n\x0c\x66orce_weight\x18\x03 \x01(\x01\"\x18\n\x16\x44irectSettingsResponse\"\x17\n\x15\x44irectOptimizeRequest\"V\n\x16\x44irectOptimizeResponse\x12\x14\n\x0c\x63ost_initial\x18\x01 \x01(\x01\x12\x12\n\ncost_final\x18\x02 \x01(\x01\x12\x12\n\niterations\x18\x03 \x01(\x05\"\x13\n\x11\x44irectCostRequest\"\"\n\x12\x44irectCostResponse\x12\x0c\n\x04\x63ost\x18\x01 \x01(\x01\"\x15\n\x13\x44irectStatusRequest\":\n\x14\x44irectStatusResponse\x12\x0f\n\x07horizon\x18\x01 \x01(\x05\x12\x11\n\toptimized\x18\x02 \x01(\x08\"H\n\x12\x44irectNoiseRequest\x12\x0f\n\x07process\x18\x01 \x03(\x01\x12\x0e\n\x06sensor\x18\x02 \x03(\x01\x12\x11\n\tparameter\x18\x03 \x03(\x01\"I\n\x13\x44irectNoiseResponse\x12\x0f\n\x07process\x18\x01 \x03(\x01\x12\x0e\n\x06sensor\x18\x02 \x03(\x01\x12\x11\n\tparameter\x18\x03 \x03(\x01\"\x19\n\x17\x44irectSensorInfoRequest\"c\n\x18\x44irectSensorInfoResponse\x12\x13\n\x0bstart_index\x18\x01 \x01(\x05\x12\x18\n\x10num_measurements\x18\x02 \x01(\x05\x12\x18\n\x10\x64im_measurements\x18\x03 \x01(\x05\x32\xd3\x04\n\x06\x44irect\x12\x41\n\x04Init\x12\x1b.mjpc_tpu.DirectInitRequest\x1a\x1c.mjpc_tpu.DirectInitResponse\x12\x41\n\x04\x44\x61ta\x12\x1b.mjpc_tpu.DirectDataRequest\x1a\x1c.mjpc_tpu.DirectDataResponse\x12M\n\x08Settings\x12\x1f.mjpc_tpu.DirectSettingsRequest\x1a .mjpc_tpu.DirectSettingsResponse\x12M\n\x08Optimize\x12\x1f.mjpc_tpu.DirectOptimizeRequest\x1a .mjpc_tpu.DirectOptimizeResponse\x12\x41\n\x04\x43ost\x12\x1b.mjpc_tpu.DirectCostRequest\x1a\x1c.mjpc_tpu.DirectCostResponse\x12G\n\x06Status\x12\x1d.mjpc_tpu.DirectStatusRequest\x1a\x1e.mjpc_tpu.DirectStatusResponse\x12\x44\n\x05Noise\x12\x1c.mjpc_tpu.DirectNoiseRequest\x1a\x1d.mjpc_tpu.DirectNoiseResponse\x12S\n\nSensorInfo\x12!.mjpc_tpu.DirectSensorInfoRequest\x1a\".mjpc_tpu.DirectSensorInfoResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'direct_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DIRECTINITREQUEST._serialized_start=26
  _DIRECTINITREQUEST._serialized_end=79
  _DIRECTINITRESPONSE._serialized_start=81
  _DIRECTINITRESPONSE._serialized_end=101
  _DIRECTDATAREQUEST._serialized_start=103
  _DIRECTDATAREQUEST._serialized_end=181
  _DIRECTDATARESPONSE._serialized_start=183
  _DIRECTDATARESPONSE._serialized_end=217
  _DIRECTSETTINGSREQUEST._serialized_start=219
  _DIRECTSETTINGSREQUEST._serialized_end=311
  _DIRECTSETTINGSRESPONSE._serialized_start=313
  _DIRECTSETTINGSRESPONSE._serialized_end=337
  _DIRECTOPTIMIZEREQUEST._serialized_start=339
  _DIRECTOPTIMIZEREQUEST._serialized_end=362
  _DIRECTOPTIMIZERESPONSE._serialized_start=364
  _DIRECTOPTIMIZERESPONSE._serialized_end=450
  _DIRECTCOSTREQUEST._serialized_start=452
  _DIRECTCOSTREQUEST._serialized_end=471
  _DIRECTCOSTRESPONSE._serialized_start=473
  _DIRECTCOSTRESPONSE._serialized_end=507
  _DIRECTSTATUSREQUEST._serialized_start=509
  _DIRECTSTATUSREQUEST._serialized_end=530
  _DIRECTSTATUSRESPONSE._serialized_start=532
  _DIRECTSTATUSRESPONSE._serialized_end=590
  _DIRECTNOISEREQUEST._serialized_start=592
  _DIRECTNOISEREQUEST._serialized_end=664
  _DIRECTNOISERESPONSE._serialized_start=666
  _DIRECTNOISERESPONSE._serialized_end=739
  _DIRECTSENSORINFOREQUEST._serialized_start=741
  _DIRECTSENSORINFOREQUEST._serialized_end=766
  _DIRECTSENSORINFORESPONSE._serialized_start=768
  _DIRECTSENSORINFORESPONSE._serialized_end=867
  _DIRECT._serialized_start=870
  _DIRECT._serialized_end=1465
# @@protoc_insertion_point(module_scope)
