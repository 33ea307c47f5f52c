# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: filter.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0c\x66ilter.proto\x12\x08mjpc_tpu\"4\n\x11\x46ilterInitRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0e\n\x06\x66ilter\x18\x02 \x01(\t\"\x14\n\x12\x46ilterInitResponse\"\x14\n\x12\x46ilterResetRequest\"\x15\n\x13\x46ilterResetResponse\"3\n\x13\x46ilterUpdateRequest\x12\x0c\n\x04\x63trl\x18\x01 \x03(\x01\x12\x0e\n\x06sensor\x18\x02 \x03(\x01\"\x16\n\x14\x46ilterUpdateResponse\"\x14\n\x12\x46ilterStateRequest\"L\n\x13\x46ilterStateResponse\x12\x0c\n\x04qpos\x18\x01 \x03(\x01\x12\x0c\n\x04qvel\x18\x02 \x03(\x01\x12\x0b\n\x03\x61\x63t\x18\x03 \x03(\x01\x12\x0c\n\x04time\x18\x04 \x01(\x01\"\x19\n\x17\x46ilterCovarianceRequest\";\n\x18\x46ilterCovarianceResponse\x12\x12\n\ncovariance\x18\x01 \x03(\x01\x12\x0b\n\x03\x64im\x18\x02 \x01(\x05\"5\n\x12\x46ilterNoiseRequest\x12\x0f\n\x07process\x18\x01 \x03(\x01\x12\x0e\n\x06sensor\x18\x02 \x03(\x01\"6\n\x13\x46ilterNoiseResponse\x12\x0f\n\x07process\x18\x01 \x03(\x01\x12\x0e\n\x06sensor\x18\x02 \x03(\x01\x32\xc4\x03\n\x0fStateEstimation\x12\x41\n\x04Init\x12\x1b.mjpc_tpu.FilterInitRequest\x1a\x1c.mjpc_tpu.FilterInitResponse\x12\x44\n\x05Reset\x12\x1c.mjpc_tpu.FilterResetRequest\x1a\x1d.mjpc_tpu.FilterResetResponse\x12G\n\x06Update\x12\x1d.mjpc_tpu.FilterUpdateRequest\x1a\x1e.mjpc_tpu.FilterUpdateResponse\x12\x44\n\x05State\x12\x1c.mjpc_tpu.FilterStateRequest\x1a\x1d.mjpc_tpu.FilterStateResponse\x12S\n\nCovariance\x12!.mjpc_tpu.FilterCovarianceRequest\x1a\".mjpc_tpu.FilterCovarianceResponse\x12\x44\n\x05Noise\x12\x1c.mjpc_tpu.FilterNoiseRequest\x1a\x1d.mjpc_tpu.FilterNoiseResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'filter_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _FILTERINITREQUEST._serialized_start=26
  _FILTERINITREQUEST._serialized_end=78
  _FILTERINITRESPONSE._serialized_start=80
  _FILTERINITRESPONSE._serialized_end=100
  _FILTERRESETREQUEST._serialized_start=102
  _FILTERRESETREQUEST._serialized_end=122
  _FILTERRESETRESPONSE._serialized_start=124
  _FILTERRESETRESPONSE._serialized_end=145
  _FILTERUPDATEREQUEST._serialized_start=147
  _FILTERUPDATEREQUEST._serialized_end=198
  _FILTERUPDATERESPONSE._serialized_start=200
  _FILTERUPDATERESPONSE._serialized_end=222
  _FILTERSTATEREQUEST._serialized_start=224
  _FILTERSTATEREQUEST._serialized_end=244
  _FILTERSTATERESPONSE._serialized_start=246
  _FILTERSTATERESPONSE._serialized_end=322
  _FILTERCOVARIANCEREQUEST._serialized_start=324
  _FILTERCOVARIANCEREQUEST._serialized_end=349
  _FILTERCOVARIANCERESPONSE._serialized_start=351
  _FILTERCOVARIANCERESPONSE._serialized_end=410
  _FILTERNOISEREQUEST._serialized_start=412
  _FILTERNOISEREQUEST._serialized_end=465
  _FILTERNOISERESPONSE._serialized_start=467
  _FILTERNOISERESPONSE._serialized_end=521
  _STATEESTIMATION._serialized_start=524
  _STATEESTIMATION._serialized_end=976
# @@protoc_insertion_point(module_scope)
