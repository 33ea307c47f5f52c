# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: agent.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0b\x61gent.proto\x12\x08mjpc_tpu\"Y\n\x0bInitRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0f\n\x07planner\x18\x02 \x01(\t\x12\x15\n\rhorizon_steps\x18\x03 \x01(\x05\x12\x11\n\tmodel_xml\x18\x04 \x01(\t\"\x0e\n\x0cInitResponse\"w\n\x05State\x12\x0c\n\x04time\x18\x01 \x01(\x01\x12\x0c\n\x04qpos\x18\x02 \x03(\x01\x12\x0c\n\x04qvel\x18\x03 \x03(\x01\x12\x0b\n\x03\x61\x63t\x18\x04 \x03(\x01\x12\x11\n\tmocap_pos\x18\x05 \x03(\x01\x12\x12\n\nmocap_quat\x18\x06 \x03(\x01\x12\x10\n\x08userdata\x18\x07 \x03(\x01\"1\n\x0fSetStateRequest\x12\x1e\n\x05state\x18\x01 \x01(\x0b\x32\x0f.mjpc_tpu.State\"\x12\n\x10SetStateResponse\"\x11\n\x0fGetStateRequest\"2\n\x10GetStateResponse\x12\x1e\n\x05state\x18\x01 \x01(\x0b\x32\x0f.mjpc_tpu.State\"q\n\x10GetActionRequest\x12\x0c\n\x04time\x18\x01 \x01(\x01\x12\x1b\n\x13use_previous_policy\x18\x02 \x01(\x08\x12\x1a\n\x12\x61veraging_duration\x18\x03 \x01(\x01\x12\x16\n\x0enominal_action\x18\x04 \x01(\x08\"#\n\x11GetActionResponse\x12\x0e\n\x06\x61\x63tion\x18\x01 \x03(\x01\"\x14\n\x12PlannerStepRequest\"*\n\x13PlannerStepResponse\x12\x13\n\x0b\x62\x65st_return\x18\x01 \x01(\x01\"*\n\x0bStepRequest\x12\x1b\n\x13use_previous_policy\x18\x01 \x01(\x08\".\n\x0cStepResponse\x12\x1e\n\x05state\x18\x01 \x01(\x0b\x32\x0f.mjpc_tpu.State\" \n\x0cResetRequest\x12\x10\n\x08keyframe\x18\x01 \x01(\t\"\x0f\n\rResetResponse\",\n\rTaskParameter\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01\"G\n\x18SetTaskParametersRequest\x12+\n\nparameters\x18\x01 \x03(\x0b\x32\x17.mjpc_tpu.TaskParameter\"\x1b\n\x19SetTaskParametersResponse\"\x1a\n\x18GetTaskParametersRequest\"H\n\x19GetTaskParametersResponse\x12+\n\nparameters\x18\x01 \x03(\x0b\x32\x17.mjpc_tpu.TaskParameter\"*\n\nCostWeight\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0e\n\x06weight\x18\x02 \x01(\x01\">\n\x15SetCostWeightsRequest\x12%\n\x07weights\x18\x01 \x03(\x0b\x32\x14.mjpc_tpu.CostWeight\"\x18\n\x16SetCostWeightsResponse\" \n\x1eGetCostValuesAndWeightsRequest\"7\n\x08\x43ostTerm\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01\x12\x0e\n\x06weight\x18\x03 \x01(\x01\"X\n\x1fGetCostValuesAndWeightsResponse\x12!\n\x05terms\x18\x01 \x03(\x0b\x32\x12.mjpc_tpu.CostTerm\x12\x12\n\ntotal_cost\x18\x02 \x01(\x01\"\x15\n\x13GetResidualsRequest\")\n\x14GetResidualsResponse\x12\x11\n\tresiduals\x18\x01 \x03(\x01\"-\n\x14StartPlanningRequest\x12\x15\n\rrate_limit_hz\x18\x01 \x01(\x01\"\x17\n\x15StartPlanningResponse\"\x15\n\x13StopPlanningRequest\"\x16\n\x14StopPlanningResponse\"\x1e\n\x0eSetModeRequest\x12\x0c\n\x04mode\x18\x01 \x01(\t\"\x11\n\x0fSetModeResponse\"\x10\n\x0eGetModeRequest\"\x1f\n\x0fGetModeResponse\x12\x0c\n\x04mode\x18\x01 \x01(\t\"\x14\n\x12GetAllModesRequest\")\n\x13GetAllModesResponse\x12\x12\n\nmode_names\x18\x01 \x03(\t\"\xa9\x01\n\x12SetAnythingRequest\x12\x1e\n\x05state\x18\x01 \x01(\x0b\x32\x0f.mjpc_tpu.State\x12*\n\x0c\x63ost_weights\x18\x02 \x03(\x0b\x32\x14.mjpc_tpu.CostWeight\x12+\n\nparameters\x18\x03 \x03(\x0b\x32\x17.mjpc_tpu.TaskParameter\x12\x0c\n\x04mode\x18\x04 \x01(\t\x12\x0c\n\x04\x63trl\x18\x05 \x03(\x01\"\x15\n\x13SetAnythingResponse\"\x1a\n\x18GetBestTrajectoryRequest\"[\n\x19GetBestTrajectoryResponse\x12\x13\n\x0b\x62\x65st_return\x18\x01 \x01(\x01\x12\x19\n\x11\x63\x61ndidate_returns\x18\x02 \x03(\x01\x12\x0e\n\x06winner\x18\x03 \x01(\x05\x32\xae\x0b\n\x05\x41gent\x12\x35\n\x04Init\x12\x15.mjpc_tpu.InitRequest\x1a\x16.mjpc_tpu.InitResponse\x12\x41\n\x08SetState\x12\x19.mjpc_tpu.SetStateRequest\x1a\x1a.mjpc_tpu.SetStateResponse\x12\x41\n\x08GetState\x12\x19.mjpc_tpu.GetStateRequest\x1a\x1a.mjpc_tpu.GetStateResponse\x12\x44\n\tGetAction\x12\x1a.mjpc_tpu.GetActionRequest\x1a\x1b.mjpc_tpu.GetActionResponse\x12J\n\x0bPlannerStep\x12\x1c.mjpc_tpu.PlannerStepRequest\x1a\x1d.mjpc_tpu.PlannerStepResponse\x12\x35\n\x04Step\x12\x15.mjpc_tpu.StepRequest\x1a\x16.mjpc_tpu.StepResponse\x12\x38\n\x05Reset\x12\x16.mjpc_tpu.ResetRequest\x1a\x17.mjpc_tpu.ResetResponse\x12\\\n\x11SetTaskParameters\x12\".mjpc_tpu.SetTaskParametersRequest\x1a#.mjpc_tpu.SetTaskParametersResponse\x12\\\n\x11GetTaskParameters\x12\".mjpc_tpu.GetTaskParametersRequest\x1a#.mjpc_tpu.GetTaskParametersResponse\x12S\n\x0eSetCostWeights\x12\x1f.mjpc_tpu.SetCostWeightsRequest\x1a .mjpc_tpu.SetCostWeightsResponse\x12n\n\x17GetCostValuesAndWeights\x12(.mjpc_tpu.GetCostValuesAndWeightsRequest\x1a).mjpc_tpu.GetCostValuesAndWeightsResponse\x12M\n\x0cGetResiduals\x12\x1d.mjpc_tpu.GetResidualsRequest\x1a\x1e.mjpc_tpu.GetResidualsResponse\x12\\\n\x11GetBestTrajectory\x12\".mjpc_tpu.GetBestTrajectoryRequest\x1a#.mjpc_tpu.GetBestTrajectoryResponse\x12>\n\x07SetMode\x12\x18.mjpc_tpu.SetModeRequest\x1a\x19.mjpc_tpu.SetModeResponse\x12>\n\x07GetMode\x12\x18.mjpc_tpu.GetModeRequest\x1a\x19.mjpc_tpu.GetModeResponse\x12J\n\x0bGetAllModes\x12\x1c.mjpc_tpu.GetAllModesRequest\x1a\x1d.mjpc_tpu.GetAllModesResponse\x12J\n\x0bSetAnything\x12\x1c.mjpc_tpu.SetAnythingRequest\x1a\x1d.mjpc_tpu.SetAnythingResponse\x12P\n\rStartPlanning\x12\x1e.mjpc_tpu.StartPlanningRequest\x1a\x1f.mjpc_tpu.StartPlanningResponse\x12M\n\x0cStopPlanning\x12\x1d.mjpc_tpu.StopPlanningRequest\x1a\x1e.mjpc_tpu.StopPlanningResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'agent_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _INITREQUEST._serialized_start=25
  _INITREQUEST._serialized_end=114
  _INITRESPONSE._serialized_start=116
  _INITRESPONSE._serialized_end=130
  _STATE._serialized_start=132
  _STATE._serialized_end=251
  _SETSTATEREQUEST._serialized_start=253
  _SETSTATEREQUEST._serialized_end=302
  _SETSTATERESPONSE._serialized_start=304
  _SETSTATERESPONSE._serialized_end=322
  _GETSTATEREQUEST._serialized_start=324
  _GETSTATEREQUEST._serialized_end=341
  _GETSTATERESPONSE._serialized_start=343
  _GETSTATERESPONSE._serialized_end=393
  _GETACTIONREQUEST._serialized_start=395
  _GETACTIONREQUEST._serialized_end=508
  _GETACTIONRESPONSE._serialized_start=510
  _GETACTIONRESPONSE._serialized_end=545
  _PLANNERSTEPREQUEST._serialized_start=547
  _PLANNERSTEPREQUEST._serialized_end=567
  _PLANNERSTEPRESPONSE._serialized_start=569
  _PLANNERSTEPRESPONSE._serialized_end=611
  _STEPREQUEST._serialized_start=613
  _STEPREQUEST._serialized_end=655
  _STEPRESPONSE._serialized_start=657
  _STEPRESPONSE._serialized_end=703
  _RESETREQUEST._serialized_start=705
  _RESETREQUEST._serialized_end=737
  _RESETRESPONSE._serialized_start=739
  _RESETRESPONSE._serialized_end=754
  _TASKPARAMETER._serialized_start=756
  _TASKPARAMETER._serialized_end=800
  _SETTASKPARAMETERSREQUEST._serialized_start=802
  _SETTASKPARAMETERSREQUEST._serialized_end=873
  _SETTASKPARAMETERSRESPONSE._serialized_start=875
  _SETTASKPARAMETERSRESPONSE._serialized_end=902
  _GETTASKPARAMETERSREQUEST._serialized_start=904
  _GETTASKPARAMETERSREQUEST._serialized_end=930
  _GETTASKPARAMETERSRESPONSE._serialized_start=932
  _GETTASKPARAMETERSRESPONSE._serialized_end=1004
  _COSTWEIGHT._serialized_start=1006
  _COSTWEIGHT._serialized_end=1048
  _SETCOSTWEIGHTSREQUEST._serialized_start=1050
  _SETCOSTWEIGHTSREQUEST._serialized_end=1112
  _SETCOSTWEIGHTSRESPONSE._serialized_start=1114
  _SETCOSTWEIGHTSRESPONSE._serialized_end=1138
  _GETCOSTVALUESANDWEIGHTSREQUEST._serialized_start=1140
  _GETCOSTVALUESANDWEIGHTSREQUEST._serialized_end=1172
  _COSTTERM._serialized_start=1174
  _COSTTERM._serialized_end=1229
  _GETCOSTVALUESANDWEIGHTSRESPONSE._serialized_start=1231
  _GETCOSTVALUESANDWEIGHTSRESPONSE._serialized_end=1319
  _GETRESIDUALSREQUEST._serialized_start=1321
  _GETRESIDUALSREQUEST._serialized_end=1342
  _GETRESIDUALSRESPONSE._serialized_start=1344
  _GETRESIDUALSRESPONSE._serialized_end=1385
  _STARTPLANNINGREQUEST._serialized_start=1387
  _STARTPLANNINGREQUEST._serialized_end=1432
  _STARTPLANNINGRESPONSE._serialized_start=1434
  _STARTPLANNINGRESPONSE._serialized_end=1457
  _STOPPLANNINGREQUEST._serialized_start=1459
  _STOPPLANNINGREQUEST._serialized_end=1480
  _STOPPLANNINGRESPONSE._serialized_start=1482
  _STOPPLANNINGRESPONSE._serialized_end=1504
  _SETMODEREQUEST._serialized_start=1506
  _SETMODEREQUEST._serialized_end=1536
  _SETMODERESPONSE._serialized_start=1538
  _SETMODERESPONSE._serialized_end=1555
  _GETMODEREQUEST._serialized_start=1557
  _GETMODEREQUEST._serialized_end=1573
  _GETMODERESPONSE._serialized_start=1575
  _GETMODERESPONSE._serialized_end=1606
  _GETALLMODESREQUEST._serialized_start=1608
  _GETALLMODESREQUEST._serialized_end=1628
  _GETALLMODESRESPONSE._serialized_start=1630
  _GETALLMODESRESPONSE._serialized_end=1671
  _SETANYTHINGREQUEST._serialized_start=1674
  _SETANYTHINGREQUEST._serialized_end=1843
  _SETANYTHINGRESPONSE._serialized_start=1845
  _SETANYTHINGRESPONSE._serialized_end=1866
  _GETBESTTRAJECTORYREQUEST._serialized_start=1868
  _GETBESTTRAJECTORYREQUEST._serialized_end=1894
  _GETBESTTRAJECTORYRESPONSE._serialized_start=1896
  _GETBESTTRAJECTORYRESPONSE._serialized_end=1987
  _AGENT._serialized_start=1990
  _AGENT._serialized_end=3444
# @@protoc_insertion_point(module_scope)
