# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: hbpe.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\nhbpe.proto\x12\x04hbpe\"h\n\x0f\x45stimateRequest\x12\r\n\x05image\x18\x01 \x01(\x0c\x12\x18\n\x10person_height_cm\x18\x02 \x01(\x02\x12\x1a\n\rdet_threshold\x18\x03 \x01(\x02H\x00\x88\x01\x01\x42\x10\n\x0e_det_threshold\";\n\x07Segment\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tlength_cm\x18\x02 \x01(\x02\x12\x0f\n\x07visible\x18\x03 \x01(\x08\"N\n\x10\x45stimateResponse\x12\x0c\n\x04\x63ode\x18\x01 \x01(\t\x12\x0b\n\x03msg\x18\x02 \x01(\t\x12\x1f\n\x08segments\x18\x03 \x03(\x0b\x32\r.hbpe.Segment\"\x97\x01\n\x14\x45stimateVideoRequest\x12\r\n\x05video\x18\x01 \x01(\x0c\x12\x18\n\x10person_height_cm\x18\x02 \x01(\x02\x12\x1a\n\rdet_threshold\x18\x03 \x01(\x02H\x00\x88\x01\x01\x12\x14\n\x0c\x66rame_stride\x18\x04 \x01(\r\x12\x12\n\nmax_frames\x18\x05 \x01(\rB\x10\n\x0e_det_threshold\"J\n\x0b\x46rameResult\x12\r\n\x05\x66rame\x18\x01 \x01(\r\x12\x0b\n\x03msg\x18\x02 \x01(\t\x12\x1f\n\x08segments\x18\x03 \x03(\x0b\x32\r.hbpe.Segment\"\xbe\x01\n\x15\x45stimateVideoResponse\x12\x0c\n\x04\x63ode\x18\x01 \x01(\t\x12\x0b\n\x03msg\x18\x02 \x01(\t\x12\x0b\n\x03\x66ps\x18\x03 \x01(\x02\x12\x14\n\x0c\x66rame_stride\x18\x04 \x01(\r\x12!\n\x06\x66rames\x18\x05 \x03(\x0b\x32\x11.hbpe.FrameResult\x12&\n\x0fmedian_segments\x18\x06 \x03(\x0b\x32\r.hbpe.Segment\x12\x1c\n\x14num_frames_processed\x18\x07 \x01(\r\"6\n\x11VideoStreamHeader\x12\x0b\n\x03\x66ps\x18\x01 \x01(\x02\x12\x14\n\x0c\x66rame_stride\x18\x02 \x01(\r\"\x98\x01\n\x0fVideoStreamItem\x12)\n\x06header\x18\x01 \x01(\x0b\x32\x17.hbpe.VideoStreamHeaderH\x00\x12\"\n\x05\x66rame\x18\x02 \x01(\x0b\x32\x11.hbpe.FrameResultH\x00\x12.\n\x07summary\x18\x03 \x01(\x0b\x32\x1b.hbpe.EstimateVideoResponseH\x00\x42\x06\n\x04item\"N\n\x0bInferTensor\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08\x64\x61tatype\x18\x02 \x01(\t\x12\r\n\x05shape\x18\x03 \x03(\x03\x12\x10\n\x08raw_data\x18\x04 \x01(\x0c\"\x83\x01\n\x11ModelInferRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12!\n\x06inputs\x18\x02 \x03(\x0b\x32\x11.hbpe.InferTensor\x12\x14\n\x0coutput_names\x18\x03 \x03(\t\x12\x15\n\rmodel_version\x18\x04 \x01(\t\x12\n\n\x02id\x18\x05 \x01(\t\"o\n\x18ModelStreamInferResponse\x12\x15\n\rerror_message\x18\x01 \x01(\t\x12\x30\n\x0einfer_response\x18\x02 \x01(\x0b\x32\x18.hbpe.ModelInferResponse\x12\n\n\x02id\x18\x03 \x01(\t\"L\n\x12ModelInferResponse\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\"\n\x07outputs\x18\x02 \x03(\x0b\x32\x11.hbpe.InferTensor\"A\n\x14ModelMetadataRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x15\n\rmodel_version\x18\x02 \x01(\t\";\n\nTensorMeta\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08\x64\x61tatype\x18\x02 \x01(\t\x12\r\n\x05shape\x18\x03 \x03(\x03\"\xb7\x01\n\x15ModelMetadataResponse\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08platform\x18\x02 \x01(\t\x12\x16\n\x0emax_batch_size\x18\x03 \x01(\x05\x12\x0f\n\x07weights\x18\x04 \x01(\t\x12 \n\x06inputs\x18\x05 \x03(\x0b\x32\x10.hbpe.TensorMeta\x12!\n\x07outputs\x18\x06 \x03(\x0b\x32\x10.hbpe.TensorMeta\x12\x10\n\x08versions\x18\x07 \x03(\t\"M\n\x0cTensorConfig\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tdata_type\x18\x02 \x01(\t\x12\x0e\n\x06\x66ormat\x18\x03 \x01(\t\x12\x0c\n\x04\x64ims\x18\x04 \x03(\x03\"2\n\x13InstanceGroupConfig\x12\r\n\x05\x63ount\x18\x01 \x01(\x05\x12\x0c\n\x04kind\x18\x02 \x01(\t\"[\n\x15\x44ynamicBatchingConfig\x12\x1c\n\x14preferred_batch_size\x18\x01 \x03(\x05\x12$\n\x1cmax_queue_delay_microseconds\x18\x02 \x01(\x04\"?\n\x12ModelConfigRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x15\n\rmodel_version\x18\x02 \x01(\t\"\x98\x02\n\x13ModelConfigResponse\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08platform\x18\x02 \x01(\t\x12\x16\n\x0emax_batch_size\x18\x03 \x01(\x05\x12!\n\x05input\x18\x04 \x03(\x0b\x32\x12.hbpe.TensorConfig\x12\"\n\x06output\x18\x05 \x03(\x0b\x32\x12.hbpe.TensorConfig\x12\x31\n\x0einstance_group\x18\x06 \x03(\x0b\x32\x19.hbpe.InstanceGroupConfig\x12:\n\x10\x64ynamic_batching\x18\x07 \x01(\x0b\x32\x1b.hbpe.DynamicBatchingConfigH\x00\x88\x01\x01\x42\x13\n\x11_dynamic_batching\")\n\x13ModelControlRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\"4\n\x14ModelControlResponse\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0e\n\x06loaded\x18\x02 \x01(\x08\"\x18\n\x16RepositoryIndexRequest\"[\n\nModelIndex\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05state\x18\x02 \x01(\t\x12\x0e\n\x06loaded\x18\x03 \x01(\x08\x12\x0f\n\x07weights\x18\x04 \x01(\t\x12\x0f\n\x07version\x18\x05 \x01(\t\";\n\x17RepositoryIndexResponse\x12 \n\x06models\x18\x01 \x03(\x0b\x32\x10.hbpe.ModelIndex\">\n\x11ModelReadyRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x15\n\rmodel_version\x18\x02 \x01(\t\"#\n\x12ModelReadyResponse\x12\r\n\x05ready\x18\x01 \x01(\x08\"\x17\n\x15ServerMetadataRequest\"K\n\x16ServerMetadataResponse\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\x12\n\nextensions\x18\x03 \x03(\t\")\n\x0cStatDuration\x12\r\n\x05\x63ount\x18\x01 \x01(\x04\x12\n\n\x02ns\x18\x02 \x01(\x04\"\xf8\x01\n\nInferStats\x12#\n\x07success\x18\x01 \x01(\x0b\x32\x12.hbpe.StatDuration\x12 \n\x04\x66\x61il\x18\x02 \x01(\x0b\x32\x12.hbpe.StatDuration\x12!\n\x05queue\x18\x03 \x01(\x0b\x32\x12.hbpe.StatDuration\x12)\n\rcompute_input\x18\x04 \x01(\x0b\x32\x12.hbpe.StatDuration\x12)\n\rcompute_infer\x18\x05 \x01(\x0b\x32\x12.hbpe.StatDuration\x12*\n\x0e\x63ompute_output\x18\x06 \x01(\x0b\x32\x12.hbpe.StatDuration\"J\n\tBatchStat\x12\x12\n\nbatch_size\x18\x01 \x01(\r\x12)\n\rcompute_infer\x18\x02 \x01(\x0b\x32\x12.hbpe.StatDuration\"\xc5\x01\n\tModelStat\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\x16\n\x0elast_inference\x18\x03 \x01(\x04\x12\x17\n\x0finference_count\x18\x04 \x01(\x04\x12\x17\n\x0f\x65xecution_count\x18\x05 \x01(\x04\x12)\n\x0finference_stats\x18\x06 \x01(\x0b\x32\x10.hbpe.InferStats\x12$\n\x0b\x62\x61tch_stats\x18\x07 \x03(\x0b\x32\x0f.hbpe.BatchStat\"C\n\x16ModelStatisticsRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x15\n\rmodel_version\x18\x02 \x01(\t\"?\n\x17ModelStatisticsResponse\x12$\n\x0bmodel_stats\x18\x01 \x03(\x0b\x32\x0f.hbpe.ModelStat\"*\n\x12LogSettingsRequest\x12\x14\n\x0cupdates_json\x18\x01 \x01(\t\",\n\x13LogSettingsResponse\x12\x15\n\rsettings_json\x18\x01 \x01(\t\"+\n\x13TraceSettingRequest\x12\x14\n\x0cupdates_json\x18\x01 \x01(\t\"-\n\x14TraceSettingResponse\x12\x15\n\rsettings_json\x18\x01 \x01(\t\"\x0f\n\rHealthRequest\"\x95\x01\n\x0eHealthResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\x0f\n\x07\x64\x65vices\x18\x02 \x03(\t\x12\x32\n\x07weights\x18\x03 \x03(\x0b\x32!.hbpe.HealthResponse.WeightsEntry\x1a.\n\x0cWeightsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x32\xf4\x08\n\tInference\x12\x39\n\x08\x45stimate\x12\x15.hbpe.EstimateRequest\x1a\x16.hbpe.EstimateResponse\x12H\n\rEstimateVideo\x12\x1a.hbpe.EstimateVideoRequest\x1a\x1b.hbpe.EstimateVideoResponse\x12J\n\x13\x45stimateVideoStream\x12\x1a.hbpe.EstimateVideoRequest\x1a\x15.hbpe.VideoStreamItem0\x01\x12\x33\n\x06Health\x12\x13.hbpe.HealthRequest\x1a\x14.hbpe.HealthResponse\x12?\n\nModelInfer\x12\x17.hbpe.ModelInferRequest\x1a\x18.hbpe.ModelInferResponse\x12O\n\x10ModelStreamInfer\x12\x17.hbpe.ModelInferRequest\x1a\x1e.hbpe.ModelStreamInferResponse(\x01\x30\x01\x12H\n\rModelMetadata\x12\x1a.hbpe.ModelMetadataRequest\x1a\x1b.hbpe.ModelMetadataResponse\x12\x42\n\x0bModelConfig\x12\x18.hbpe.ModelConfigRequest\x1a\x19.hbpe.ModelConfigResponse\x12N\n\x0fRepositoryIndex\x12\x1c.hbpe.RepositoryIndexRequest\x1a\x1d.hbpe.RepositoryIndexResponse\x12\x42\n\tModelLoad\x12\x19.hbpe.ModelControlRequest\x1a\x1a.hbpe.ModelControlResponse\x12\x44\n\x0bModelUnload\x12\x19.hbpe.ModelControlRequest\x1a\x1a.hbpe.ModelControlResponse\x12?\n\nModelReady\x12\x17.hbpe.ModelReadyRequest\x1a\x18.hbpe.ModelReadyResponse\x12K\n\x0eServerMetadata\x12\x1b.hbpe.ServerMetadataRequest\x1a\x1c.hbpe.ServerMetadataResponse\x12N\n\x0fModelStatistics\x12\x1c.hbpe.ModelStatisticsRequest\x1a\x1d.hbpe.ModelStatisticsResponse\x12\x42\n\x0bLogSettings\x12\x18.hbpe.LogSettingsRequest\x1a\x19.hbpe.LogSettingsResponse\x12\x45\n\x0cTraceSetting\x12\x19.hbpe.TraceSettingRequest\x1a\x1a.hbpe.TraceSettingResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'hbpe_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _HEALTHRESPONSE_WEIGHTSENTRY._options = None
  _HEALTHRESPONSE_WEIGHTSENTRY._serialized_options = b'8\001'
  _ESTIMATEREQUEST._serialized_start=20
  _ESTIMATEREQUEST._serialized_end=124
  _SEGMENT._serialized_start=126
  _SEGMENT._serialized_end=185
  _ESTIMATERESPONSE._serialized_start=187
  _ESTIMATERESPONSE._serialized_end=265
  _ESTIMATEVIDEOREQUEST._serialized_start=268
  _ESTIMATEVIDEOREQUEST._serialized_end=419
  _FRAMERESULT._serialized_start=421
  _FRAMERESULT._serialized_end=495
  _ESTIMATEVIDEORESPONSE._serialized_start=498
  _ESTIMATEVIDEORESPONSE._serialized_end=688
  _VIDEOSTREAMHEADER._serialized_start=690
  _VIDEOSTREAMHEADER._serialized_end=744
  _VIDEOSTREAMITEM._serialized_start=747
  _VIDEOSTREAMITEM._serialized_end=899
  _INFERTENSOR._serialized_start=901
  _INFERTENSOR._serialized_end=979
  _MODELINFERREQUEST._serialized_start=982
  _MODELINFERREQUEST._serialized_end=1113
  _MODELSTREAMINFERRESPONSE._serialized_start=1115
  _MODELSTREAMINFERRESPONSE._serialized_end=1226
  _MODELINFERRESPONSE._serialized_start=1228
  _MODELINFERRESPONSE._serialized_end=1304
  _MODELMETADATAREQUEST._serialized_start=1306
  _MODELMETADATAREQUEST._serialized_end=1371
  _TENSORMETA._serialized_start=1373
  _TENSORMETA._serialized_end=1432
  _MODELMETADATARESPONSE._serialized_start=1435
  _MODELMETADATARESPONSE._serialized_end=1618
  _TENSORCONFIG._serialized_start=1620
  _TENSORCONFIG._serialized_end=1697
  _INSTANCEGROUPCONFIG._serialized_start=1699
  _INSTANCEGROUPCONFIG._serialized_end=1749
  _DYNAMICBATCHINGCONFIG._serialized_start=1751
  _DYNAMICBATCHINGCONFIG._serialized_end=1842
  _MODELCONFIGREQUEST._serialized_start=1844
  _MODELCONFIGREQUEST._serialized_end=1907
  _MODELCONFIGRESPONSE._serialized_start=1910
  _MODELCONFIGRESPONSE._serialized_end=2190
  _MODELCONTROLREQUEST._serialized_start=2192
  _MODELCONTROLREQUEST._serialized_end=2233
  _MODELCONTROLRESPONSE._serialized_start=2235
  _MODELCONTROLRESPONSE._serialized_end=2287
  _REPOSITORYINDEXREQUEST._serialized_start=2289
  _REPOSITORYINDEXREQUEST._serialized_end=2313
  _MODELINDEX._serialized_start=2315
  _MODELINDEX._serialized_end=2406
  _REPOSITORYINDEXRESPONSE._serialized_start=2408
  _REPOSITORYINDEXRESPONSE._serialized_end=2467
  _MODELREADYREQUEST._serialized_start=2469
  _MODELREADYREQUEST._serialized_end=2531
  _MODELREADYRESPONSE._serialized_start=2533
  _MODELREADYRESPONSE._serialized_end=2568
  _SERVERMETADATAREQUEST._serialized_start=2570
  _SERVERMETADATAREQUEST._serialized_end=2593
  _SERVERMETADATARESPONSE._serialized_start=2595
  _SERVERMETADATARESPONSE._serialized_end=2670
  _STATDURATION._serialized_start=2672
  _STATDURATION._serialized_end=2713
  _INFERSTATS._serialized_start=2716
  _INFERSTATS._serialized_end=2964
  _BATCHSTAT._serialized_start=2966
  _BATCHSTAT._serialized_end=3040
  _MODELSTAT._serialized_start=3043
  _MODELSTAT._serialized_end=3240
  _MODELSTATISTICSREQUEST._serialized_start=3242
  _MODELSTATISTICSREQUEST._serialized_end=3309
  _MODELSTATISTICSRESPONSE._serialized_start=3311
  _MODELSTATISTICSRESPONSE._serialized_end=3374
  _LOGSETTINGSREQUEST._serialized_start=3376
  _LOGSETTINGSREQUEST._serialized_end=3418
  _LOGSETTINGSRESPONSE._serialized_start=3420
  _LOGSETTINGSRESPONSE._serialized_end=3464
  _TRACESETTINGREQUEST._serialized_start=3466
  _TRACESETTINGREQUEST._serialized_end=3509
  _TRACESETTINGRESPONSE._serialized_start=3511
  _TRACESETTINGRESPONSE._serialized_end=3556
  _HEALTHREQUEST._serialized_start=3558
  _HEALTHREQUEST._serialized_end=3573
  _HEALTHRESPONSE._serialized_start=3576
  _HEALTHRESPONSE._serialized_end=3725
  _HEALTHRESPONSE_WEIGHTSENTRY._serialized_start=3679
  _HEALTHRESPONSE_WEIGHTSENTRY._serialized_end=3725
  _INFERENCE._serialized_start=3728
  _INFERENCE._serialized_end=4868
# @@protoc_insertion_point(module_scope)
