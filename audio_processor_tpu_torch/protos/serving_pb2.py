# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: serving.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rserving.proto\x12\x16\x61udio_processor_tpu.v1\"S\n\x11TranscribeRequest\x12\r\n\x05\x61udio\x18\x01 \x01(\x0c\x12\x16\n\x0ewith_sentiment\x18\x02 \x01(\x08\x12\x17\n\x0ftimeout_seconds\x18\x03 \x01(\x01\"\xc2\x01\n\x0b\x43hunkResult\x12\x11\n\tchunk_idx\x18\x01 \x01(\x05\x12\x12\n\nstart_time\x18\x02 \x01(\x01\x12\x10\n\x08\x65nd_time\x18\x03 \x01(\x01\x12\x1b\n\x13transcription_chunk\x18\x04 \x01(\t\x12\x1b\n\x13\x61gent_transcription\x18\x05 \x01(\t\x12\x1c\n\x14\x63lient_transcription\x18\x06 \x01(\t\x12\r\n\x05\x65rror\x18\x07 \x01(\t\x12\x13\n\x0b\x65xtras_json\x18\x08 \x01(\t\"\xe2\x01\n\x12TranscribeResponse\x12\x18\n\x10\x64uration_seconds\x18\x01 \x01(\x01\x12\x12\n\nnum_chunks\x18\x02 \x01(\x05\x12\x15\n\rtranscription\x18\x03 \x01(\t\x12\x1b\n\x13\x61gent_transcription\x18\x04 \x01(\t\x12\x1c\n\x14\x63lient_transcription\x18\x05 \x01(\t\x12\x33\n\x06\x63hunks\x18\x06 \x03(\x0b\x32#.audio_processor_tpu.v1.ChunkResult\x12\x17\n\x0flatency_seconds\x18\x07 \x01(\x01\"C\n\x0bStreamAudio\x12\r\n\x05pcm16\x18\x01 \x01(\x0c\x12\x13\n\x0bsample_rate\x18\x02 \x01(\r\x12\x10\n\x08\x63hannels\x18\x03 \x01(\r\"Q\n\x0cStreamResult\x12\x32\n\x05\x63hunk\x18\x01 \x01(\x0b\x32#.audio_processor_tpu.v1.ChunkResult\x12\r\n\x05\x66inal\x18\x02 \x01(\x08\"\x0f\n\rHealthRequest\",\n\x0eHealthResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x0e\n\x06status\x18\x02 \x01(\t\"\x0e\n\x0cStatsRequest\"#\n\rStatsResponse\x12\x12\n\nstats_json\x18\x01 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'serving_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TRANSCRIBEREQUEST._serialized_start=41
  _TRANSCRIBEREQUEST._serialized_end=124
  _CHUNKRESULT._serialized_start=127
  _CHUNKRESULT._serialized_end=321
  _TRANSCRIBERESPONSE._serialized_start=324
  _TRANSCRIBERESPONSE._serialized_end=550
  _STREAMAUDIO._serialized_start=552
  _STREAMAUDIO._serialized_end=619
  _STREAMRESULT._serialized_start=621
  _STREAMRESULT._serialized_end=702
  _HEALTHREQUEST._serialized_start=704
  _HEALTHREQUEST._serialized_end=719
  _HEALTHRESPONSE._serialized_start=721
  _HEALTHRESPONSE._serialized_end=765
  _STATSREQUEST._serialized_start=767
  _STATSREQUEST._serialized_end=781
  _STATSRESPONSE._serialized_start=783
  _STATSRESPONSE._serialized_end=818
# @@protoc_insertion_point(module_scope)
