"""Message stubs of the gRPC serving surface (port of protos/).

``serving.proto`` and ``serving_pb2.py`` are the reference's, byte for
byte: the proto package ``audio_processor_tpu.v1`` is the wire name
existing clients call, and protobuf's one descriptor pool per process
loads an identical file once, so this module and the reference's share
their message classes when both are imported."""
