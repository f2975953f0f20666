"""gRPC front-end of the online serving mode (port of grpc_serving.py).

Same micro-batcher and fused device program as the HTTP server
(serving.py::InferenceService): this module only maps protobuf messages
onto ``InferenceService.transcribe_bytes`` and, for the streaming RPC,
a ``StreamingChunker`` feeding ``InferenceService.submit_chunks``.

The service is registered with *generic* method handlers instead of
protoc-generated service stubs, so only the ``serving_pb2`` message
classes are needed. ``GrpcClient`` below gives callers a typed client
without generated stubs either. ``grpc`` and the message stubs are
imported only when a server or client is built, so the serving modules
import on a machine without ``grpc`` or ``protobuf``.

Service: ``audio_processor_tpu.v1.AudioProcessor`` (the wire name the
reference's clients call)
  - Transcribe(TranscribeRequest) -> TranscribeResponse
  - StreamingTranscribe(stream StreamAudio) -> stream StreamResult
  - Health(HealthRequest) -> HealthResponse
  - Stats(StatsRequest) -> StatsResponse
"""

from __future__ import annotations

import json
import logging
from concurrent import futures
from typing import Optional

import numpy as np

from audio_processor_tpu_torch.pipeline.chunker import StreamingChunker
from audio_processor_tpu_torch.serving import (
    ServerOverloaded, ServiceUnavailable, strip_array_fields,
)

logger = logging.getLogger(__name__)

SERVICE = "audio_processor_tpu.v1.AudioProcessor"

_CHUNK_FIELDS = ("chunk_idx", "start_time", "end_time",
                 "transcription_chunk", "agent_transcription",
                 "client_transcription", "error")


def _load_pb2():
    from audio_processor_tpu_torch.protos import serving_pb2

    return serving_pb2


def _chunk_to_proto(pb2, row: dict):
    extras = {k: v for k, v in row.items()
              if k not in _CHUNK_FIELDS and k != "file_name"}
    return pb2.ChunkResult(
        chunk_idx=int(row.get("chunk_idx", 0)),
        start_time=float(row.get("start_time", 0.0)),
        end_time=float(row.get("end_time", 0.0)),
        transcription_chunk=str(row.get("transcription_chunk", "")),
        agent_transcription=str(row.get("agent_transcription", "")),
        client_transcription=str(row.get("client_transcription", "")),
        error=str(row.get("error", "")),
        extras_json=json.dumps(extras) if extras else "",
    )


class GrpcInferenceServer:
    """Wraps an ``InferenceService`` in a grpc.Server."""

    def __init__(self, service, port: int, max_workers: int = 8):
        import grpc

        pb2 = _load_pb2()
        self.service = service
        self.port = port

        def transcribe(request, context):
            try:
                out = service.transcribe_bytes(
                    request.audio,
                    with_sentiment=bool(request.with_sentiment),
                    timeout=(request.timeout_seconds
                             if request.timeout_seconds > 0 else None))
            except ServerOverloaded as e:
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
            except ServiceUnavailable as e:
                # transient (drain/shutdown): retrying clients retry
                context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
            except TimeoutError as e:
                context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            except Exception as e:
                # server-side fault (device batch error, ...)
                logger.exception("gRPC transcribe failed: %s", e)
                context.abort(grpc.StatusCode.INTERNAL, str(e))
            return pb2.TranscribeResponse(
                duration_seconds=out["duration_seconds"],
                num_chunks=out["num_chunks"],
                transcription=out["transcription"],
                agent_transcription=out["agent_transcription"],
                client_transcription=out["client_transcription"],
                chunks=[_chunk_to_proto(pb2, r) for r in out["chunks"]],
                latency_seconds=out["latency_seconds"],
            )

        def streaming_transcribe(request_iterator, context):
            """Live bidi streaming: accumulate PCM through a
            StreamingChunker and submit each completed chunk to the
            SHARED micro-batcher (concurrent streams and file bodies
            batch together on device). Results stream back the moment
            their chunk's device batch returns."""
            cfg = service.config
            target_sr = int(cfg.get("target_sample_rate", 16000))
            chunker = None
            stream_ch = 0
            tail = b""       # partial-frame carry between messages
            try:
                def results(chunks):
                    for chunk in chunks:
                        with service._stats_lock:
                            service.stats["stream_chunks"] += 1
                            service.stats["stream_audio_seconds"] += (
                                chunk.end_time - chunk.start_time)
                        for row in service.submit_chunks([chunk]):
                            yield pb2.StreamResult(
                                chunk=_chunk_to_proto(
                                    pb2, strip_array_fields(row)))

                for msg in request_iterator:
                    if chunker is None:
                        sr = int(msg.sample_rate)
                        ch = int(msg.channels) or 1
                        if sr != target_sr:
                            context.abort(
                                grpc.StatusCode.INVALID_ARGUMENT,
                                f"stream must be {target_sr} Hz "
                                f"(got {sr}); resample client-side")
                        if ch not in (1, 2):
                            context.abort(
                                grpc.StatusCode.INVALID_ARGUMENT,
                                f"channels must be 1 or 2 (got {ch})")
                        chunker = StreamingChunker(
                            sr, "stream",
                            float(cfg.get("chunk_duration_sec", 25.0)),
                            float(cfg.get("overlap_sec", 1.0)))
                        stream_ch = ch
                    if msg.pcm16:
                        # Carry partial frames across messages: a
                        # message boundary mid-int16 or mid-frame must
                        # not drop samples (dropping one would swap
                        # the stereo channels for the whole rest of
                        # the stream).
                        buf = tail + bytes(msg.pcm16)
                        frame_bytes = 2 * stream_ch
                        usable = len(buf) - len(buf) % frame_bytes
                        tail = buf[usable:]
                        if not usable:
                            continue
                        flat = np.frombuffer(buf[:usable], "<i2")
                        piece = (flat.reshape(-1, stream_ch).T
                                 .astype(np.float32) / 32768.0)
                        yield from results(chunker.feed(piece))
                if chunker is not None:
                    yield from results(chunker.flush())
                yield pb2.StreamResult(final=True)
            except ServerOverloaded as e:
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                              str(e))
            except ServiceUnavailable as e:
                context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
            except TimeoutError as e:
                context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                              str(e))
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            except Exception as e:
                if type(e) is Exception:
                    # context.abort() signals by raising a BARE
                    # Exception — the in-body validation aborts
                    # (rate/channels) must propagate, not be
                    # re-aborted as INTERNAL
                    raise
                logger.exception("gRPC stream failed: %s", e)
                context.abort(grpc.StatusCode.INTERNAL, str(e))

        def health(request, context):
            return pb2.HealthResponse(ok=True, status="serving")

        def stats(request, context):
            return pb2.StatsResponse(
                stats_json=json.dumps(service.snapshot_stats()))

        handlers = {
            "Transcribe": grpc.unary_unary_rpc_method_handler(
                transcribe,
                request_deserializer=pb2.TranscribeRequest.FromString,
                response_serializer=(
                    pb2.TranscribeResponse.SerializeToString)),
            "Health": grpc.unary_unary_rpc_method_handler(
                health,
                request_deserializer=pb2.HealthRequest.FromString,
                response_serializer=pb2.HealthResponse.SerializeToString),
            "Stats": grpc.unary_unary_rpc_method_handler(
                stats,
                request_deserializer=pb2.StatsRequest.FromString,
                response_serializer=pb2.StatsResponse.SerializeToString),
            "StreamingTranscribe": grpc.stream_stream_rpc_method_handler(
                streaming_transcribe,
                request_deserializer=pb2.StreamAudio.FromString,
                response_serializer=pb2.StreamResult.SerializeToString),
        }
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, handlers),))
        self.bound_port = self._server.add_insecure_port(
            f"[::]:{port}")
        if self.bound_port == 0:
            # add_insecure_port reports bind failure by returning 0;
            # fail loudly like the HTTP ThreadingHTTPServer does on a
            # busy port instead of starting a server nobody can reach.
            raise RuntimeError(
                f"gRPC server could not bind port {port}")

    def start(self):
        self._server.start()
        logger.info("gRPC serving on port %d (service %s)",
                    self.bound_port, SERVICE)

    def stop(self, grace: Optional[float] = 2.0):
        self._server.stop(grace)

    def wait(self):
        self._server.wait_for_termination()


class GrpcClient:
    """Minimal typed client (no generated service stubs needed)."""

    def __init__(self, target: str):
        import grpc

        pb2 = _load_pb2()
        self._pb2 = pb2
        self._channel = grpc.insecure_channel(target)
        self._transcribe = self._channel.unary_unary(
            f"/{SERVICE}/Transcribe",
            request_serializer=pb2.TranscribeRequest.SerializeToString,
            response_deserializer=pb2.TranscribeResponse.FromString)
        self._health = self._channel.unary_unary(
            f"/{SERVICE}/Health",
            request_serializer=pb2.HealthRequest.SerializeToString,
            response_deserializer=pb2.HealthResponse.FromString)
        self._stats = self._channel.unary_unary(
            f"/{SERVICE}/Stats",
            request_serializer=pb2.StatsRequest.SerializeToString,
            response_deserializer=pb2.StatsResponse.FromString)
        self._streaming = self._channel.stream_stream(
            f"/{SERVICE}/StreamingTranscribe",
            request_serializer=pb2.StreamAudio.SerializeToString,
            response_deserializer=pb2.StreamResult.FromString)

    def transcribe(self, audio: bytes, with_sentiment: bool = False,
                   timeout: Optional[float] = None):
        return self._transcribe(
            self._pb2.TranscribeRequest(
                audio=audio, with_sentiment=with_sentiment,
                timeout_seconds=timeout or 0.0),
            timeout=timeout)

    def streaming_transcribe(self, pieces, sample_rate: int = 16000,
                             channels: int = 2,
                             timeout: Optional[float] = None):
        """Stream live PCM; yields each chunk's result as it lands.

        ``pieces`` iterates int16 numpy arrays (interleaved [n*ch] or
        [ch, n]) or raw little-endian int16 bytes. The terminal
        ``final`` marker is consumed, not yielded."""
        pb2 = self._pb2

        def requests():
            first = True
            for p in pieces:
                if isinstance(p, (bytes, bytearray)):
                    payload = bytes(p)
                else:
                    arr = np.asarray(p, "<i2")
                    if arr.ndim == 2:       # [ch, n] -> interleaved
                        arr = arr.T.reshape(-1)
                    payload = arr.tobytes()
                yield pb2.StreamAudio(
                    pcm16=payload,
                    sample_rate=sample_rate if first else 0,
                    channels=channels if first else 0)
                first = False
            if first:                       # empty stream: handshake
                yield pb2.StreamAudio(sample_rate=sample_rate,
                                      channels=channels)

        for res in self._streaming(requests(), timeout=timeout):
            if res.final:
                break
            yield res.chunk

    def health(self, timeout: Optional[float] = 10.0):
        return self._health(self._pb2.HealthRequest(), timeout=timeout)

    def stats(self, timeout: Optional[float] = 10.0):
        return json.loads(
            self._stats(self._pb2.StatsRequest(),
                        timeout=timeout).stats_json)

    def close(self):
        self._channel.close()
