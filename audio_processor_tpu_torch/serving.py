"""Online serving mode: HTTP inference with request micro-batching
(port of serving.py).

An HTTP server whose requests a micro-batcher merges into the same
fused device program the batch pipeline runs
(``pipeline/asr_engine.ASREngine``: fbank, the encoder with the
flash-rel CUDA kernel, greedy CTC and the acoustic features), so online
and batch traffic share one engine and the card sees dense, bucketed
batches.

Design (the reference's):
- stdlib only (ThreadingHTTPServer), no framework dependency.
- POST /v1/transcribe with an audio file body (WAV, OGG, FLAC, ...):
  decode -> resample -> 25 s/1 s chunking -> fused ASR (+ acoustic
  features) -> optional sentiment -> JSON per chunk + joined
  transcripts. POST /v1/audio/transcriptions is the OpenAI-compatible
  multipart route.
- Requests queue into a micro-batch; the single device worker drains
  the queue every ``serve_batch_window_ms`` (or at once when a full
  device batch is waiting). One thread runs the engine, many HTTP
  threads decode, so no two threads race on the model.
- ``serve_max_pending_chunks`` caps the decoded chunks waiting (503 +
  Retry-After beyond it); ``close()`` drains.
- GET /healthz liveness; GET /v1/stats and /metrics serving counters.

``InferenceService`` and ``serve`` build their engine on ``device``
(default ``cuda``; the engine refuses CUDA when it is absent) unless an
engine is passed in, which keeps its own device.
"""

from __future__ import annotations

import json
import logging
import math
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlsplit

from audio_processor_tpu_torch.io.decode import load_audio_bytes
from audio_processor_tpu_torch.io.wav import WavError
from audio_processor_tpu_torch.models import seamless_s2t as s2t
from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine
from audio_processor_tpu_torch.pipeline.chunker import prepare_and_split

logger = logging.getLogger(__name__)


def strip_array_fields(row: Dict[str, Any]) -> Dict[str, Any]:
    """Drop waveform/feature/probability arrays from a result row —
    the wire-facing shape shared by the HTTP and gRPC front-ends."""
    return {k: v for k, v in row.items()
            if not k.endswith("_waveform")
            and not k.endswith("_features")
            and not k.endswith("_probabilities")}


class ServerOverloaded(RuntimeError):
    """Request rejected by queue backpressure (map to HTTP 503 /
    gRPC RESOURCE_EXHAUSTED)."""


class ServiceUnavailable(RuntimeError):
    """Server draining/shutting down — transient from the client's
    view (map to HTTP 503 / gRPC UNAVAILABLE so retrying clients
    retry, unlike a 400/INVALID_ARGUMENT)."""


class _Request:
    __slots__ = ("chunks", "event", "results", "error", "received")

    def __init__(self, chunks):
        self.chunks = chunks
        self.event = threading.Event()
        self.results: Optional[List[Dict[str, Any]]] = None
        self.error: Optional[str] = None
        self.received = time.perf_counter()


class InferenceService:
    """Micro-batching front of the fused ASR engine (+ sentiment)."""

    def __init__(self, config, asr_engine=None, sentiment_analyzer=None,
                 device="cuda"):
        self.config = config
        s2t.check_pipeline_config(config, serve=True)
        self.engine = (asr_engine if asr_engine is not None
                       else ASREngine(config, device))
        if getattr(self.engine, "s2t", False):
            raise ValueError(f"asr_model_type {s2t.MODEL_TYPE!r} does not "
                             "serve (no mono-rows program)")
        self.sentiment = sentiment_analyzer
        self.batch_window_ms = float(config.get("serve_batch_window_ms",
                                                20.0))
        self.max_chunks = int(config.get("chunk_batch_size", 16))
        # A request waits at most this long for its rows. Generous: a
        # shape the warmup below did not run pays its first-use costs
        # (cuBLAS heuristics, allocator growth) inside a live request.
        self.request_timeout = float(config.get("serve_timeout_s", 600.0))
        # Backpressure: cap decoded-but-unprocessed chunks held in the
        # queue (each 25 s stereo chunk is ~3 MB of host memory); a
        # flood of requests gets a clean 503/RESOURCE_EXHAUSTED
        # instead of unbounded growth.
        self.max_pending_chunks = int(config.get(
            "serve_max_pending_chunks", 32 * self.max_chunks))
        self._pending_chunks = 0
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._closing = threading.Event()
        self._idle = threading.Event()   # worker not processing a batch
        self._idle.set()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="serve-batcher")
        self.stats = {"requests": 0, "chunks": 0, "batches": 0,
                      "batch_errors": 0, "request_errors": 0,
                      "rejected_overload": 0, "audio_seconds": 0.0,
                      "stream_chunks": 0, "stream_audio_seconds": 0.0}
        self._latencies: List[float] = []   # last 1000 request latencies
        self._stats_lock = threading.Lock()
        self.warmup_seconds = 0.0
        warmup = config.get("serve_warmup", True)
        if warmup:
            self._warmup(all_buckets=(warmup == "all"))
        self._worker.start()

    def _warmup(self, all_buckets: bool = False):
        """Run the full-batch program for the top bucket (the shape
        every full-length chunk hits) before accepting traffic, on this
        thread: the first launch builds the CUDA kernels, and each new
        shape pays cuBLAS's heuristics and the allocator's growth, none
        of which should fall inside a live request's deadline.
        ``serve_warmup: all`` runs every length bucket."""
        # Tail shapes too: a 1-chunk request dispatches at the
        # smallest tail batch, which is its own shape.
        sizes = sorted({self.max_chunks, self.engine._tail_size(1)} |
                       ({self.engine._tail_size(self.max_chunks // 2)}
                        if self.max_chunks > 1 else set()))
        t0 = time.perf_counter()
        n_shapes = self.engine.warmup(all_buckets=all_buckets,
                                      tail_sizes=sizes)
        self.warmup_seconds = time.perf_counter() - t0
        logger.info("serving warmup ran %d shape(s) in %.1fs",
                    n_shapes, self.warmup_seconds)

    # -------------------------------------------------------- intake
    def submit_chunks(self, chunks, timeout: Optional[float] = None):
        """Queue chunks into the shared micro-batcher and wait for
        their rows. The common submission path for whole-file bodies
        (transcribe_bytes) and the gRPC streaming RPC, so concurrent
        streams micro-batch together with file requests. Raises
        ServerOverloaded on backpressure, TimeoutError past the
        deadline."""
        if self._closing.is_set():
            raise ServiceUnavailable("server is shutting down")
        req = _Request(chunks)
        with self._stats_lock:
            if self._pending_chunks + len(chunks) > self.max_pending_chunks:
                self.stats["rejected_overload"] += 1
                raise ServerOverloaded(
                    f"queue full ({self._pending_chunks} pending chunks, "
                    f"limit {self.max_pending_chunks}); retry later")
            self._pending_chunks += len(chunks)
        self._queue.put(req)
        if not req.event.wait(timeout if timeout is not None
                              else self.request_timeout):
            raise TimeoutError("inference timed out")
        if req.error is not None:
            if req.error == "server is shutting down":
                raise ServiceUnavailable(req.error)
            raise RuntimeError(req.error)   # device batch failure
        return req.results

    def transcribe_bytes(self, payload: bytes,
                         with_sentiment: bool = False,
                         timeout: Optional[float] = None) -> Dict[str, Any]:
        """Decode an uploaded audio payload and run it through the
        batched device path. Blocking; thread-safe."""
        t0 = time.perf_counter()
        waveform, sr = load_audio_bytes(payload)
        # Same resample/max_audio_length/split sequence as the batch
        # engine — the length cap also keeps a single legal-size body
        # under max_pending_chunks, so an idle server can never 503 a
        # request forever.
        waveform, sr, chunks = prepare_and_split(
            waveform, sr, "request.wav", self.config)
        if not chunks:
            raise ValueError("no audio decoded from request body")

        rows = self.submit_chunks(chunks, timeout)
        if with_sentiment and self.sentiment is not None:
            rows = self.sentiment.analyze_batch_sentiment(
                [dict(r) for r in rows])
        duration = waveform.shape[-1] / sr
        latency = time.perf_counter() - t0
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["chunks"] += len(rows)
            self.stats["audio_seconds"] += duration
            self._latencies.append(latency)
            if len(self._latencies) > 1000:
                del self._latencies[:-1000]

        return {
            "duration_seconds": duration,
            "num_chunks": len(rows),
            "transcription": " ".join(
                r.get("transcription_chunk", "") for r in rows).strip(),
            "agent_transcription": " ".join(
                r.get("agent_transcription", "") for r in rows).strip(),
            "client_transcription": " ".join(
                r.get("client_transcription", "") for r in rows).strip(),
            "chunks": [strip_array_fields(r) for r in rows],
            "latency_seconds": time.perf_counter() - t0,
        }

    # -------------------------------------------------- batch worker
    def _run(self):
        window = self.batch_window_ms / 1000.0
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            self._idle.clear()
            group = [first]
            n_chunks = len(first.chunks)
            deadline = time.perf_counter() + window
            while n_chunks < self.max_chunks:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                group.append(nxt)
                n_chunks += len(nxt.chunks)
            try:
                self._process(group)
            finally:
                self._idle.set()

    def _process(self, group: List[_Request]):
        all_chunks = [c for r in group for c in r.chunks]
        try:
            # transcribe_chunks fetches the rows to the host, so an
            # asynchronous CUDA fault surfaces inside this call: as the
            # failed sub-batch's rows with ``error`` set (the engine's
            # contract, as the reference's), or raised into this catch.
            results = self.engine.transcribe_chunks(all_chunks)
        except Exception as e:  # pragma: no cover
            logger.exception("serving batch failed")
            with self._stats_lock:
                self.stats["batch_errors"] += 1
                self._pending_chunks -= len(all_chunks)
            for r in group:
                r.error = str(e)
                r.event.set()
            return
        with self._stats_lock:
            self.stats["batches"] += 1
            self._pending_chunks -= len(all_chunks)
        pos = 0
        for r in group:
            r.results = results[pos:pos + len(r.chunks)]
            pos += len(r.chunks)
            r.event.set()

    def snapshot_stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            out = dict(self.stats)
            lats = sorted(self._latencies)
            pending = self._pending_chunks
        if lats:                       # nearest-rank percentiles
            out["p50_latency_seconds"] = round(
                lats[max(0, math.ceil(0.50 * len(lats)) - 1)], 3)
            out["p95_latency_seconds"] = round(
                lats[max(0, math.ceil(0.95 * len(lats)) - 1)], 3)
        else:                          # keep the schema stable pre-traffic
            out["p50_latency_seconds"] = None
            out["p95_latency_seconds"] = None
        out["pending_chunks"] = pending
        return out

    def prometheus_metrics(self) -> str:
        """Stats in Prometheus text exposition format (GET /metrics)."""
        s = self.snapshot_stats()
        lines = []
        for key, mtype in (("requests", "counter"), ("chunks", "counter"),
                           ("batches", "counter"),
                           ("batch_errors", "counter"),
                           ("request_errors", "counter"),
                           ("rejected_overload", "counter"),
                           ("audio_seconds", "counter"),
                           ("stream_chunks", "counter"),
                           ("stream_audio_seconds", "counter"),
                           ("pending_chunks", "gauge"),
                           ("p50_latency_seconds", "gauge"),
                           ("p95_latency_seconds", "gauge")):
            val = s.get(key)
            if val is None:
                continue
            name = f"audio_processor_{key}"
            lines.append(f"# TYPE {name} {mtype}")
            lines.append(f"{name} {val}")
        return "\n".join(lines) + "\n"

    def close(self, drain_timeout: float = 30.0):
        """Stop accepting new requests, let queued AND in-flight work
        finish (bounded by drain_timeout), then stop the worker."""
        self._closing.set()
        deadline = time.time() + drain_timeout
        while time.time() < deadline:
            if self._queue.empty() and self._idle.is_set():
                break
            time.sleep(0.05)
        self._stop.set()
        self._worker.join(timeout=5)
        # Fail anything still queued after an incomplete drain —
        # otherwise their submitters block for the full
        # request_timeout on events nobody will ever set.
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            with self._stats_lock:
                self._pending_chunks -= len(req.chunks)
            req.error = "server is shutting down"
            req.event.set()


def parse_multipart_form(content_type: str, body: bytes
                         ) -> Dict[str, tuple]:
    """multipart/form-data -> {field name: (filename or None, bytes)}.

    Stdlib-only (email.parser; cgi.FieldStorage is deprecated) for the
    OpenAI-compatible /v1/audio/transcriptions route. Raises
    ValueError on anything that isn't well-formed multipart."""
    from email.parser import BytesParser
    from email.policy import HTTP

    if "multipart/form-data" not in content_type:
        raise ValueError("expected multipart/form-data "
                         "(OpenAI-compatible transcription route)")
    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + content_type.encode("latin-1")
        + b"\r\nMIME-Version: 1.0\r\n\r\n" + body)
    if not msg.is_multipart():
        raise ValueError("malformed multipart body")
    fields: Dict[str, tuple] = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        fields[name] = (
            part.get_filename(),
            part.get_payload(decode=True) or b"")
    return fields


def make_handler(service: InferenceService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route to logging, not stderr
            logger.debug("serve: " + fmt, *args)

        def _send(self, code: int, obj: Dict[str, Any]):
            body = json.dumps(obj, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_openai(self, out: Dict[str, Any], fmt: str):
            """OpenAI audio-transcriptions response shapes
            (json / text / verbose_json) built from the native
            transcribe_bytes output."""
            if fmt == "text":
                body = (out["transcription"] + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if fmt == "verbose_json":
                segments = [{
                    "id": i,
                    "start": c.get("start_time", 0.0),
                    "end": c.get("end_time", 0.0),
                    "text": c.get("transcription_chunk", ""),
                } for i, c in enumerate(out.get("chunks", []))]
                self._send(200, {
                    "task": "transcribe",
                    "language": "ar",   # Darija call-center model
                    "duration": out["duration_seconds"],
                    "text": out["transcription"],
                    "segments": segments,
                })
                return
            self._send(200, {"text": out["transcription"]})

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            elif self.path == "/v1/stats":
                # snapshot under the lock, send outside it — a slow-
                # reading client must not block the batch worker
                self._send(200, service.snapshot_stats())
            elif self.path == "/metrics":
                body = service.prometheus_metrics().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            openai_route = self.path.split("?", 1)[0] \
                == "/v1/audio/transcriptions"
            if not (self.path.startswith("/v1/transcribe")
                    or openai_route):
                self._send(404, {"error": "not found"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0 or length > 512 * 1024 * 1024:
                self._send(400, {"error": "bad content length"})
                return
            payload = self.rfile.read(length)
            qs = parse_qs(urlsplit(self.path).query)
            with_sentiment = qs.get("sentiment", [""])[0] == "1"
            response_format = "json"
            try:
                if openai_route:
                    fields = parse_multipart_form(
                        self.headers.get("Content-Type", ""), payload)
                    if "file" not in fields:
                        raise ValueError(
                            "multipart body must contain a 'file' part")
                    payload = fields["file"][1]
                    response_format = (fields.get("response_format",
                                                  (None, b"json"))[1]
                                       .decode("utf-8", "replace"))
                    if response_format not in ("json", "text",
                                               "verbose_json"):
                        raise ValueError("response_format must be "
                                         "json, text or verbose_json")
                out = service.transcribe_bytes(
                    payload, with_sentiment=with_sentiment)
                if openai_route:
                    self._send_openai(out, response_format)
                else:
                    self._send(200, out)
            except ServerOverloaded as e:
                self.send_response(503)
                body = json.dumps({"error": str(e)}).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Retry-After", "5")
                self.end_headers()
                self.wfile.write(body)
            except ServiceUnavailable as e:
                self._send(503, {"error": str(e)})
            except TimeoutError as e:
                with service._stats_lock:
                    service.stats["request_errors"] += 1
                self._send(504, {"error": str(e)})
            except (ValueError, WavError) as e:
                # genuinely the client's fault (bad/undecodable body)
                with service._stats_lock:
                    service.stats["request_errors"] += 1
                self._send(400, {"error": str(e)})
            except Exception as e:
                # server-side fault (device batch error, ...): 5xx so
                # retrying clients retry instead of giving up
                with service._stats_lock:
                    service.stats["request_errors"] += 1
                self._send(500, {"error": str(e)})

    return Handler


def serve(config, host: str = "0.0.0.0", port: int = 8080,
          asr_engine=None, sentiment_analyzer=None, device="cuda"
          ) -> ThreadingHTTPServer:
    """Start the HTTP server (returns it; call .serve_forever() or use
    the returned handle in tests). Without ``asr_engine`` the service
    builds one on ``device``."""
    service = InferenceService(config, asr_engine=asr_engine,
                               sentiment_analyzer=sentiment_analyzer,
                               device=device)
    server = ThreadingHTTPServer((host, port), make_handler(service))
    server.service = service  # type: ignore[attr-defined]
    logger.info("serving on %s:%d (batch window %.0f ms, max %d chunks)",
                host, server.server_address[1], service.batch_window_ms,
                service.max_chunks)
    return server
