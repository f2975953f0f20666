#!/usr/bin/env python3
"""Serving load test of the PyTorch/CUDA port on one CUDA card.

    python3 tools/load_test_serving_torch.py [--clients 8] [--seconds 60]
        [--audio-sec 20] [--seed 0]

Starts the port's HTTP server (``serving.serve``) over the full-width
w2v-bert-2.0 engine (seeded random weights, bf16, chunk_batch_size 16,
every length bucket warmed before the first request) and drives it with
N concurrent clients, each posting a stereo PCM16 WAV of ``audio-sec``
seconds back to back for D seconds. Then the failure modes:

- a backpressure trip: the queue cap set to 2 chunks and a burst of 6
  requests, at least one of which must get 503 with Retry-After;
- a gRPC arm, only where ``grpc`` imports: unary requests, the
  RESOURCE_EXHAUSTED burst, and 2 concurrent live streams whose chunks
  must equal the unary path's;
- the drain: ``close()`` with requests in flight, which must finish
  with 200, after which a new request must get 503.

Prints the card's name and power limit, sustained serving RTFx (audio
seconds answered / wall seconds of the load), p50/p95 request latency
from /v1/stats, requests per device batch, and device memory. Exits
non-zero without CUDA or when a check fails. chip_smoke.py phase 9
drives the same server with this module's request helpers.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
SR = 16000


def call_pcm(seconds: float, seed: int, sr: int = SR) -> np.ndarray:
    """A synthetic stereo call, int16 [2, n]: tone bursts alternating
    between the speakers over noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = 0.02 * rng.standard_normal((2, t.size))
    on = (np.floor(t / 1.5) % 2).astype(bool)
    x[0] += 0.3 * on * np.sin(2 * np.pi * rng.uniform(120, 300) * t)
    x[1] += 0.3 * ~on * np.sin(2 * np.pi * rng.uniform(150, 350) * t)
    return np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)


def wav_bytes(pcm: np.ndarray, sr: int = SR) -> bytes:
    """The PCM16 WAV file of an int16 [channels, n] array."""
    data = np.ascontiguousarray(pcm.T).astype("<i2").tobytes()
    ch = pcm.shape[0]
    return (b"RIFF" + (36 + len(data)).to_bytes(4, "little") + b"WAVE"
            + b"fmt " + (16).to_bytes(4, "little")
            + np.array([1, ch], "<u2").tobytes()
            + np.array([sr, 2 * ch * sr], "<u4").tobytes()
            + np.array([2 * ch, 16], "<u2").tobytes()
            + b"data" + len(data).to_bytes(4, "little") + data)


def multipart(fields: dict) -> tuple:
    """{name: (filename or None, bytes)} -> (body, headers) of a
    multipart/form-data request (the OpenAI-compatible route's)."""
    boundary = "loadtestboundary5183"
    parts = []
    for name, (fname, data) in fields.items():
        disp = f'form-data; name="{name}"'
        if fname:
            disp += f'; filename="{fname}"'
        parts.append(f"--{boundary}\r\nContent-Disposition: {disp}\r\n"
                     "Content-Type: application/octet-stream\r\n\r\n"
                     .encode() + data + b"\r\n")
    return (b"".join(parts) + f"--{boundary}--\r\n".encode(),
            {"Content-Type": f"multipart/form-data; boundary={boundary}"})


def request(port: int, path: str, body: bytes = None, headers=None,
            timeout: float = 600.0) -> tuple:
    """(status, headers, raw body) of one HTTP request; error statuses
    are returned, not raised."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def get_json(port: int, path: str):
    status, _, raw = request(port, path, timeout=30)
    assert status == 200, (path, status)
    return json.loads(raw)


def burst(port: int, bodies: list) -> list:
    """POST every body at once; (status, Retry-After header) of each."""
    out = [None] * len(bodies)

    def one(k):
        status, headers, _ = request(port, "/v1/transcribe", bodies[k])
        out[k] = (status, headers.get("Retry-After"))

    threads = [threading.Thread(target=one, args=(k,))
               for k in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads), "a burst request hung"
    return out


def check_burst(results: list) -> tuple:
    """Every response is a 200 or a 503 with Retry-After, and at least
    one is a 503. Returns (n_503, n_200)."""
    n503 = sum(s == 503 for s, _ in results)
    n200 = sum(s == 200 for s, _ in results)
    assert n503 >= 1, f"backpressure never tripped: {results}"
    assert n503 + n200 == len(results), results
    assert all(ra == "5" for s, ra in results if s == 503), results
    return n503, n200


def drain(server, port: int, bodies: list, n_chunks: int,
          new_body: bytes) -> dict:
    """``close()`` with requests in flight: POST ``bodies`` (``n_chunks``
    chunks in all) at once, holding the device worker at the engine's
    entry until every body is queued or running, then close the service
    and release the worker. Each body must finish with 200; a request
    that arrives while the service closes must get 503."""
    svc = server.service
    engine = svc.engine
    release = threading.Event()
    real = engine.transcribe_chunks

    def held(chunks):
        release.wait(120)
        return real(chunks)

    engine.transcribe_chunks = held
    statuses = [None] * len(bodies)

    def one(k):
        statuses[k] = request(port, "/v1/transcribe", bodies[k])[0]

    threads = [threading.Thread(target=one, args=(k,))
               for k in range(len(bodies))]
    closer = threading.Thread(target=svc.close, kwargs={"drain_timeout": 120})
    try:
        for t in threads:
            t.start()
        deadline = time.time() + 60
        while svc.snapshot_stats()["pending_chunks"] < n_chunks:
            assert time.time() < deadline, "the bodies were not admitted"
            time.sleep(0.005)
        pending = svc.snapshot_stats()["pending_chunks"]
        t0 = time.perf_counter()
        closer.start()
        assert svc._closing.wait(60)
        during_status, _, raw = request(port, "/v1/transcribe", new_body)
    finally:
        release.set()
    for t in threads + [closer]:
        t.join(timeout=300)
    close_s = time.perf_counter() - t0
    del engine.transcribe_chunks           # the class's method again
    out = {"in_flight": statuses, "pending_at_close": pending,
           "close_s": close_s, "during_close": during_status,
           "during_close_error": json.loads(raw).get("error")}
    assert all(s == 200 for s in statuses), out
    assert during_status == 503 and not svc._worker.is_alive(), out
    return out


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip() \
        .splitlines()[0]


def grpc_arm(service, payloads: list, audio_sec: float) -> None:
    import grpc

    from audio_processor_tpu_torch.grpc_serving import (
        GrpcClient, GrpcInferenceServer,
    )

    gsrv = GrpcInferenceServer(service, 0)
    gsrv.start()
    client = GrpcClient(f"127.0.0.1:{gsrv.bound_port}")
    try:
        t0 = time.perf_counter()
        audio = sum(client.transcribe(payloads[k % len(payloads)]
                                      ).duration_seconds for k in range(4))
        wall = time.perf_counter() - t0
        print(f"gRPC unary: 4 requests, {audio:.0f} audio-s in {wall:.2f} s "
              f"-> RTFx {audio / wall:.1f}", flush=True)

        service.max_pending_chunks = 2
        codes = []

        def one():
            try:
                client.transcribe(payloads[0])
                codes.append("OK")
            except grpc.RpcError as e:
                codes.append(e.code().name)

        threads = [threading.Thread(target=one) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        service.max_pending_chunks = 32 * service.max_chunks
        n_ex = codes.count("RESOURCE_EXHAUSTED")
        print(f"gRPC burst of 6 x {audio_sec:.0f} s against a 2-chunk cap: "
              f"{n_ex} x RESOURCE_EXHAUSTED, {codes.count('OK')} x OK",
              flush=True)
        assert n_ex >= 1 and n_ex + codes.count("OK") == 6, codes

        pcm = call_pcm(60.0, 7)
        pieces = [pcm[:, i:i + SR] for i in range(0, pcm.shape[1], SR)]
        unary = client.transcribe(wav_bytes(pcm))
        got = {}

        def stream(k):
            got[k] = list(client.streaming_transcribe(pieces, channels=2,
                                                      timeout=600.0))

        threads = [threading.Thread(target=stream, args=(k,))
                   for k in range(2)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        want = [(c.start_time, c.end_time) for c in unary.chunks]
        for rows in got.values():
            assert [(c.start_time, c.end_time) for c in rows] == want
        same = sum(a.transcription_chunk == b.transcription_chunk
                   for rows in got.values()
                   for a, b in zip(rows, unary.chunks))
        print(f"gRPC streaming: 2 concurrent 60 s streams in 1 s pieces, "
              f"{len(want)} chunks each, boundaries equal to unary; "
              f"{same}/{2 * len(want)} mixed transcripts equal to unary "
              f"(bf16 batches of other shapes may flip near-ties); wall "
              f"{wall:.2f} s", flush=True)
    finally:
        client.close()
        gsrv.stop()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--audio-sec", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))

    import torch

    if not torch.cuda.is_available():
        sys.exit("load_test_serving_torch: torch.cuda.is_available() is "
                 "False; this tool runs only on a CUDA device")
    from audio_processor_tpu_torch.config import PipelineConfig
    from audio_processor_tpu_torch.pipeline.chunker import chunk_boundaries
    from audio_processor_tpu_torch.serving import serve
    from audio_processor_tpu_torch.utils.system import (
        check_device_availability, get_device_memory_usage,
    )

    print(smi_line(), flush=True)
    print(check_device_availability()[1], flush=True)
    cfg = PipelineConfig.from_dict({
        "chunk_batch_size": 16, "enable_mixed_precision": True,
        "serve_warmup": "all"})
    t0 = time.perf_counter()
    server = serve(cfg, host="127.0.0.1", port=0)
    svc = server.service
    print(f"server up in {time.perf_counter() - t0:.2f} s (engine build and "
          f"warmup of every bucket: {svc.warmup_seconds:.2f} s)", flush=True)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    try:
        payloads = [wav_bytes(call_pcm(args.audio_sec, args.seed + i))
                    for i in range(args.clients)]
        stop = threading.Event()
        counters = {"ok": 0, "err": 0, "s503": 0, "audio": 0.0}
        lock = threading.Lock()

        def client(i: int):
            while not stop.is_set():
                status, _, raw = request(port, "/v1/transcribe",
                                         payloads[i])
                with lock:
                    if status == 200:
                        counters["ok"] += 1
                        counters["audio"] += json.loads(raw)[
                            "duration_seconds"]
                    elif status == 503:
                        counters["s503"] += 1
                    else:
                        counters["err"] += 1

        print(f"load: {args.clients} clients x {args.seconds:.0f} s, "
              f"{args.audio_sec:.0f} s stereo per request", flush=True)
        before = get_json(port, "/v1/stats")
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(args.clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(args.seconds)
        stop.set()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        stats = get_json(port, "/v1/stats")
        batches = stats["batches"] - before["batches"]
        print(f"sustained: {counters['ok']} requests ok, "
              f"{counters['audio']:.0f} audio-s in {wall:.2f} s wall -> "
              f"serving RTFx {counters['audio'] / wall:.1f}; errors "
              f"{counters['err']}, 503s {counters['s503']}", flush=True)
        n_req = stats["requests"] - before["requests"]
        print(f"server latency p50 {stats['p50_latency_seconds']} s, p95 "
              f"{stats['p95_latency_seconds']} s; {batches} device batches "
              f"for {n_req} requests ({n_req / max(batches, 1):.2f} per "
              f"batch), {stats['chunks'] - before['chunks']} chunks; "
              f"device memory {get_device_memory_usage():.1f}%", flush=True)
        assert counters["err"] == 0 and counters["ok"] > 0, counters
        assert stats["batch_errors"] == 0, stats

        svc.max_pending_chunks = 2
        n503, n200 = check_burst(burst(port, [payloads[0]] * 6))
        svc.max_pending_chunks = 32 * svc.max_chunks
        print(f"backpressure: burst of 6 x {args.audio_sec:.0f} s against a "
              f"2-chunk cap: {n503} x 503 (Retry-After 5), {n200} x 200",
              flush=True)

        try:
            import grpc  # noqa: F401
            import google.protobuf  # noqa: F401
        except ImportError:
            print("gRPC arm skipped: grpc or protobuf does not import here",
                  flush=True)
        else:
            grpc_arm(svc, payloads, args.audio_sec)

        n = len(payloads[:3]) * len(chunk_boundaries(
            int(args.audio_sec * SR), 25 * SR, 24 * SR))
        out = drain(server, port, payloads[:3], n, payloads[0])
        print(f"drain: close() with {out['pending_at_close']} chunks in "
              f"flight took {out['close_s']:.2f} s; their statuses "
              f"{out['in_flight']}; a request during the close: "
              f"{out['during_close']} ({out['during_close_error']})",
              flush=True)
    finally:
        server.shutdown()
        svc.close(drain_timeout=5)
        server.server_close()
    print(smi_line(), flush=True)
    print("load test complete", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
