"""The port's HTTP serving mode (serving.py) against the JAX package's.

One set of tiny fp32 weights (``tiny_pair``: the JAX ``tiny_engine``
converted with ``params_from_jax``) serves in a JAX server and in a port
server on the CPU; the same numpy-made bodies go to both. The GET
routes' schemas, the /v1/transcribe JSON (WAV, OGG, FLAC bodies; latency
fields excepted), the OpenAI-compatible route in every format and its
errors, and the 400 on a bad body must be the JAX server's. Also:
concurrent requests micro-batch with no rows crossing between them,
503 + Retry-After backpressure, the drain on ``close()``, and an
``InferenceService`` that builds its own engine on ``cuda`` by default,
which raises here instead of running on the CPU."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from audio_processor_tpu import config as jconfig
from audio_processor_tpu import serving as jserving
from audio_processor_tpu.pipeline.sentiment import (
    SentimentAnalyzer as JaxSentiment,
)
from audio_processor_tpu_torch import serving
from audio_processor_tpu_torch.config import PipelineConfig
from audio_processor_tpu_torch.pipeline.chunker import chunk_boundaries
from audio_processor_tpu_torch.pipeline.sentiment import SentimentAnalyzer

from tests.conftest import make_stereo_call
from tests.test_torch_message_path import SETTINGS, tiny_pair

SERVE = {**SETTINGS, "serve_batch_window_ms": 30.0}


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(srv):
    srv.shutdown()
    srv.service.close(drain_timeout=5)
    srv.server_close()


@pytest.fixture(scope="module")
def pair():
    """(JAX server, port server) on one set of tiny weights, each with
    its package's sentiment coordinator (no models configured)."""
    jeng, teng = tiny_pair()
    jcfg = jconfig.PipelineConfig.from_dict(SERVE)
    tcfg = PipelineConfig.from_dict(SERVE)
    jsrv = _start(jserving.serve(jcfg, host="127.0.0.1", port=0,
                                 asr_engine=jeng,
                                 sentiment_analyzer=JaxSentiment(jcfg)))
    tsrv = _start(serving.serve(tcfg, host="127.0.0.1", port=0,
                                asr_engine=teng,
                                sentiment_analyzer=SentimentAnalyzer(
                                    tcfg, device="cpu")))
    yield jsrv, tsrv
    _stop(jsrv)
    _stop(tsrv)


def pcm16_wav(pcm: np.ndarray, sr: int = 16000) -> bytes:
    """The PCM16 WAV bytes of an int16 [channels, n] array."""
    data = np.ascontiguousarray(pcm.T).astype("<i2").tobytes()
    ch = pcm.shape[0]
    return (b"RIFF" + (36 + len(data)).to_bytes(4, "little") + b"WAVE"
            + b"fmt " + (16).to_bytes(4, "little")
            + np.array([1, ch], "<u2").tobytes()
            + np.array([sr, 2 * ch * sr], "<u4").tobytes()
            + np.array([2 * ch, 16], "<u2").tobytes()
            + b"data" + len(data).to_bytes(4, "little") + data)


def wav_body(dur=6.0, seed=0, sr=16000) -> bytes:
    """A stereo PCM16 WAV of the synthetic call plus seeded noise (so
    bodies of different seeds transcribe differently)."""
    x = make_stereo_call(sr=sr, dur=dur) + 0.05 * np.random.default_rng(
        seed).standard_normal((2, int(sr * dur))).astype(np.float32)
    return pcm16_wav(np.clip(np.round(x * 32767), -32768, 32767)
                     .astype(np.int16), sr)


def _request(port, path, body=None, headers=None):
    """(status, headers, raw body) of one request; errors too."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _transcribe(port, body, query=""):
    st, _, raw = _request(port, "/v1/transcribe" + query, body)
    return st, json.loads(raw)


def _both(pair, fn):
    return [fn(srv.server_address[1]) for srv in pair]


def _without_latency(out):
    return {k: v for k, v in out.items() if k != "latency_seconds"}


def test_get_routes_match_jax(pair):
    jax_out, port_out = _both(pair, lambda p: [
        _request(p, path) for path in ("/healthz", "/v1/stats", "/metrics",
                                       "/nope")])
    for (js, jh, jb), (ts, th, tb), path in zip(
            jax_out, port_out, ("/healthz", "/v1/stats", "/metrics",
                                "/nope")):
        assert ts == js and th["Content-Type"] == jh["Content-Type"], path
        if path == "/v1/stats":
            assert set(json.loads(tb)) == set(json.loads(jb))
        elif path == "/metrics":
            def names(b):
                return [ln.split()[0 if not ln.startswith("#") else 2]
                        for ln in b.decode().splitlines()]
            assert names(tb) == names(jb)
            assert "# TYPE audio_processor_requests counter" in tb.decode()
        else:
            assert tb == jb, path


def _ogg():
    from tests.vorbis_encoder import make_stereo_stream

    return make_stereo_stream(n_packets=24, seed=3)


def _flac():
    from tests.flac_encoder import encode_flac

    t = np.arange(int(5.5 * 16000)) / 16000.0
    pcm = np.stack([0.4 * np.sin(2 * np.pi * 220 * t),
                    0.4 * np.sin(2 * np.pi * 330 * t)], axis=1)
    pcm += 0.05 * np.random.default_rng(5).standard_normal(pcm.shape)
    ints = np.clip(np.round(pcm * 32767), -32768, 32767).astype(np.int64)
    return encode_flac(ints, 16000, 16, block_size=4096,
                       ch_mode="mid_side", plan=("lpc", 8, 14))


@pytest.mark.parametrize("kind", ["wav", "ogg", "flac"])
def test_transcribe_matches_jax(pair, kind):
    """The same body gives the JAX server's JSON, latency excepted; the
    WAV one with ``?sentiment=1`` (no models: the coordinators' default
    rows, which must match too)."""
    body, query = {"wav": (wav_body(9.0, seed=1), "?sentiment=1"),
                   "ogg": (_ogg(), ""), "flac": (_flac(), "")}[kind]
    (js, jout), (ts, tout) = _both(pair, lambda p: _transcribe(p, body,
                                                               query))
    assert ts == js == 200
    assert tout["num_chunks"] >= 1 and tout["latency_seconds"] > 0
    assert _without_latency(tout) == _without_latency(jout)
    if query:
        assert tout["num_chunks"] == 3
        assert "agent_text_sentiment" in tout["chunks"][0]
    assert not any(k.endswith(("_waveform", "_features", "_probabilities"))
                   for c in tout["chunks"] for k in c)


def test_concurrent_requests_batch_without_crosstalk(pair):
    """Eight bodies of different lengths and audio at once: each answer
    is the JAX server's for the same body (its own chunks, times and
    transcripts), and the port's micro-batcher ran fewer batches than
    requests."""
    _, tsrv = pair
    port = tsrv.server_address[1]
    durs = [2.5, 4.0, 6.0, 7.5, 9.0, 3.0, 5.0, 8.0]
    bodies = [wav_body(d, seed=10 + i) for i, d in enumerate(durs)]
    want = [_transcribe(pair[0].server_address[1], b)[1] for b in bodies]
    got = [None] * len(bodies)
    before = tsrv.service.snapshot_stats()

    def call(i):
        got[i] = _transcribe(port, bodies[i])

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    after = tsrv.service.snapshot_stats()
    for (st, out), w, d in zip(got, want, durs):
        assert st == 200
        assert _without_latency(out) == _without_latency(w)
        bounds = chunk_boundaries(int(d * 16000), 4 * 16000, 3 * 16000)
        assert [c["end_time"] for c in out["chunks"]] == [
            e / 16000 for _, e in bounds]
    assert after["requests"] - before["requests"] == len(bodies)
    assert after["batches"] - before["batches"] < len(bodies)
    assert after["batch_errors"] == before["batch_errors"]


def test_backpressure_is_503_with_retry_after():
    """Past ``serve_max_pending_chunks`` a request is refused with 503
    and Retry-After (and ServerOverloaded on the service API), counted;
    once the budget frees, requests are served again."""
    _, teng = tiny_pair()
    cfg = PipelineConfig.from_dict({**SERVE, "serve_max_pending_chunks": 1,
                                    "serve_warmup": False})
    srv = _start(serving.serve(cfg, host="127.0.0.1", port=0,
                               asr_engine=teng))
    port, svc = srv.server_address[1], srv.service
    try:
        with svc._stats_lock:
            svc._pending_chunks = 1
        st, headers, raw = _request(port, "/v1/transcribe", wav_body(4.0))
        assert st == 503 and headers["Retry-After"] == "5"
        assert "queue full" in json.loads(raw)["error"]
        with pytest.raises(serving.ServerOverloaded):
            svc.transcribe_bytes(wav_body(4.0))
        assert svc.snapshot_stats()["rejected_overload"] == 2
        with svc._stats_lock:
            svc._pending_chunks = 0
        st, out = _transcribe(port, wav_body(4.0))
        assert st == 200 and out["num_chunks"] == 1
        assert svc.snapshot_stats()["pending_chunks"] == 0
    finally:
        _stop(srv)


@pytest.mark.parametrize("package", [jserving, serving],
                         ids=["jax", "port"])
def test_close_drains_in_flight_and_refuses_new(package):
    """``close()`` with a request in flight: the request finishes with
    its rows, a request arriving meanwhile is refused as shutting down
    (503 over HTTP), and the worker stops. Same on both packages."""
    jeng, teng = tiny_pair()
    engine = teng if package is serving else jeng
    cfg = (PipelineConfig if package is serving
           else jconfig.PipelineConfig).from_dict(
        {**SERVE, "serve_warmup": False})
    gate, entered = threading.Event(), threading.Event()
    real = engine.transcribe_chunks

    def held(chunks):
        entered.set()
        assert gate.wait(60)
        return real(chunks)

    engine.transcribe_chunks = held
    srv = _start(package.serve(cfg, host="127.0.0.1", port=0,
                               asr_engine=engine))
    port, svc = srv.server_address[1], srv.service
    result = {}
    inflight = threading.Thread(target=lambda: result.update(
        out=_transcribe(port, wav_body(6.0))))
    inflight.start()
    assert entered.wait(60)
    closer = threading.Thread(target=svc.close, kwargs={"drain_timeout": 60})
    closer.start()
    assert svc._closing.wait(60)
    st, _, raw = _request(port, "/v1/transcribe", wav_body(4.0))
    assert st == 503 and "shutting down" in json.loads(raw)["error"]
    gate.set()
    inflight.join(timeout=60)
    closer.join(timeout=60)
    assert not inflight.is_alive() and not closer.is_alive()
    assert result["out"][0] == 200 and result["out"][1]["num_chunks"] == 2
    assert not svc._worker.is_alive()
    srv.shutdown()
    srv.server_close()


def _multipart(fields):
    boundary = "testboundary7429"
    parts = []
    for name, (fname, data) in fields.items():
        disp = f'form-data; name="{name}"'
        if fname:
            disp += f'; filename="{fname}"'
        parts.append(f"--{boundary}\r\nContent-Disposition: {disp}\r\n"
                     f"Content-Type: application/octet-stream\r\n\r\n"
                     .encode() + data + b"\r\n")
    return (b"".join(parts) + f"--{boundary}--\r\n".encode(),
            {"Content-Type": f"multipart/form-data; boundary={boundary}"})


@pytest.mark.parametrize("fmt", ["json", "text", "verbose_json"])
def test_openai_route_matches_jax(pair, fmt):
    fields = {"file": ("call.wav", wav_body(7.0, seed=2)),
              "model": (None, b"whisper-1")}
    if fmt != "json":
        fields["response_format"] = (None, fmt.encode())
    body, headers = _multipart(fields)
    (js, jh, jb), (ts, th, tb) = _both(pair, lambda p: _request(
        p, "/v1/audio/transcriptions", body, headers))
    assert ts == js == 200 and th["Content-Type"] == jh["Content-Type"]
    assert tb == jb
    if fmt == "verbose_json":
        out = json.loads(tb)
        assert out["task"] == "transcribe" and out["duration"] == 7.0
        assert [s["end"] for s in out["segments"]] == [4.0, 7.0]
    native = _transcribe(pair[1].server_address[1], wav_body(7.0, seed=2))[1]
    text = {"json": lambda b: json.loads(b)["text"],
            "text": lambda b: b.decode()[:-1],
            "verbose_json": lambda b: json.loads(b)["text"]}[fmt](tb)
    assert text == native["transcription"]


def test_400s_match_jax(pair):
    """A body that is not audio, an empty body, and the OpenAI route's
    errors (no file part, not multipart, an unknown response_format):
    400 with the JAX server's error JSON."""
    cases = [("/v1/transcribe", b"this is not audio at all", {}),
             ("/v1/transcribe", b"", {}),
             ("/v1/audio/transcriptions",
              *_multipart({"model": (None, b"whisper-1")})),
             ("/v1/audio/transcriptions", b"rawbytes",
              {"Content-Type": "application/octet-stream"}),
             ("/v1/audio/transcriptions",
              *_multipart({"file": ("c.wav", wav_body(4.0)),
                           "response_format": (None, b"srt")}))]
    for path, body, headers in cases:
        (js, _, jb), (ts, _, tb) = _both(pair, lambda p: _request(
            p, path, body, headers))
        assert ts == js == 400, path
        assert json.loads(tb) == json.loads(jb) and "error" in json.loads(tb)


def test_service_builds_its_engine_on_cuda_by_default():
    """Without an engine, ``InferenceService`` and ``serve`` build one on
    ``cuda``, which raises here, before any model is made or port bound;
    a given engine keeps its device."""
    cfg = PipelineConfig.from_dict({**SERVE, "serve_warmup": False})
    for build in (lambda: serving.InferenceService(cfg),
                  lambda: serving.serve(cfg, host="127.0.0.1", port=0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    _, teng = tiny_pair()
    svc = serving.InferenceService(cfg, asr_engine=teng, device="cuda")
    try:
        assert svc.engine is teng and svc.engine.device.type == "cpu"
        assert svc.transcribe_bytes(wav_body(4.0))["num_chunks"] == 1
        assert svc.warmup_seconds == 0.0
    finally:
        svc.close(drain_timeout=5)
