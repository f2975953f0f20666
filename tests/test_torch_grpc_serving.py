"""The port's gRPC front-end (grpc_serving.py) against the JAX package's.

A port service and a JAX service on one set of tiny fp32 weights
(``tiny_pair``), each behind its package's ``GrpcInferenceServer``, are
driven by the port's ``GrpcClient``: health and stats, unary transcripts
equal to the port's HTTP path and to the JAX server's, streaming equal
to unary and to the JAX server's stream (uneven pieces, mono, empty and
mid-frame byte splits, concurrent streams), the wrong rate or channel
count rejected, RESOURCE_EXHAUSTED on backpressure; and the port's and
the reference's ``serving_pb2`` loaded in one process."""

import threading
from pathlib import Path

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from audio_processor_tpu import config as jconfig  # noqa: E402
from audio_processor_tpu import grpc_serving as jgrpc  # noqa: E402
from audio_processor_tpu import serving as jserving  # noqa: E402
from audio_processor_tpu_torch import grpc_serving, serving  # noqa: E402
from audio_processor_tpu_torch.config import PipelineConfig  # noqa: E402

from tests.conftest import make_stereo_call  # noqa: E402
from tests.test_torch_serving import (  # noqa: E402
    SERVE, _request, pcm16_wav, wav_body,
)
from tests.test_torch_message_path import tiny_pair  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIELDS = ("chunk_idx", "start_time", "end_time", "transcription_chunk",
          "agent_transcription", "client_transcription", "error",
          "extras_json")


@pytest.fixture(scope="module")
def servers():
    """{"port": (service, server, client), "jax": (...)}, one engine
    pair; both clients are the port's."""
    jeng, teng = tiny_pair()
    out = {}
    for name, svc in (
            ("port", serving.InferenceService(PipelineConfig.from_dict(SERVE),
                                              asr_engine=teng)),
            ("jax", jserving.InferenceService(
                jconfig.PipelineConfig.from_dict(SERVE), asr_engine=jeng))):
        module = grpc_serving if name == "port" else jgrpc
        srv = module.GrpcInferenceServer(svc, port=0)
        srv.start()
        out[name] = (svc, srv, grpc_serving.GrpcClient(
            f"127.0.0.1:{srv.bound_port}"))
    yield out
    for svc, srv, client in out.values():
        client.close()
        srv.stop()
        svc.close()


def _pcm(dur, seed):
    x = make_stereo_call(dur=dur) + 0.05 * np.random.default_rng(
        seed).standard_normal((2, int(16000 * dur))).astype(np.float32)
    return np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)


def _pieces(pcm, seed, lo=1000, hi=30000):
    rng = np.random.default_rng(seed)
    pieces, i = [], 0
    while i < pcm.shape[-1]:
        n = int(rng.integers(lo, hi))
        pieces.append(pcm[..., i:i + n])
        i += n
    return pieces


def _rows(chunks):
    return [tuple(getattr(c, f) for f in FIELDS) for c in chunks]


def test_health_and_stats_match_jax(servers):
    port, jax = servers["port"][2], servers["jax"][2]
    for client in (port, jax):
        r = client.health()
        assert r.ok and r.status == "serving"
    assert set(port.stats()) == set(jax.stats())


def test_unary_matches_http_path_and_jax(servers):
    """The port's unary RPC gives what the port's HTTP route gives for
    the same body (an HTTP server over the same service), and the JAX
    gRPC server's response."""
    import json
    from http.server import ThreadingHTTPServer

    body = wav_body(7.0, seed=21)
    resp = servers["port"][2].transcribe(body, timeout=120.0)
    jresp = servers["jax"][2].transcribe(body, timeout=120.0)
    http = ThreadingHTTPServer(("127.0.0.1", 0),
                               serving.make_handler(servers["port"][0]))
    threading.Thread(target=http.serve_forever, daemon=True).start()
    try:
        status, _, raw = _request(http.server_address[1], "/v1/transcribe",
                                  body)
    finally:
        http.shutdown()
        http.server_close()
    assert status == 200
    direct = json.loads(raw)
    assert resp.num_chunks == direct["num_chunks"] == 2
    assert resp.duration_seconds == direct["duration_seconds"] == 7.0
    for key in ("transcription", "agent_transcription",
                "client_transcription"):
        assert getattr(resp, key) == direct[key] == getattr(jresp, key)
    assert _rows(resp.chunks) == _rows(jresp.chunks)
    assert [c.end_time for c in resp.chunks] == [
        c["end_time"] for c in direct["chunks"]]
    assert resp.latency_seconds > 0 and jresp.num_chunks == 2


def test_streaming_matches_unary_and_jax(servers):
    """Uneven int16 pieces give unary's chunk boundaries and transcripts,
    and the JAX server's stream result for result."""
    pcm = _pcm(10.0, seed=22)
    pieces = _pieces(pcm, seed=0)
    got = list(servers["port"][2].streaming_transcribe(pieces, channels=2,
                                                       timeout=300.0))
    jgot = list(servers["jax"][2].streaming_transcribe(pieces, channels=2,
                                                       timeout=300.0))
    direct = servers["port"][0].transcribe_bytes(pcm16_wav(pcm))
    assert len(got) == direct["num_chunks"] == 3
    for g, d in zip(got, direct["chunks"]):
        assert (g.chunk_idx, g.start_time, g.end_time) == (
            d["chunk_idx"], d["start_time"], d["end_time"])
        for key in ("transcription_chunk", "agent_transcription",
                    "client_transcription"):
            assert getattr(g, key) == d[key]
    assert _rows(got) == _rows(jgot)


def test_streaming_mono_and_empty(servers):
    """A mono stream puts ch0 in both speaker views; an empty stream
    ends with no chunks; the stream counters move."""
    client = servers["port"][2]
    mono = (np.random.default_rng(1).standard_normal(16000 * 4) * 6000
            ).astype(np.int16)
    before = client.stats()
    got = list(client.streaming_transcribe([mono], channels=1,
                                           timeout=120.0))
    jgot = list(servers["jax"][2].streaming_transcribe([mono], channels=1,
                                                       timeout=120.0))
    assert len(got) == 1 and _rows(got) == _rows(jgot)
    assert got[0].agent_transcription == got[0].client_transcription
    after = client.stats()
    assert after["stream_chunks"] - before["stream_chunks"] == 1
    assert after["stream_audio_seconds"] - before[
        "stream_audio_seconds"] == pytest.approx(4.0)
    assert list(client.streaming_transcribe([], channels=2,
                                            timeout=60.0)) == []


@pytest.mark.parametrize("rate,channels", [(8000, 1), (16000, 3)])
def test_streaming_rejects_wrong_rate_or_channels(servers, rate, channels):
    pcm = np.zeros(8000 * channels, np.int16)
    for name in ("port", "jax"):
        with pytest.raises(grpc.RpcError) as exc:
            list(servers[name][2].streaming_transcribe(
                [pcm.tobytes()], sample_rate=rate, channels=channels,
                timeout=60.0))
        assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
        assert ("Hz" if rate != 16000 else "channels") in \
            exc.value.details()


def test_streaming_mid_frame_message_splits(servers):
    """Raw-byte messages cut mid-int16 and mid-frame give the results of
    frame-aligned streaming (partial frames carry across messages)."""
    pcm = _pcm(6.0, seed=23)
    raw = np.ascontiguousarray(pcm.T).tobytes()
    rng = np.random.default_rng(3)
    pieces, i = [], 0
    while i < len(raw):
        n = int(rng.integers(1, 40001))
        pieces.append(raw[i:i + n])
        i += n
    assert any(len(p) % 4 for p in pieces)
    client = servers["port"][2]
    got = list(client.streaming_transcribe(pieces, channels=2,
                                           timeout=300.0))
    aligned = list(client.streaming_transcribe([pcm], channels=2,
                                               timeout=300.0))
    assert len(got) == len(aligned) == 2
    assert _rows(got) == _rows(aligned)


def test_concurrent_streams_and_unary_do_not_cross(servers):
    """Four streams of different audio and length, with unary requests
    between them, share one micro-batcher: each stream gets its own
    chunks, equal to its solo run."""
    client = servers["port"][2]
    streams = [_pieces(_pcm(d, seed=30 + k), seed=k, lo=5000, hi=40000)
               for k, d in enumerate((6.0, 8.5, 10.0, 7.25))]
    solo = [_rows(client.streaming_transcribe(p, channels=2, timeout=300.0))
            for p in streams]
    results, errs = {}, []

    def run_stream(k):
        try:
            results[k] = _rows(client.streaming_transcribe(
                streams[k], channels=2, timeout=300.0))
        except Exception as e:  # pragma: no cover
            errs.append(repr(e))

    def run_unary():
        try:
            client.transcribe(wav_body(4.0, seed=40), timeout=300.0)
        except Exception as e:  # pragma: no cover
            errs.append(repr(e))

    threads = [threading.Thread(target=run_stream, args=(k,))
               for k in range(4)]
    threads += [threading.Thread(target=run_unary) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs and not any(t.is_alive() for t in threads)
    assert [results[k] for k in range(4)] == solo
    assert [len(s) for s in solo] == [2, 3, 3, 3]


def test_errors_map_to_status_codes(servers):
    """Backpressure is RESOURCE_EXHAUSTED on the unary and the streaming
    RPC; a body that is not audio is INVALID_ARGUMENT, as on the JAX
    server."""
    svc, _, client = servers["port"]
    with pytest.raises(grpc.RpcError) as exc:
        client.transcribe(b"not audio at all", timeout=30.0)
    with pytest.raises(grpc.RpcError) as jexc:
        servers["jax"][2].transcribe(b"not audio at all", timeout=30.0)
    assert exc.value.code() == jexc.value.code() \
        == grpc.StatusCode.INVALID_ARGUMENT
    with svc._stats_lock:
        svc._pending_chunks = svc.max_pending_chunks
    try:
        with pytest.raises(grpc.RpcError) as exc:
            client.transcribe(wav_body(4.0), timeout=30.0)
        assert exc.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        with pytest.raises(grpc.RpcError) as exc:
            list(client.streaming_transcribe([_pcm(4.0, seed=1)],
                                             channels=2, timeout=30.0))
        assert exc.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    finally:
        with svc._stats_lock:
            svc._pending_chunks = 0
    assert client.transcribe(wav_body(4.0), timeout=60.0).num_chunks == 1


def test_port_and_reference_stubs_load_in_one_process():
    """The port's ``serving_pb2`` is the reference's byte for byte and
    shares its message classes in one process: a message from either
    parses with the other; the wire name stays the reference's."""
    from audio_processor_tpu.protos import serving_pb2 as ref
    from audio_processor_tpu_torch.protos import serving_pb2 as port

    for name in ("serving.proto", "serving_pb2.py"):
        assert (REPO / "audio_processor_tpu_torch" / "protos" / name
                ).read_bytes() == (REPO / "audio_processor_tpu" / "protos"
                                   / name).read_bytes()
    assert port.TranscribeRequest is ref.TranscribeRequest
    assert port.DESCRIPTOR.package == "audio_processor_tpu.v1"
    msg = port.TranscribeResponse(num_chunks=2, transcription="salam",
                                  chunks=[port.ChunkResult(chunk_idx=1)])
    back = ref.TranscribeResponse.FromString(msg.SerializeToString())
    assert back.transcription == "salam" and back.chunks[0].chunk_idx == 1
    assert grpc_serving.SERVICE == jgrpc.SERVICE \
        == "audio_processor_tpu.v1.AudioProcessor"
