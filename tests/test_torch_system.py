"""The port's streaming chunker, speaker views and system probes against
the JAX package's, and the port's CLI ``--serve`` on the CPU.

``StreamingChunker`` must give, for any piece sizes, the chunks of the
JAX one and of a one-shot ``split_audio`` (boundaries, indices, both
speaker views bit for bit) while holding at most about one chunk
window. The device probes read CUDA, so here they report no device;
``cli.main(["--serve", "--device", "cpu", ...])`` serves ``/healthz``
and ``/v1/transcribe`` from a tiny HF checkpoint, and without
``--device cpu`` it refuses to start."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import yaml
from hypothesis import given, settings, strategies as st

from audio_processor_tpu.pipeline import chunker as jchunker
from audio_processor_tpu.utils import system as jsystem
from audio_processor_tpu_torch import cli, serving
from audio_processor_tpu_torch.pipeline import chunker
from audio_processor_tpu_torch.utils import system

SR = 16000


def _streamed(cls, x, steps, cd, ov):
    sc = cls(SR, "stream", cd, ov)
    out, i, k = [], 0, 0
    while i < x.shape[1]:
        step = steps[k % len(steps)]
        out += sc.feed(x[:, i:i + step])
        i, k = i + step, k + 1
    return out + sc.flush() + sc.flush()      # a second flush adds nothing


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(n=st.integers(1, 12 * SR), channels=st.sampled_from([1, 2]),
       geometry=st.sampled_from([(2.0, 0.0), (2.0, 0.5), (4.0, 1.0),
                                 (25.0 / 8, 1.0), (1.0, 0.5)]),
       steps=st.lists(st.integers(1, 3 * SR), min_size=1, max_size=8))
def test_streaming_chunker_matches_jax_and_split_audio(n, channels, geometry,
                                                        steps):
    cd, ov = geometry
    x = (np.random.default_rng(n).standard_normal((channels, n)) * 0.1
         ).astype(np.float32)
    ref = chunker.split_audio(x, SR, "stream", cd, ov)
    got = _streamed(chunker.StreamingChunker, x, steps, cd, ov)
    jax_got = _streamed(jchunker.StreamingChunker, x, steps, cd, ov)
    assert len(got) == len(jax_got) == len(ref)
    for a, j, b in zip(got, jax_got, ref):
        assert a.file_name == j.file_name == b.file_name == "stream"
        assert a.chunk_idx == j.chunk_idx == b.chunk_idx
        assert a.start_time == j.start_time == b.start_time
        assert a.end_time == j.end_time == b.end_time
        for view in ("agent", "client", "mixed"):
            np.testing.assert_array_equal(getattr(a, view), getattr(b, view))
            np.testing.assert_array_equal(getattr(a, view), getattr(j, view))


def test_streaming_chunker_memory_bound_and_edges():
    """The buffer never holds more than a chunk window plus one piece,
    over a long stream; an exact-end stream has no trailing chunk, a
    channel change mid-stream and a non-positive step raise, as in the
    JAX package."""
    sc = chunker.StreamingChunker(SR, "s", 4.0, 1.0)
    rng = np.random.default_rng(1)
    emitted = 0
    for _ in range(200):
        emitted += len(sc.feed(rng.standard_normal((2, SR)).astype(
            np.float32)))
        assert sc._buf.shape[1] <= sc.chunk_samples + SR
    assert emitted == len(chunker.chunk_boundaries(200 * SR, 4 * SR,
                                                   3 * SR)) - 1
    assert len(sc.flush()) == 1 and sc.flush() == []

    for mod in (chunker, jchunker):
        exact = mod.StreamingChunker(SR, "s", 4.0, 1.0)
        got = exact.feed(np.zeros((1, 7 * SR), np.float32))
        assert [c.end_time for c in got] == [4.0, 7.0] and exact.flush() == []
        assert mod.StreamingChunker(SR).feed(np.zeros((2, 0))) == []
        sc2 = mod.StreamingChunker(SR, "s", 4.0, 1.0)
        sc2.feed(np.zeros((2, 10), np.float32))
        with pytest.raises(ValueError, match="channel count"):
            sc2.feed(np.zeros((1, 10), np.float32))
        with pytest.raises(ValueError, match="geometry"):
            mod.StreamingChunker(SR, "s", 1.0, 1.0)


@pytest.mark.parametrize("shape", [(9,), (1, 9), (2, 9), (3, 9)])
def test_speaker_views_match_jax(shape):
    x = np.random.default_rng(2).standard_normal(shape)   # float64 in
    got = chunker.speaker_views(x)
    want = jchunker.speaker_views(x)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    if shape[0] == 2:
        np.testing.assert_array_equal(got[1], x[0].astype(np.float32))
        np.testing.assert_array_equal(got[2], x[1].astype(np.float32))


def test_pad_chunk_waveforms_matches_jax():
    rng = np.random.default_rng(3)
    for waves in ([rng.standard_normal((2, 5)), rng.standard_normal((2, 3)),
                   rng.standard_normal((2, 5))],
                  [rng.standard_normal(4), rng.standard_normal(7)],
                  [np.ones((1, 2), np.float32)], []):
        got = system.pad_chunk_waveforms(waves)
        want = jsystem.pad_chunk_waveforms(waves)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_device_probes_report_no_cuda_here():
    """No CUDA here: the probes say so, never report the CPU as the
    device, and the host stats carry no device key. The reference's
    names are aliases of the same functions."""
    ok, msg = system.check_device_availability()
    assert ok is False and "CUDA" in msg
    assert system.check_device_availability(3)[0] is False
    assert system.get_device_memory_usage() is None
    assert system.get_device_memory_usage(1) is None
    stats = system.get_system_stats()
    assert "device_memory_percent" not in stats
    assert set(stats) <= set(jsystem.get_system_stats()) | {
        "device_memory_percent"}
    assert system.check_gpu_availability is system.check_device_availability
    assert system.get_gpu_memory_usage is system.get_device_memory_usage
    assert not hasattr(system, "enable_compilation_cache")


def _serve_config(tmp_path, model_dir) -> str:
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump({
        "input_folder": str(tmp_path / "in"),
        "output_folder": str(tmp_path / "out"),
        "logs_folder": str(tmp_path / "logs"),
        "transcription_model": str(model_dir),
        "enable_mixed_precision": False, "chunk_duration_sec": 4.0,
        "overlap_sec": 1.0, "length_buckets_sec": [2.0, 4.0],
        "chunk_batch_size": 4, "serve_warmup": False}))
    return str(path)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, json.loads(r.read())


def test_cli_serve_on_the_cpu_answers(tmp_path, monkeypatch):
    """``--serve --device cpu`` builds the engine from the config's HF
    directory on the CPU and answers /healthz and /v1/transcribe; a
    shutdown drains it and main returns 0."""
    from audio_processor_tpu_torch.io import wav

    from tests.conftest import make_stereo_call
    from tests.test_torch_hf_checkpoint import _save_w2v

    _save_w2v(tmp_path / "w2v")
    servers = []
    real_serve = serving.serve

    def spy(*a, **k):
        servers.append(real_serve(*a, **k))
        return servers[-1]

    monkeypatch.setattr(serving, "serve", spy)
    rc = []
    t = threading.Thread(target=lambda: rc.append(cli.main([
        "--config", _serve_config(tmp_path, tmp_path / "w2v"),
        "--save-mode", "csv", "--serve", "--port", "0", "--device", "cpu"])),
        daemon=True)
    t.start()
    deadline = time.time() + 120
    while not servers and time.time() < deadline:
        time.sleep(0.05)
    (server,) = servers
    port = server.server_address[1]
    try:
        assert _get(port, "/healthz") == (200, {"status": "ok"})
        engine = server.service.engine
        assert engine.device.type == "cpu"
        assert engine.model_cfg.num_hidden_layers == 3
        wav.write(tmp_path / "call.wav", make_stereo_call(dur=6.0), SR)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/transcribe",
            data=(tmp_path / "call.wav").read_bytes())
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert out["num_chunks"] == 2 and out["duration_seconds"] == 6.0
        assert [c["end_time"] for c in out["chunks"]] == [4.0, 6.0]
        assert _get(port, "/v1/stats")[1]["requests"] == 1
    finally:
        server.shutdown()
        t.join(timeout=60)
    assert not t.is_alive() and rc == [0]
    assert server.service._closing.is_set()


def test_cli_serve_needs_cuda_unless_asked_and_one_process(tmp_path,
                                                           monkeypatch):
    """Without ``--device cpu`` the server is not built here (no CUDA);
    a launch that names two processes but not this one's rank never runs
    as one process: it is refused before the server is built."""
    built = []
    monkeypatch.setattr(serving, "serve", lambda *a, **k: built.append(1))
    cfg = _serve_config(tmp_path, tmp_path / "absent")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--config", cfg, "--save-mode", "csv", "--serve"])
    for k in ("RANK", "MASTER_ADDR", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="RANK"):
        cli.main(["--config", cfg, "--save-mode", "csv", "--serve",
                  "--device", "cpu"])
    assert built == []
