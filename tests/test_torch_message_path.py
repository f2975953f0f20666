"""The message path on the CPU, port against the JAX package on one set
of tiny fp32 weights (the JAX ``tiny_engine`` of tests/test_engine_e2e.py,
converted with ``params_from_jax``): the mono-rows program's ids off
near-ties, the row tails, the unfused (``fuse_acoustic_features:
false``) chunk rows, and the port's ``DataProcessor`` writing the same
``message`` rows in SQLite as the JAX one (energy VAD), idempotently,
with the reference's batch-failure isolation and VAD-failure contract.
Also the repair: ``enable_profiling`` writes a trace through
``obs/profiler.maybe_trace``."""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from audio_processor_tpu import config as jconfig
from audio_processor_tpu.host.db import DatabaseManager as JaxDB
from audio_processor_tpu.pipeline.engine import DataProcessor as JaxProcessor
from audio_processor_tpu_torch import cli
from audio_processor_tpu_torch.config import PipelineConfig
from audio_processor_tpu_torch.host.db import DatabaseManager
from audio_processor_tpu_torch.io import wav
from audio_processor_tpu_torch.models import wav2vec2bert as tw
from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine
from audio_processor_tpu_torch.pipeline.chunker import chunk_batch, split_audio
from audio_processor_tpu_torch.pipeline.engine import DataProcessor

from tests.conftest import make_stereo_call
from tests.test_engine_e2e import tiny_engine

MARGIN = 1e-3          # ids compared where the JAX top-2 margin exceeds it
SETTINGS = dict(enable_mixed_precision=False, chunk_duration_sec=4.0,
                overlap_sec=1.0, length_buckets_sec=[2.0, 4.0],
                chunk_batch_size=4)


def tiny_pair(**settings):
    """(JAX engine, port engine on the CPU) on one set of tiny weights,
    built from one settings dict."""
    settings = {**SETTINGS, **settings}
    jeng = tiny_engine(jconfig.PipelineConfig.from_dict(settings))
    fields = {f.name for f in dataclasses.fields(tw.W2VBertConfig)}
    mcfg = tw.W2VBertConfig(**{k: v for k, v in dataclasses.asdict(
        jeng.model_cfg).items() if k in fields})
    model = tw.Wav2Vec2Bert(mcfg)
    model.load_state_dict(tw.params_from_jax(jeng.params, mcfg))
    teng = ASREngine(PipelineConfig.from_dict(settings), device="cpu",
                     model=model, vocab=jeng.vocab)
    return jeng, teng


def _rows(seed, n, bucket):
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, bucket), np.float32)
    lengths = rng.integers(bucket // 3, bucket + 1, n).astype(np.int32)
    for i, t in enumerate(lengths):
        rows[i, :t] = make_stereo_call(dur=bucket / 16000)[i % 2, :t] \
            + 0.05 * rng.standard_normal(t)
    return rows, lengths


def _jax_mono_logits(jeng, rows, lengths):
    import jax.numpy as jnp

    from audio_processor_tpu.dsp.fbank import log_mel_frontend
    from audio_processor_tpu.models import wav2vec2bert as jw
    from audio_processor_tpu.pipeline.asr_engine import _pad_seq_to_128

    feats, mask = _pad_seq_to_128(*log_mel_frontend(jnp.asarray(rows),
                                                    jnp.asarray(lengths)))
    return np.asarray(jw.forward(jeng.params, jeng.model_cfg, feats, mask,
                                 attention_impl=jeng.attention_impl))


def test_mono_program_matches_jax():
    """Greedy ids of the mono program equal the JAX ``_device_fn``'s on
    every frame whose JAX top-2 margin exceeds 1e-3; masks equal."""
    jeng, teng = tiny_pair()
    for bucket in teng.bucket_samples:
        rows, lengths = _rows(bucket, 12, bucket)
        jids, jmask = (np.asarray(a) for a in jeng._device_fn(bucket)(
            jeng.params, rows, lengths))
        ids, mask = (t.numpy() for t in teng._mono(
            torch.from_numpy(rows), torch.from_numpy(lengths), beam=False))
        np.testing.assert_array_equal(mask, jmask)
        logits = _jax_mono_logits(jeng, rows, lengths)
        top2 = np.sort(logits, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > MARGIN
        assert clear[jmask].mean() > 0.9, clear[jmask].mean()
        np.testing.assert_array_equal(ids[clear], jids[clear])
    assert teng.mono_dispatches == 2
    assert set(teng.mono_shapes) == {(12, b) for b in teng.bucket_samples}


def test_row_tail_size_matches_jax():
    for size in (4, 16):
        jeng, teng = tiny_pair(chunk_batch_size=size)
        assert teng.device_batch == jeng.device_batch == 3 * size
        for n in range(1, 3 * size + 1):
            assert teng._row_tail_size(n) == jeng._row_tail_size(n), n
        assert {teng._row_tail_size(n) for n in (1, 3 * size // 2, 3 * size)} \
            == {3 * size // 4, 3 * size // 2, 3 * size}


def test_unfused_rows_match_jax():
    """``fuse_acoustic_features: false`` runs the three views of each
    chunk through the greedy mono program, as the JAX engine does: the
    same transcripts and keys (no acoustic features)."""
    jeng, teng = tiny_pair(fuse_acoustic_features=False)
    assert not teng.fuse_acoustic_features
    rng = np.random.default_rng(1)
    call = make_stereo_call(dur=9.0) + 0.05 * rng.standard_normal(
        (2, 9 * 16000)).astype(np.float32)
    got = teng.transcribe_chunks(split_audio(call, 16000, "c.wav", 4.0, 1.0))
    want = jeng.transcribe_chunks(split_audio(call, 16000, "c.wav", 4.0,
                                              1.0))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) and "agent_acoustic_features" not in g
        for key in ("transcription_chunk", "agent_transcription",
                    "client_transcription", "error"):
            assert g[key] == w[key], key
    (batch,) = chunk_batch(split_audio(call, 16000, "c.wav", 4.0, 1.0),
                           teng.bucket_samples)
    rows, lengths = teng._prepare_rows(batch)
    jrows, jlengths = jeng._prepare_rows(batch)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(lengths, jlengths)
    assert teng.dispatches == 0 and teng.mono_dispatches == 1
    # Unfused, every tail runs at the full device batch: one shape,
    # already run above.
    assert (64000, 4) in teng._warmed and teng.warmup() == 0


@pytest.fixture
def workspace(tmp_path):
    """Three stereo calls with speech bursts over light noise, PCM16."""
    inp = tmp_path / "input"
    inp.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        dur = 4.0 + i
        call = make_stereo_call(dur=dur) + 0.01 * rng.standard_normal(
            (2, int(16000 * dur))).astype(np.float32)
        wav.write(inp / f"call-{i}.wav", call, 16000)
    settings = {**SETTINGS, "input_folder": str(inp),
                "logs_folder": str(tmp_path / "logs"),
                "temp_dir": str(tmp_path / "tmp"), "file_batch_size": 2,
                "database_type": "sqlite", "enable_message_path": True,
                "vad_max_segment_sec": 4.0}
    return tmp_path, settings


def _messages(db, n=3):
    return {f"call-{i}": [(m["order_message"], m["speaker"], m["text"])
                          for m in db.get_messages_by_id_enregistrement(
                              f"call-{i}")] for i in range(n)}


def _port_run(root, settings, tag, teng, patch=None):
    cfg = PipelineConfig.from_dict({**settings,
                                    "output_folder": str(root / tag),
                                    "db_path": str(root / f"{tag}.db")})
    db = DatabaseManager(cfg)
    proc = DataProcessor(cfg, db_manager=db, asr_engine=teng, device="cpu")
    if patch is not None:
        patch(proc)
    try:
        n = proc.run()
    finally:
        proc.close()
    return proc, db, n


def test_message_rows_equal_jax(workspace):
    """The port's DataProcessor writes the JAX one's message rows (order,
    speaker, text) for every call; a rerun with cleared markers gives
    the same rows (idempotent delete + insert)."""
    root, settings = workspace
    jeng, teng = tiny_pair(**settings)
    jcfg = jconfig.PipelineConfig.from_dict(
        {**settings, "output_folder": str(root / "jax"),
         "db_path": str(root / "jax.db")})
    jdb = JaxDB(jcfg)
    jproc = JaxProcessor(jcfg, db_manager=jdb, asr_engine=jeng)
    assert jproc.run() == 3
    want = _messages(jdb)
    jdb.close()
    proc, db, n = _port_run(root, settings, "port", teng)
    assert n == 3 and proc.stats["errors"] == 0
    got = _messages(db)
    assert got == want
    assert all(got.values())
    assert {s for rows in got.values() for _, s, _ in rows} == {"agent",
                                                                "client"}
    assert all([o for o, _, _ in rows] == list(range(1, len(rows) + 1))
               for rows in got.values())
    assert proc._transcriber.segmenter._vad_params is None    # energy VAD
    assert teng.mono_dispatches > 0
    shutil.rmtree(proc.markers.dir)
    proc2 = DataProcessor(proc.config, db_manager=db, asr_engine=teng,
                          device="cpu")
    try:
        assert proc2.run() == 3
    finally:
        proc2.close()
    assert _messages(db) == got
    db.close()


def test_batch_failure_retries_per_file(workspace, monkeypatch):
    """A failed batched mono transcription is retried file by file, so
    the files still get their rows."""
    root, settings = workspace
    _, teng = tiny_pair(**settings)
    calls = {"n": 0}

    def patch(proc):
        from audio_processor_tpu_torch.pipeline.segmenter import (
            SpeechBatchTranscriber,
        )

        proc._transcriber = SpeechBatchTranscriber(proc.config,
                                                   asr_engine=teng)
        seg = proc._transcriber.segmenter
        real = seg.transcribe_segments_batched

        def flaky(segments, sr):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("simulated batched failure")
            return real(segments, sr)

        monkeypatch.setattr(seg, "transcribe_segments_batched", flaky)

    _, db, n = _port_run(root, settings, "iso", teng, patch)
    assert n == 3 and calls["n"] >= 3
    msgs = _messages(db)
    assert msgs["call-0"] and msgs["call-1"]
    db.close()


def test_vad_failure_keeps_existing_rows(workspace, monkeypatch):
    """A VAD failure on reprocess (None, not []) skips the call's
    refresh, so its existing message rows stay."""
    from audio_processor_tpu_torch.pipeline import segmenter as tseg

    root, settings = workspace
    _, teng = tiny_pair(**settings)
    proc, db, n = _port_run(root, settings, "vadfail", teng)
    before = _messages(db)
    assert n == 3 and all(before.values())
    shutil.rmtree(proc.markers.dir)
    monkeypatch.setattr(tseg.SpeechSegment, "get_speech_segments_multi",
                        lambda self, channels, sr: [None] * len(channels))
    proc2 = DataProcessor(proc.config, db_manager=db, asr_engine=teng,
                          device="cpu")
    try:
        assert proc2.run() == 3
        assert proc2.stats["errors"] == 3
    finally:
        proc2.close()
    assert _messages(db) == before
    db.close()


def test_enable_profiling_writes_a_trace(workspace):
    """``enable_profiling: true`` through the CLI (``maybe_trace`` around
    the sweep) writes a Chrome trace under ``<output_folder>/profile``
    that holds the run's host ops."""
    import yaml

    root, settings = workspace
    _, teng = tiny_pair()
    out = root / "prof"
    cfg_path = root / "prof.yaml"
    cfg_path.write_text(yaml.safe_dump({
        **{k: v for k, v in settings.items() if k != "database_type"},
        "enable_message_path": False, "output_folder": str(out),
        "enable_profiling": True}))
    real = ASREngine._load_or_init
    ASREngine._load_or_init = lambda self: (teng.model, teng.vocab)
    try:
        assert cli.main(["--config", str(cfg_path), "--save-mode", "csv",
                         "--device", "cpu"]) == 0
    finally:
        ASREngine._load_or_init = real
    (trace,) = (out / "profile").glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names), sorted(names)[:20]
    assert list(out.glob("optimized_results_*.csv"))
