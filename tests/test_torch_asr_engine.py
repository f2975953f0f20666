"""The whole slice: the port's ASREngine (PyTorch, CPU) against the JAX
ASREngine on one set of tiny weights (JAX ``init_params`` converted
with ``params_from_jax``), fp32 compute with the int16 wire."""

import numpy as np
import pytest
import torch

from audio_processor_tpu import config as jconfig
from audio_processor_tpu.models import wav2vec2bert as jw
from audio_processor_tpu_torch.config import PipelineConfig
from audio_processor_tpu_torch.models import wav2vec2bert as tw
from audio_processor_tpu_torch.models.tokenizer import CTCVocab
from audio_processor_tpu_torch.obs import profiler
from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine
from audio_processor_tpu_torch.pipeline.chunker import chunk_batch, split_audio
from audio_processor_tpu_torch.pipeline.engine import DataProcessor

from tests.conftest import make_stereo_call

KW = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
          intermediate_size=256, conv_depthwise_kernel_size=7)
MARGIN = 1e-3          # ids compared where the JAX top-2 margin exceeds it
# Acoustic features: the bound of tests/test_fused_engine.py (relative
# to max(|ref|, 1)).
FEAT_ATOL = 2e-4


def _int16_exact_call(dur):
    rng = np.random.default_rng(0)
    call = make_stereo_call(dur=dur) + 0.02 * rng.standard_normal(
        (2, int(16000 * dur))).astype(np.float32)
    return np.round(call * 32767).astype(np.int16).astype(np.float32) \
        / 32768.0


@pytest.fixture(scope="module")
def engines():
    import jax

    from audio_processor_tpu.pipeline.asr_engine import ASREngine as JaxEngine

    cfg = PipelineConfig(enable_mixed_precision=False,
                         chunk_duration_sec=4.0, overlap_sec=1.0,
                         length_buckets_sec=(2.0, 4.0), chunk_batch_size=4)
    jcfg_pipe = jconfig.PipelineConfig.from_dict(cfg.to_dict())
    vocab = CTCVocab.darija_default()
    jcfg = jw.W2VBertConfig(vocab_size=len(vocab), **KW)
    params = jw.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tw.W2VBertConfig(vocab_size=len(vocab), **KW)
    model = tw.Wav2Vec2Bert(tcfg)
    model.load_state_dict(tw.params_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    jeng = JaxEngine(jcfg_pipe, params=params, model_cfg=jcfg, vocab=vocab)
    teng = ASREngine(cfg, device="cpu", model=model, vocab=vocab)
    return jeng, teng


def _jax_logits(jeng, buf, lengths, bucket):
    """The JAX fused program's logits (its ids are their argmax)."""
    import jax.numpy as jnp

    from audio_processor_tpu.dsp.acoustic_features import PAD
    from audio_processor_tpu.dsp.fbank import log_mel_frontend
    from audio_processor_tpu.pipeline.asr_engine import _pad_seq_to_128

    x = jnp.asarray(buf).astype(jnp.float32) / 32768.0
    agent = x[:, 0, PAD:PAD + bucket]
    client = x[:, 1, PAD:PAD + bucket]
    rows = jnp.stack([(agent + client) * 0.5, agent, client],
                     axis=1).reshape(-1, bucket)
    feats, mask = log_mel_frontend(rows, jnp.repeat(lengths, 3))
    feats, mask = _pad_seq_to_128(feats, mask)
    return np.asarray(jw.forward(jeng.params, jeng.model_cfg, feats, mask,
                                 attention_impl=jeng.attention_impl))


def _assert_clear_ids_equal(jeng, ids, jids, jmask, buf, lengths, n,
                            bucket):
    """Greedy ids equal on the batch's real rows wherever the JAX
    logits' top-2 margin exceeds MARGIN (most valid frames)."""
    logits = _jax_logits(jeng, buf, lengths, bucket)[:3 * n]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN
    assert clear[jmask[:3 * n]].mean() > 0.5
    np.testing.assert_array_equal(ids[:3 * n][clear], jids[:3 * n][clear])


def test_fused_program_matches_jax(engines):
    jeng, teng = engines
    chunks = split_audio(_int16_exact_call(9.0), 16000, "c.wav", 4.0, 1.0)
    (batch,) = chunk_batch(chunks, teng.bucket_samples)
    n_dev = teng._tail_size(len(batch))
    assert n_dev == jeng._tail_size(len(batch)) == 4
    buf, lengths = teng._prepare_fused_buffer(batch, n_dev)
    jbuf, jlengths = jeng._prepare_fused_buffer(batch, n_dev)
    assert buf.dtype == np.int16
    np.testing.assert_array_equal(buf, jbuf)
    np.testing.assert_array_equal(lengths, jlengths)

    bucket = batch.bucket_len
    jids, jmask, jaf = (np.asarray(a) for a in jeng._fused_fn(bucket)(
        jeng.params, buf, lengths))
    ids, mask, af = (t.numpy() for t in teng._fused(
        torch.from_numpy(buf), torch.from_numpy(lengths), bucket))

    np.testing.assert_array_equal(mask, jmask)
    assert (ids[~mask] == 0).all()
    # Rows of the padding chunk (zero audio) are dropped by the engine
    # and numerically arbitrary (normalizing a constant signal), so only
    # the batch's real chunks are compared.
    n = len(batch)
    _assert_clear_ids_equal(jeng, ids, jids, jmask, buf, lengths, n, bucket)

    assert af.shape == jaf.shape == (4, 2, 38)
    scale = np.maximum(np.abs(jaf[:n]), 1.0)
    np.testing.assert_allclose(af[:n] / scale, jaf[:n] / scale,
                               atol=FEAT_ATOL)


def test_flash_attention_from_the_config(engines, monkeypatch):
    """``attention_impl: flash`` in the config reaches the engine that the
    DataProcessor builds, with no other change, and the fused program
    under it (bias materialised in bf16, flash plain version on the CPU,
    L = 256) gives the JAX program's ids on clear frames."""
    jeng, teng = engines
    monkeypatch.setattr(ASREngine, "_load_or_init",
                        lambda self: (teng.model, teng.vocab))
    cfg = PipelineConfig.from_dict({**teng.config.to_dict(),
                                    "attention_impl": "flash"})
    proc = DataProcessor(cfg, device="cpu")
    try:
        proc.setup_models()
    finally:
        proc.close()
    feng = proc.asr_engine
    assert feng.attention_impl == "flash" and feng.model is teng.model

    chunks = split_audio(_int16_exact_call(9.0), 16000, "c.wav", 4.0, 1.0)
    (batch,) = chunk_batch(chunks, feng.bucket_samples)
    buf, lengths = feng._prepare_fused_buffer(batch, 4)
    bucket = batch.bucket_len
    jids, jmask, _ = (np.asarray(a) for a in jeng._fused_fn(bucket)(
        jeng.params, buf, lengths))
    ids, mask, _ = (t.numpy() for t in feng._fused(
        torch.from_numpy(buf), torch.from_numpy(lengths), bucket))
    assert mask.shape[1] % 128 == 0          # the flash kernel's path
    np.testing.assert_array_equal(mask, jmask)
    _assert_clear_ids_equal(jeng, ids, jids, jmask, buf, lengths,
                            len(batch), bucket)


@pytest.mark.parametrize("impl, wrapper", [
    ("flash_rel", "flash_rel_attention"), ("flash", "flash_attention")])
def test_every_padded_batch_reaches_the_kernel_wrapper(engines, monkeypatch,
                                                      impl, wrapper):
    """The engine pads L so that the model never sends one of its batches
    to the plain attention that an L off the kernel's multiple takes: at
    each bucket, every encoder layer calls the kernel's wrapper once."""
    _, teng = engines
    calls = []
    real = getattr(tw, wrapper)
    monkeypatch.setattr(tw, wrapper,
                        lambda q, *a: calls.append(q.shape[2]) or real(q, *a))
    cfg = PipelineConfig.from_dict({**teng.config.to_dict(),
                                    "attention_impl": impl})
    eng = ASREngine(cfg, device="cpu", model=teng.model, vocab=teng.vocab)
    layers = eng.model_cfg.num_hidden_layers
    for dur in (2.0, 4.0):
        chunks = split_audio(_int16_exact_call(dur), 16000, "c.wav", 4.0,
                             1.0)
        (batch,) = chunk_batch(chunks, eng.bucket_samples)
        buf, lengths = eng._prepare_fused_buffer(batch, 1)
        del calls[:]
        _, mask, _ = eng._fused(torch.from_numpy(buf),
                                torch.from_numpy(lengths), batch.bucket_len)
        assert calls == [mask.shape[1]] * layers, (dur, calls)


def test_transcribe_chunks_row_contract(engines):
    jeng, teng = engines
    call = _int16_exact_call(9.0)
    rows = teng.transcribe_chunks(split_audio(call, 16000, "c.wav", 4.0,
                                              1.0))
    jrows = jeng.transcribe_chunks(split_audio(call, 16000, "c.wav", 4.0,
                                               1.0))
    assert len(rows) == len(jrows) == 3
    for r, j in zip(rows, jrows):
        assert set(r) == set(j)
        assert r["error"] == j["error"] == ""
        assert (r["file_name"], r["chunk_idx"]) == (j["file_name"],
                                                    j["chunk_idx"])
        scale = np.maximum(np.abs(j["agent_acoustic_features"]), 1.0)
        np.testing.assert_allclose(r["agent_acoustic_features"] / scale,
                                   j["agent_acoustic_features"] / scale,
                                   atol=FEAT_ATOL)


def test_partial_batch_padding_does_not_change_results(engines):
    """One chunk alone (a 1-chunk tail batch) gives the same row as the
    same audio as chunk 0 of a 3-chunk batch."""
    _, teng = engines
    call = _int16_exact_call(9.0)
    one = teng.transcribe_chunks(split_audio(call[:, :16000 * 4], 16000,
                                             "c.wav", 4.0, 1.0))
    three = teng.transcribe_chunks(split_audio(call, 16000, "c.wav", 4.0,
                                               1.0))
    assert len(one) == 1 and one[0]["error"] == ""
    for key in ("transcription_chunk", "agent_transcription",
                "client_transcription"):
        assert one[0][key] == three[0][key]
    np.testing.assert_allclose(one[0]["client_acoustic_features"],
                               three[0]["client_acoustic_features"],
                               atol=1e-5, rtol=1e-5)


def test_warmup_dispatches_and_counts(engines):
    _, teng = engines
    before = teng.dispatches
    n = teng.warmup()
    # full (4 chunks), tail 1, tail 2 at the top bucket, minus shapes
    # the other tests already ran
    assert teng.dispatches - before == n
    assert teng.warmup() == 0
    assert {(64000, 4), (64000, 1), (64000, 2)} <= teng._warmed


def test_unported_configuration_raises(engines):
    """int8 now builds an engine whose encoder is W8A8 (the given model
    untouched; tests/test_torch_quant.py holds it against JAX); an
    unknown quantization mode still raises. The unfused path
    (``fuse_acoustic_features: false``) now runs the three views through
    the mono-rows program: its ids equal the JAX ``_device_fn``'s off
    near-ties, and its rows carry no acoustic features."""
    cfg = PipelineConfig(chunk_duration_sec=4.0,
                         length_buckets_sec=(2.0, 4.0))
    tiny = tw.build_synthetic(tw.W2VBertConfig(vocab_size=8, **KW),
                              torch.device("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ASREngine(cfg, device="cuda", model=tiny)
    int8 = ASREngine(PipelineConfig.from_dict({**cfg.to_dict(),
                                               "quantization": "int8"}),
                     device="cpu", model=tiny)
    assert int8.quantization == "int8" and int8.model is not tiny
    assert type(int8.model.layers[0].ffn1.intermediate_dense).__name__ == \
        "QuantLinear"
    assert type(tiny.layers[0].ffn1.intermediate_dense).__name__ == "Linear"
    with pytest.raises(ValueError, match="quantization"):
        ASREngine(PipelineConfig.from_dict({**cfg.to_dict(),
                                            "quantization": "int4"}),
                  device="cpu", model=tiny)
    from audio_processor_tpu.dsp.fbank import log_mel_frontend
    from audio_processor_tpu.pipeline.asr_engine import (
        ASREngine as JaxEngine, _pad_seq_to_128,
    )

    jeng, teng = engines
    unfused = PipelineConfig.from_dict({**teng.config.to_dict(),
                                        "fuse_acoustic_features": False})
    ueng = ASREngine(unfused, device="cpu", model=teng.model,
                     vocab=teng.vocab)
    jueng = JaxEngine(jconfig.PipelineConfig.from_dict(unfused.to_dict()),
                      params=jeng.params, model_cfg=jeng.model_cfg,
                      vocab=jeng.vocab)
    chunks = split_audio(_int16_exact_call(9.0), 16000, "c.wav", 4.0, 1.0)
    (batch,) = chunk_batch(chunks, ueng.bucket_samples)
    rows, lengths = ueng._prepare_rows(batch)
    assert rows.shape == (ueng.device_batch, batch.bucket_len)
    ids, mask = (t.numpy() for t in ueng._mono(
        torch.from_numpy(rows), torch.from_numpy(lengths), beam=False))
    jids, jmask = (np.asarray(a) for a in jueng._device_fn(
        batch.bucket_len)(jueng.params, rows, lengths))
    np.testing.assert_array_equal(mask, jmask)
    real = slice(0, 3 * len(batch))
    feats, fmask = _pad_seq_to_128(*log_mel_frontend(rows, lengths))
    logits = np.asarray(jw.forward(jeng.params, jeng.model_cfg, feats,
                                   fmask))[real]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN
    assert clear[jmask[real]].mean() > 0.5
    np.testing.assert_array_equal(ids[real][clear], jids[real][clear])
    (row,) = ueng.transcribe_chunks(chunks[:1])
    assert row["error"] == "" and "agent_acoustic_features" not in row
    flash = PipelineConfig.from_dict({**cfg.to_dict(),
                                      "attention_impl": "flash"})
    assert ASREngine(flash, device="cpu",
                     model=tiny).attention_impl == "flash"


class _StubEvent:
    """Stands in for a device batch's CUDA event; logs each wait."""

    def __init__(self, log, k):
        self.log, self.k = log, k

    def synchronize(self):
        self.log.append(("wait", self.k))


def _one_chunk_engine(teng, fused=True):
    cfg = PipelineConfig.from_dict({**teng.config.to_dict(),
                                    "chunk_batch_size": 1,
                                    "fuse_acoustic_features": fused})
    return ASREngine(cfg, device="cpu", model=teng.model, vocab=teng.vocab)


@pytest.mark.parametrize("fused", [True, False])
def test_pace_keeps_one_batch_queued_behind_the_running_one(engines,
                                                            monkeypatch,
                                                            fused):
    """With events (stubs), dispatch_chunks enqueues device batch k only
    after it has waited on batch k-2's event, and never waits on batch
    k-1's; k counts across calls on one engine. Fetches are not run, so
    every wait logged is the pace's."""
    _, teng = engines
    eng = _one_chunk_engine(teng, fused)
    log = []
    monkeypatch.setattr(eng, "_done_events", lambda: [_StubEvent(
        log, sum(1 for e in log if e[0] == "run") - 1)])
    name = "_run_fused" if fused else "_mono"
    real = getattr(eng, name)

    def run(*a, **kw):
        log.append(("run", None))
        return real(*a, **kw)

    monkeypatch.setattr(eng, name, run)
    call = _int16_exact_call(9.0)
    with profiler.recording_spans():
        seen = {s.id for s in profiler.spans()}
        for _ in range(2):
            eng.dispatch_chunks(split_audio(call, 16000, "c.wav", 4.0, 1.0))
        new = [s for s in profiler.spans() if s.id not in seen]
    runs = [i for i, e in enumerate(log) if e[0] == "run"]
    assert len(runs) == 6, log
    for k, at in enumerate(runs):
        waited = [e[1] for e in log[:at] if e[0] == "wait"]
        assert waited == list(range(k - 1)), (k, log)
    assert sum(1 for s in new if s.name == "asr_engine.pace") == 4
    if fused:
        parents = {s.id: s.name for s in new}
        assert {parents.get(s.parent) for s in new
                if s.name == "asr_engine.pace"} == {"asr_engine.dispatch"}


def test_no_events_no_pace_on_the_cpu(engines):
    """A CPU engine records no events, so neither its pace nor its fetch
    ever waits, whatever the number of device batches."""
    _, teng = engines
    eng = _one_chunk_engine(teng)
    assert eng._done_events() is None
    call = _int16_exact_call(9.0)
    with profiler.recording_spans():
        seen = {s.id for s in profiler.spans()}
        for _ in range(2):
            rows = eng.transcribe_chunks(split_audio(call, 16000, "c.wav",
                                                     4.0, 1.0))
            assert [r["error"] for r in rows] == [""] * 3
        new = [s.name for s in profiler.spans() if s.id not in seen]
    assert new.count("asr_engine.dispatch") == 6
    assert "asr_engine.pace" not in new and len(eng._queued) == 0
