"""The speech-to-text cell (``harness/batch_s2t.py``) on the CPU at a tiny
size, and the faults its comparison must catch: a self-attention cache
read one position off, cross-attention without the adaptor's padding mask
(both past ``logit_rel_mse``), and the control, whose bfloat16 reference
of the acoustic features in the program's place passes
``feature_err_max``. The sound run beside them is correct. On the card,
``control.py`` reads the control at full size (PERF.md).

    python -m pytest benchmark_torch/tests/test_s2t.py -q
"""

from __future__ import annotations

import importlib
import shutil
import tempfile
import time
from pathlib import Path

import pytest
import torch

import _tiny

CELL = "s2t.calls3m-pcm16k"
# The decoder and vocabulary cut as well as the encoder (_tiny's cut), so
# the CPU runs a cell in seconds.
TINY_DECODER = {"decoder_layers": 2, "decoder_attention_heads": 2,
                "decoder_ffn_dim": 256, "vocab_size": 4096}


def run(seed=7, control=False, overrides=None):
    tmp = Path(tempfile.mkdtemp(prefix="bench-s2t-"))
    try:
        job = _tiny.tiny_job(CELL, tmp, seed=seed, control=control,
                             overrides=overrides)
        job.config = dict(job.config, model=dict(job.config["model"],
                                                 **TINY_DECODER))
        job.t_process = time.perf_counter()
        driver = importlib.import_module(
            f"benchmark_torch.harness.{job.generator.DRIVER}")
        return driver.run(job)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _over(r):
    return {k for k, v in r["checks"].items() if v["value"] > v["limit"]}


def test_a_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


def test_a_cache_read_one_position_off(monkeypatch):
    from audio_processor_tpu_torch.models import seamless_s2t as s2t

    orig = s2t.DecoderLayer.step

    def off_by_one(self, x, k, v, pos, window, bias, *rest):
        return orig(self, x, k, v, pos, window,
                    torch.roll(bias, 1, dims=-1), *rest)

    monkeypatch.setattr(s2t.DecoderLayer, "step", off_by_one)
    r = run()
    assert not r["correct"] and "logit_rel_mse" in _over(r), r["checks"]


def test_cross_attention_without_the_adaptor_mask(monkeypatch):
    from audio_processor_tpu_torch.models import seamless_s2t as s2t

    orig = s2t.TextDecoder.cross_kv

    def unmasked(self, st, enc, enc_mask):
        orig(self, st, enc, torch.ones_like(enc_mask))

    monkeypatch.setattr(s2t.TextDecoder, "cross_kv", unmasked)
    r = run()
    assert not r["correct"] and "logit_rel_mse" in _over(r), r["checks"]


def test_the_control_with_a_bf16_reference_is_not_correct(monkeypatch):
    """The control: the program's int8 path (encoder, adaptor and decoder)
    with the acoustic features computed as a bfloat16 reference would, in
    place of the program's fp32."""
    from audio_processor_tpu_torch.pipeline import asr_engine

    orig = asr_engine.extract_features_batch

    def bf16_features(padded, lengths):
        x = padded.to(torch.bfloat16).float()
        return orig(x, lengths).to(torch.bfloat16).float()

    monkeypatch.setattr(asr_engine, "extract_features_batch", bf16_features)
    r = run(overrides={"quantization": "int8"})
    assert not r["correct"] and "feature_err_max" in _over(r), r["checks"]
