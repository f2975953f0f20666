"""The control comes out not correct. On the card, ``control.py`` reads it
at each cell's own size (PERF.md records the readings): the program's own
int8 path for the encoder and the text classifiers, and the reference in
bfloat16 (acoustic features, heads) or TF32 (text classifiers) put in the
program's place. Here, at a size the CPU holds, the program runs with its
int8 path and its acoustic features computed from bfloat16 audio and
spectra in place of fp32, and ``correct`` must come out false.

    python -m pytest benchmark_torch/tests -q
"""

from __future__ import annotations

import pytest
import torch

import _tiny


@pytest.mark.parametrize("cell", ["asr.calls3m-pcm16k",
                                  "asr.telephony-ulaw8k"])
def test_the_control_is_not_correct(cell, monkeypatch):
    from audio_processor_tpu_torch.pipeline import asr_engine

    orig = asr_engine.extract_features_batch

    def bf16_features(padded, lengths):
        x = padded.to(torch.bfloat16).float()
        return orig(x, lengths).to(torch.bfloat16).float()

    monkeypatch.setattr(asr_engine, "extract_features_batch", bf16_features)
    r = _tiny.run_tiny(cell, overrides={"quantization": "int8"})
    assert not r["correct"], r["checks"]
    assert r["checks"]["feature_err_max"]["value"] > \
        r["checks"]["feature_err_max"]["limit"]
