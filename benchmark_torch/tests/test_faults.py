"""The comparison that decides ``correct`` catches the faults a cell can
have. Each test skips the harness's look for a card, drives the rest of
a run at a size the CPU holds (``_tiny``), breaks the timed path underneath
and sees ``correct`` come out false; the sound run beside them comes out
true. The cells run on one card and keep no state across steps, so the
faults of training and of the exchange between cards do not apply.

    python -m pytest benchmark_torch/tests -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _tiny

def _cells():
    spec = _tiny.Spec(_tiny.ROOT)
    return [c["name"] for c in spec.bench["workloads"]] + \
        sorted(_tiny.EXTRA_CELLS)


@pytest.mark.parametrize("cell", _cells())
def test_a_sound_run_is_correct(cell):
    r = _tiny.run_tiny(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


def _fails(cell, monkeypatch, owner, attr, fault):
    orig = getattr(owner, attr)

    def broken(*args, **kwargs):
        return fault(orig, *args, **kwargs)

    monkeypatch.setattr(owner, attr, broken)
    r = _tiny.run_tiny(cell)
    assert not r["correct"], r["checks"]
    return {k: v["value"] for k, v in r["checks"].items()
            if v["value"] > v["limit"]}


@pytest.mark.parametrize("cell", _cells())
def test_a_token_altered_where_it_is_produced(cell, monkeypatch):
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine

    def fault(orig, self, *a, **k):
        ids, mask, af = orig(self, *a, **k)
        vocab = self.model_cfg.vocab_size
        return torch.where(mask, (ids + 1) % vocab, ids), mask, af

    failed = _fails(cell, monkeypatch, ASREngine, "_fused", fault)
    assert "served_not_argmax" in failed


@pytest.mark.parametrize("cell", _cells())
def test_half_of_the_batch_left_out(cell, monkeypatch):
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine

    def fault(orig, self, chunks):
        fetch = orig(self, list(chunks)[: len(chunks) // 2])
        return lambda: fetch() + [dict(
            file_name=c.file_name, chunk_idx=c.chunk_idx,
            transcription_chunk="", agent_transcription="",
            client_transcription="", error="dropped")
            for c in list(chunks)[len(chunks) // 2:]]

    failed = _fails(cell, monkeypatch, ASREngine, "dispatch_chunks", fault)
    assert "rows_missing" in failed


@pytest.mark.parametrize("cell", _cells())
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    from audio_processor_tpu_torch.pipeline import asr_engine

    def fault(orig, *a, **k):
        return [t[::-1] + "x" for t in orig(*a, **k)]

    failed = _fails(cell, monkeypatch, asr_engine, "batch_decode", fault)
    assert "text_mismatch" in failed


@pytest.mark.parametrize("cell", _cells())
def test_acoustic_features_altered(cell, monkeypatch):
    from audio_processor_tpu_torch.pipeline.asr_engine import ASREngine

    def fault(orig, self, *a, **k):
        ids, mask, af = orig(self, *a, **k)
        return ids, mask, af * 1.01

    failed = _fails(cell, monkeypatch, ASREngine, "_fused", fault)
    assert "feature_err_max" in failed


def test_text_classifier_altered(monkeypatch):
    from audio_processor_tpu_torch.models.bert import (
        BertForSequenceClassification,
    )

    def fault(orig, self, *a, **k):
        out = orig(self, *a, **k)
        return out + torch.tensor([0.5, 0.0, 0.0, 0.0], device=out.device)

    failed = _fails("prod.calls3m-pcm16k", monkeypatch,
                    BertForSequenceClassification, "forward", fault)
    assert "text_logit_err_max" in failed


def test_acoustic_head_altered(monkeypatch):
    from audio_processor_tpu_torch.models import sklearn_infer

    def fault(orig, *a, **k):
        p = np.asarray(orig(*a, **k))
        return np.roll(p, 1, axis=-1)

    failed = _fails("prod.calls3m-pcm16k", monkeypatch, sklearn_infer,
                    "forest_predict_proba_np", fault)
    assert "head_prob_err_max" in failed


def test_rows_left_unpersisted(monkeypatch):
    from audio_processor_tpu_torch.host.db import DatabaseManager

    calls = {"n": 0}

    def fault(orig, self, data):
        calls["n"] += 1
        if calls["n"] % 2:
            return ""
        return orig(self, data)

    failed = _fails("prod.calls3m-pcm16k", monkeypatch, DatabaseManager,
                    "insert_chunk", fault)
    assert "db_rows_missing" in failed
