"""``metrics/encoder.fused_ln_share.py`` against synthetic spans with a
known answer, and against a program whose ``encoder.graph`` spans carry
no ``ln_launches`` (the parent of the change that added it), on the CPU.

    python -m pytest benchmark_torch/tests/test_fused_ln_share.py -q
"""

from __future__ import annotations

import itertools
from types import SimpleNamespace

import pytest

from _tiny import ROOT  # sets sys.path
from audio_processor_tpu_torch.obs import profiler
from benchmark_torch.harness.spec import load_module

_ids = itertools.count(1)


def _span(name, t_s, **attrs):
    t = int(t_s * 1e9)
    return profiler.Span(name, t, t + 1000, 1, 1, next(_ids), None, attrs)


def _read(spans, monkeypatch, layers=24):
    if spans is not None:
        monkeypatch.setattr(profiler, "spans", lambda: list(spans))
    reader = load_module(
        ROOT / "benchmark_torch" / "metrics" / "encoder.fused_ln_share.py",
        "bench_metric_t_encoder_fused_ln_share")
    job = SimpleNamespace(config={"model": {"num_hidden_layers": layers}})
    return reader.read(SimpleNamespace(tracing_window=[10.0, 20.0], job=job))


def test_share_of_the_forwards_layer_norms_in_the_traced_window(monkeypatch):
    spans = [_span("encoder.graph", 5.0, mode="replay",
                   ln_launches=0),                             # before
             _span("encoder.graph", 11.0, mode="capture", ln_launches=144),
             _span("encoder.graph", 12.0, mode="replay", ln_launches=144),
             _span("encoder.graph", 13.0, mode="eager",
                   ln_launches=0),                             # fp32
             _span("decoder.graph", 14.0, steps=8, attn_launches=384)]
    assert _read(spans, monkeypatch) == pytest.approx(
        100.0 * (144 + 144) / (6 * 24 * 3))
    assert _read(spans[1:3], monkeypatch) == pytest.approx(100.0)
    assert _read(spans[1:3], monkeypatch, layers=2) == pytest.approx(1200.0)


def test_a_program_without_the_count_reads_nothing(monkeypatch):
    spans = [_span("encoder.graph", 11.0, mode="capture"),
             _span("encoder.graph", 12.0, mode="replay")]
    assert _read(spans, monkeypatch) is None
    monkeypatch.delattr(profiler, "spans")
    assert _read(None, monkeypatch) is None
