"""``metrics/decoder.fused_attention_share.py`` against synthetic spans
with a known answer, and against a program whose ``decoder.graph`` spans
carry no ``attn_launches`` (the parent of the change that added it), on
the CPU.

    python -m pytest benchmark_torch/tests/test_fused_attention_share.py -q
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
        ROOT / "benchmark_torch" / "metrics"
        / "decoder.fused_attention_share.py",
        "bench_metric_t_decoder_fused_attention_share")
    job = SimpleNamespace(config={"model": {"decoder_layers": layers}})
    return reader.read(SimpleNamespace(tracing_window=[10.0, 20.0], job=job))


def test_share_of_the_steps_attention_in_the_traced_window(monkeypatch):
    spans = [_span("decoder.graph", 5.0, steps=32, attn_launches=0),  # before
             _span("decoder.graph", 11.0, steps=32, attn_launches=1536,
                   mode="capture"),
             _span("decoder.graph", 12.0, steps=40, attn_launches=1920,
                   mode="replay"),
             _span("decoder.graph", 13.0, steps=8, attn_launches=192,
                   mode="eager"),               # half of its steps' attention
             _span("decoder.loop", 14.0, steps=79)]
    assert _read(spans, monkeypatch) == pytest.approx(
        100.0 * (1536 + 1920 + 192) / (48 * 80))
    assert _read(spans[1:3], monkeypatch) == pytest.approx(100.0)


def test_a_program_without_the_count_reads_nothing(monkeypatch):
    spans = [_span("decoder.graph", 11.0, steps=32, mode="replay"),
             _span("decoder.loop", 12.0, steps=32)]
    assert _read(spans, monkeypatch) is None
    monkeypatch.delattr(profiler, "spans")
    assert _read(None, monkeypatch) is None
