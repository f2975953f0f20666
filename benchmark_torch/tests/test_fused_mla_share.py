"""``metrics/topics.fused_mla_share.py`` against synthetic spans with a
known answer, and against a program whose ``topics.graph`` spans carry no
``mla_launches`` (the parent of the change that added it), on the CPU.

    python -m pytest benchmark_torch/tests/test_fused_mla_share.py -q
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


def _read(spans, monkeypatch, layers=27):
    if spans is not None:
        monkeypatch.setattr(profiler, "spans", lambda: list(spans))
    reader = load_module(
        ROOT / "benchmark_torch" / "metrics" / "topics.fused_mla_share.py",
        "bench_metric_t_topics_fused_mla_share")
    job = SimpleNamespace(config={"num_hidden_layers": layers})
    return reader.read(SimpleNamespace(tracing_window=[10.0, 20.0], job=job))


def test_share_of_the_steps_attention_in_the_traced_window(monkeypatch):
    spans = [_span("topics.graph", 5.0, steps=199, mla_launches=0),  # before
             _span("topics.graph", 11.0, steps=199, mla_launches=5373,
                   mode="replay"),
             _span("topics.graph", 12.0, steps=2, mla_launches=54,
                   mode="capture"),
             _span("topics.graph", 13.0, steps=4, mla_launches=54,
                   mode="eager"),               # half of its steps' attention
             _span("topics.decode", 14.0, steps=199)]
    assert _read(spans, monkeypatch) == pytest.approx(
        100.0 * (5373 + 54 + 54) / (27 * 205))
    assert _read(spans[1:3], monkeypatch) == pytest.approx(100.0)


def test_a_program_without_the_count_reads_nothing(monkeypatch):
    spans = [_span("topics.graph", 11.0, steps=199, mode="replay"),
             _span("topics.decode", 12.0, steps=199)]
    assert _read(spans, monkeypatch) is None
    monkeypatch.delattr(profiler, "spans")
    assert _read(None, monkeypatch) is None
