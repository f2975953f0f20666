"""``metrics/encoder.graph_replay_share.py`` against synthetic spans with a
known answer, and against a program that opens no ``encoder.graph`` span
(the parent of the change that added it), on the CPU.

    python -m pytest benchmark_torch/tests/test_graph_replay_share.py -q
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


def _read(spans, monkeypatch):
    if spans is not None:
        monkeypatch.setattr(profiler, "spans", lambda: list(spans))
    reader = load_module(
        ROOT / "benchmark_torch" / "metrics" / "encoder.graph_replay_share.py",
        "bench_metric_t_encoder_graph_replay_share")
    return reader.read(SimpleNamespace(tracing_window=[10.0, 20.0]))


def test_share_of_replays_in_the_traced_window(monkeypatch):
    spans = [_span("encoder.graph", 5.0, mode="capture"),      # before
             _span("encoder.graph", 11.0, mode="replay"),
             _span("encoder.graph", 12.0, mode="replay"),
             _span("encoder.graph", 13.0, mode="replay"),
             _span("encoder.graph", 14.0, mode="eager"),
             _span("asr_fused", 15.0)]
    assert _read(spans, monkeypatch) == pytest.approx(75.0)


def test_a_program_without_the_span_reads_nothing(monkeypatch):
    assert _read([_span("asr_fused", 11.0)], monkeypatch) is None
    monkeypatch.delattr(profiler, "spans")
    assert _read(None, monkeypatch) is None
