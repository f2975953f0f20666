"""``metrics/kda.fused_prefill_share.py`` against synthetic spans with a
known answer, and against a program whose ``topics.kda_prefill`` spans
carry no ``kernel_launches`` (the parent of the change that added it), on
the CPU.

    python -m pytest benchmark_torch/tests/test_fused_prefill_share.py -q
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
        ROOT / "benchmark_torch" / "metrics" / "kda.fused_prefill_share.py",
        "bench_metric_t_kda_fused_prefill_share")
    return reader.read(SimpleNamespace(tracing_window=[10.0, 20.0]))


def test_share_of_the_layers_whose_prefill_ran_as_the_kernel(monkeypatch):
    spans = [_span("topics.kda_prefill", 5.0, layer=0,      # before
                   kernel_launches=0)]
    spans += [_span("topics.kda_prefill", 11.0 + 0.01 * i, layer=i,
                    kernel_launches=1) for i in range(20)]
    spans += [_span("topics.kda_prefill", 12.0, layer=0, kernel_launches=0),
              _span("topics.kda_prefill", 12.5, layer=1, kernel_launches=2),
              _span("topics.prefill", 13.0, kernel_launches=0)]
    assert _read(spans, monkeypatch) == pytest.approx(100.0 * 21 / 22)
    assert _read(spans[1:21], monkeypatch) == pytest.approx(100.0)
    assert _read(spans[21:22], monkeypatch) == pytest.approx(0.0)


def test_a_program_without_the_count_reads_nothing(monkeypatch):
    spans = [_span("topics.kda_prefill", 11.0, layer=0, rows=8, chunks=496),
             _span("topics.prefill", 12.0, rows=8)]
    assert _read(spans, monkeypatch) is None
    assert _read([], monkeypatch) is None
    monkeypatch.delattr(profiler, "spans")
    assert _read(None, monkeypatch) is None
