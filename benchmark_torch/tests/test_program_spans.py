"""The readers of the program's own spans (``metrics/_program_spans.py``
and the six metrics on it) against a synthetic span list and trace with
known answers, on the CPU.

    python -m pytest benchmark_torch/tests/test_program_spans.py -q
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from _tiny import ROOT  # sets sys.path
from audio_processor_tpu_torch.obs import profiler
from benchmark_torch.harness.spec import load_module
from benchmark_torch.harness.trace import Trace

METRICS = ROOT / "benchmark_torch" / "metrics"
HOST_T0 = 5.0          # host seconds at which the trace's window opened
TRACE_T0 = 1000.0      # and its start on the trace's clock (us)
# A thread the profiler did not register: its CUDA records carry
# |int32(low 32 bits of the pthread id)|.
PTHREAD = 0x7F009ABCDEF0
UNREGISTERED = abs((PTHREAD & 0xFFFFFFFF) - (1 << 32))


def _ns(us: float) -> int:
    """Trace microseconds -> host perf_counter ns."""
    return int(round((us - TRACE_T0) * 1e3 + HOST_T0 * 1e9))


_ids = iter(range(1, 1000))


def _span(name, lo, hi, tid=21, pthread=None, **attrs):
    return profiler.Span(name, _ns(lo), _ns(hi), tid,
                         pthread if pthread is not None else tid,
                         next(_ids), None, attrs)


B = (1, 0)
SPANS = [
    _span("engine.persist", 990, 1010, tid=31, batch=B),   # before: out
    _span("engine.sweep", 1000, 2000, tid=1, sweep=1),
    _span("engine.decode", 1000, 1050, tid=11, batch=B),
    _span("engine.queue.device", 1050, 1080, tid=21, batch=B),
    _span("engine.device_stage", 1080, 1400, batch=B),
    _span("asr_engine.prep", 1080, 1090, tid=23, batch=B),
    _span("asr_engine.dispatch", 1090, 1350, batch=B),
    _span("asr_fused", 1095, 1340, batch=B),
    _span("engine.queue.analysis", 1400, 1450, tid=31, batch=B),
    _span("engine.analysis", 1450, 1700, tid=31, batch=B, audio_s=360.0),
    _span("asr_engine.fetch_wait", 1460, 1480, tid=31, batch=B),
    _span("engine.persist", 1600, 1650, tid=31, batch=B, what="csv"),
    _span("engine.call", 1000, 1700, tid=31, batch=B, call="a"),
    _span("engine.call", 1010, 1700, tid=31, batch=B, call="b"),
    _span("asr_engine.dispatch", 1495, 1555, tid=41, pthread=PTHREAD,
          batch=B),
    _span("asr_fused", 1500, 1550, tid=41, pthread=PTHREAD, batch=B),
]


def _ev(cat, name, ts, dur, tid=0, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if args:
        e["args"] = args
    return e


EVENTS = [
    _ev("user_annotation", "bench.window", TRACE_T0, 1000.0, tid=1),
    # busy 1100-1300 and 1500-1600: idle 100 + 200 + 400 us of 1000
    _ev("kernel", "k1", 1100.0, 200.0),
    _ev("kernel", "k2", 1500.0, 100.0),
    # the first asr_fused's thread (registered: its native id)
    _ev("cuda_runtime", "cudaStreamQuery", 1096.0, 1.0, tid=21),
    _ev("cuda_runtime", "cudaLaunchKernel", 1100.0, 1.0, tid=21),
    _ev("cuda_runtime", "cudaLaunchKernel", 1200.0, 1.0, tid=21),
    _ev("cuda_runtime", "cudaLaunchKernelExC", 1300.0, 1.0, tid=21),
    _ev("cuda_driver", "cuLaunchKernel", 1310.0, 1.0, tid=21),
    _ev("cuda_runtime", "cudaLaunchKernel", 1345.0, 1.0, tid=21),  # after
    _ev("cuda_runtime", "cudaLaunchKernel", 1200.0, 1.0, tid=22),  # other
    # the second's thread (unregistered: the pthread id's form)
    _ev("cuda_runtime", "cudaLaunchKernel", 1510.0, 1.0, tid=UNREGISTERED),
    _ev("cuda_runtime", "cudaLaunchKernel", 1520.0, 1.0, tid=UNREGISTERED),
    _ev("cuda_runtime", "cudaMemcpyAsync", 1530.0, 1.0, tid=UNREGISTERED),
    _ev("cuda_runtime", "cudaLaunchKernel", 1520.0, 1.0, tid=99),  # other
]

EXPECTED = {
    "engine.queue_s_per_call": (30 + 50) / 1e6,
    "asr_engine.fetch_wait_ms_per_batch": 0.020 / 2,
    "engine.persist_s_per_audio_h": 50e-6 / (360.0 / 3600.0),
    "asr_fused.launches_per_batch": (4 + 2) / 2,
    # idle 700 us; device stage or analysis open over 20 + 100 + 50 + 100
    "device.idle_share.fill": 100.0 * (700 - 270) / 1000,
    # prep or dispatch open over 20 + 50 + 5
    "device.idle_share.issue": 100.0 * 75 / 1000,
}


def _run(trace=True):
    return SimpleNamespace(
        trace=Trace(EVENTS, (), HOST_T0) if trace else None,
        tracing_window=[HOST_T0, HOST_T0 + 1e-3])


def _reader(name):
    return load_module(METRICS / f"{name}.py",
                       "bench_metric_t_" + name.replace(".", "_"))


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_the_known_answer(name, monkeypatch):
    monkeypatch.setattr(profiler, "spans", lambda: list(SPANS))
    assert _reader(name).read(_run()) == pytest.approx(EXPECTED[name])


def test_fill_and_issue_lie_within_the_idle_share(monkeypatch):
    monkeypatch.setattr(profiler, "spans", lambda: list(SPANS))
    run = _run()
    idle = _reader("device.idle_share.batch").read(run)
    assert idle == pytest.approx(70.0)
    assert _reader("device.idle_share.fill").read(run) + \
        _reader("device.idle_share.issue").read(run) <= idle


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """Without a trace the device readers read nothing and the host
    readers still read the spans; with an empty buffer, or a program
    without ``obs.profiler.spans`` (the parent of the change that added
    them), every reader returns None and none raises."""
    monkeypatch.setattr(profiler, "spans", lambda: list(SPANS))
    for name in EXPECTED:
        got = _reader(name).read(_run(trace=False))
        if name.startswith(("asr_fused.", "device.")):
            assert got is None
        else:
            assert got == pytest.approx(EXPECTED[name])
    monkeypatch.setattr(profiler, "spans", lambda: [])
    for name in EXPECTED:
        assert _reader(name).read(_run()) is None
    monkeypatch.delattr(profiler, "spans")
    for name in EXPECTED:
        assert _reader(name).read(_run()) is None
