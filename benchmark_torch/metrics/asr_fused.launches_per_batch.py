"""asr_fused.launches_per_batch: kernel launches (the
``cudaLaunchKernel*`` and ``cuLaunchKernel*`` records of the profiler's
trace) that the thread of each of the program's ``asr_fused``
spans (``ASREngine._fused``, one device batch on one replica) made inside
the span, per span, over the traced sweep. Other threads' launches and
other runtime calls (the benchmark's ``cudaStreamQuery``, copies) do not
count. Layer: device program. Source: the profiler's trace, spans placed
on its clock and matched to its threads by thread id."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_program_spans", Path(__file__).with_name("_program_spans.py"))
_ps = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ps)

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


def read(run):
    if run.trace is None:
        return None
    sp = _ps.spans(run)
    fused = [s for s in sp or () if s.name == "asr_fused"]
    if not fused:
        return None
    by_tid = {}
    for e in run.trace.launches:
        if e.get("name", "").startswith(LAUNCHES):
            by_tid.setdefault(e["tid"], []).append(float(e["ts"]))
    n = 0
    for s in fused:
        lo, hi = _ps.on_trace(run, s)
        n += sum(1 for tid in _ps.trace_tids(s)
                 for ts in by_tid.get(tid, ()) if lo <= ts <= hi)
    if n == 0:
        return None
    return n / len(fused)
