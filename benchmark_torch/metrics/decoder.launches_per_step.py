"""decoder.launches_per_step: kernel launches (the ``cudaLaunchKernel*``
and ``cuLaunchKernel*`` records of the profiler's trace) that the thread of
each of the program's ``decoder.loop`` spans made inside it, over the
spans' generated-token steps (attribute ``steps``), in the traced sweep. A
CUDA graph's launch is not one. Layer: text decoder. Source: the
profiler's trace, the program's spans placed on its clock and matched to
its threads by thread id."""

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
    loops = [s for s in _ps.spans(run) or () if s.name == "decoder.loop"]
    steps = sum(int(s.attrs.get("steps", 0)) for s in loops)
    if not loops or steps <= 0:
        return None
    by_tid = {}
    for e in run.trace.launches:
        if e.get("name", "").startswith(LAUNCHES):
            by_tid.setdefault(e["tid"], []).append(float(e["ts"]))
    n = 0
    for s in loops:
        lo, hi = _ps.on_trace(run, s)
        n += sum(1 for tid in _ps.trace_tids(s)
                 for ts in by_tid.get(tid, ()) if lo <= ts <= hi)
    return n / steps
