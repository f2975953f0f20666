"""device.idle_share.fill: share (%) of the traced sweep's window in which
no kernel, copy or set ran on the card and none of the program's
``engine.device_stage`` or ``engine.analysis`` spans was open on any
thread: the pipeline waits on decode (the sweep's fill). Layer: device.
Source: the profiler's trace, the program's spans placed on its clock."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_program_spans", Path(__file__).with_name("_program_spans.py"))
_ps = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ps)


def read(run):
    t = run.trace
    sp = _ps.spans(run)
    if t is None or not sp or t.window_s <= 0 or not t.device:
        return None
    stages = _ps.union(_ps.on_trace(run, s) for s in sp if s.name in (
        "engine.device_stage", "engine.analysis"))
    if not stages:
        return None
    idle = _ps.idle(t)
    fill = _ps.length(idle) - _ps.overlap(idle, stages)
    return 100.0 * fill / (t.t1 - t.t0)
