"""device.idle_share.issue: share (%) of the traced sweep's window in which
no kernel, copy or set ran on the card while one of the program's
``asr_engine.dispatch`` (upload and enqueue of a device batch) or
``asr_engine.prep`` (its host buffer) spans was open: the card waits on
host prep or issue. Layer: device. Source: the profiler's trace, the
program's spans placed on its clock."""

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
    issue = _ps.union(_ps.on_trace(run, s) for s in sp if s.name in (
        "asr_engine.dispatch", "asr_engine.prep"))
    if not issue:
        return None
    return 100.0 * _ps.overlap(_ps.idle(t), issue) / (t.t1 - t.t0)
