"""engine.queue_s_per_call: mean, over the calls finished in the traced
sweep (the program's ``engine.call`` spans), of the seconds their file
batch waited for the device worker (``engine.queue.device``: decode end to
``_asr_stage`` start) and for the analysis worker
(``engine.queue.analysis``: device stage end to ``_analysis_stage``
start). Layer: host stages. Source: the program's spans, host clock."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_program_spans", Path(__file__).with_name("_program_spans.py"))
_ps = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ps)


def read(run):
    sp = _ps.spans(run)
    if not sp:
        return None
    waited = {}
    for s in sp:
        if s.name in ("engine.queue.device", "engine.queue.analysis") \
                and s.attrs.get("batch") is not None:
            b = tuple(s.attrs["batch"])
            waited[b] = waited.get(b, 0.0) + (s.t1 - s.t0) / 1e9
    per_call = [waited[tuple(c.attrs["batch"])] for c in sp
                if c.name == "engine.call"
                and tuple(c.attrs.get("batch") or ()) in waited]
    if not per_call:
        return None
    return sum(per_call) / len(per_call)
