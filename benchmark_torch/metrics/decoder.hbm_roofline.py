"""decoder.hbm_roofline: the decode loop as a share (%) of its roofline
over the traced sweep: the sum over the loops' positions of the least time
the card could take (the larger of operations over 989 TFLOP/s and bytes
over 3.35 TB/s, counted in ``_s2t_counts.py`` over each real row's own
cache length, adaptor frames and emitted tokens) over the card time of the
work launched inside ``TextDecoder.decode``. Layer: text decoder. Source:
the profiler's trace; the bound from ``_s2t_counts.py``."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_s2t_counts", Path(__file__).with_name("_s2t_counts.py"))
_c = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_c)


def read(run):
    if run.trace is None or not run.traced_dispatches:
        return None
    loop_s, n = run.trace.span_device_s("decoder.loop")
    done = [d for d in run.traced_dispatches if d.get("emitted")]
    if loop_s <= 0 or n != len(run.traced_dispatches) or \
            len(done) != n:
        return None
    m = run.job.config["model"]
    bound = sum(_c.loop_bound_s(m, d["real"], d["emitted"]) for d in done)
    return 100.0 * bound / loop_s
