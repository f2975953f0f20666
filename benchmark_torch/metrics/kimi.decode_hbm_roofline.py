"""kimi.decode_hbm_roofline: the hybrid topic LM's decode loops as a share
(%) of their roofline over the traced sweep: the least time of each loop
(``_kimi_counts.decode_bound_s``: the larger of its operations over 989
TFLOP/s and its bytes over 3.35 TB/s, the bytes being the weights outside
the routed experts once a step, the held experts its rows touched, from
the span's ``experts_touched``, the 7 MLA layers' latent caches up to each
row's position, and the 20 KDA layers' states and conv inputs read and
written each step) over the card time of the work launched inside the
``topics.decode`` spans. Layer: topic LM. Source: the profiler's trace;
the bound from the spans' ``steps``, ``lengths`` and
``experts_touched``."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_kimi_counts", Path(__file__).with_name("_kimi_counts.py"))
_c = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_c)


def read(run):
    got = _c.device_s(run, "topics.decode")
    spans = [s for s in _c.spans(run, "topics.decode")
             if {"lengths", "experts_touched", "steps"} <= set(s.attrs)]
    if got is None or got[0] <= 0 or len(spans) != got[1]:
        return None
    m = run.job.config
    bound = sum(_c.decode_bound_s(m, int(s.attrs["steps"]),
                                  s.attrs["lengths"],
                                  int(s.attrs["experts_touched"]))
                for s in spans if int(s.attrs["steps"]) > 0)
    return 100.0 * bound / got[0]
