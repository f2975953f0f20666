"""kimi.prefill_mfu: the hybrid topic LM's prefills as a share (%) of the
card's bf16 peak: the operations of the real prompt tokens
(``_kimi_counts.prefill_flops``: every layer's products for each token,
the held experts' expected share of its routed copies, the KDA layers'
chunkwise form over each row's own length, the MLA layers' causal
attention, the head at each row's last position) over the card time of the
work launched inside the traced sweep's ``topics.prefill`` spans times
989 TFLOP/s. Layer: topic LM. Source: the profiler's trace; the counts
from the spans' ``lengths``."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_kimi_counts", Path(__file__).with_name("_kimi_counts.py"))
_c = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_c)


def read(run):
    got = _c.device_s(run, "topics.prefill")
    spans = [s for s in _c.spans(run, "topics.prefill")
             if "lengths" in s.attrs]
    if got is None or got[0] <= 0 or len(spans) != got[1]:
        return None
    m = run.job.config
    flops = sum(_c.prefill_flops(m, s.attrs["lengths"]) for s in spans)
    return 100.0 * flops / (got[0] * _c._counts.BF16_FLOPS)
