"""kda.prefill_ms_per_call: card milliseconds of the work launched inside
the program's ``topics.kda_prefill`` spans (each KDA layer's chunked
prefill: its projections, conv, gates, the chunkwise form and the state
pass; kernels matched to each span's thread and time by correlation id)
over the calls the traced sweep's ``topics.batch`` spans answered. A
program without the span reads nothing. Layer: topic LM. Source: the
profiler's trace and the program's spans."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_kimi_counts", Path(__file__).with_name("_kimi_counts.py"))
_c = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_c)


def read(run):
    got = _c.device_s(run, "topics.kda_prefill")
    calls = sum(int(s.attrs.get("calls", 0))
                for s in _c.spans(run, "topics.batch"))
    if got is None or calls <= 0 or got[0] <= 0:
        return None
    return 1000.0 * got[0] / calls
