"""topics.device_ms_per_call: card milliseconds of the work the topic LM's
prefills and decode loops launched (the program's ``topics.prefill`` and
``topics.decode`` spans, kernels matched to each span's thread and time by
correlation id) over the calls the traced sweep's ``topics.batch`` spans
answered. Layer: topic LM. Source: the profiler's trace and the program's
spans."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_topics_counts", Path(__file__).with_name("_topics_counts.py"))
_c = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_c)


def read(run):
    pre = _c.device_s(run, "topics.prefill")
    dec = _c.device_s(run, "topics.decode")
    calls = sum(int(s.attrs.get("calls", 0))
                for s in _c.spans(run, "topics.batch"))
    if pre is None or dec is None or calls <= 0 or pre[0] + dec[0] <= 0:
        return None
    return 1000.0 * (pre[0] + dec[0]) / calls
