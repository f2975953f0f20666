"""topics.padded_token_share: tokens the topic LM's prefills ran their
products over beyond the real prompt tokens, as a share (%) of the tokens
run, over the traced sweep's ``topics.prefill`` spans (attributes
``tokens`` and ``padded``). Layer: topic LM. Source: the program's spans
(counts)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_topics_counts", Path(__file__).with_name("_topics_counts.py"))
_c = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_c)


def read(run):
    spans = [s for s in _c.spans(run, "topics.prefill")
             if "padded" in s.attrs]
    padded = sum(int(s.attrs["padded"]) for s in spans)
    if padded <= 0:
        return None
    real = sum(int(s.attrs["tokens"]) for s in spans)
    return 100.0 * (padded - real) / padded
