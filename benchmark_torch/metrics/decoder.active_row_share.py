"""decoder.active_row_share: row-steps of the decode loop that emitted a
token (``</s>`` included), as a share (%) of the rows times the steps the
loops ran, over the traced sweep's ``decoder.loop`` spans (attributes
``tokens``, filled when the device batch is fetched, ``rows`` and
``steps``): what running every row to the batch's largest cap, and the
padding rows of tail batches, cost. Layer: text decoder. Source: the
program's spans (counts)."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_program_spans", Path(__file__).with_name("_program_spans.py"))
_ps = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ps)


def read(run):
    loops = [s for s in _ps.spans(run) or () if s.name == "decoder.loop"
             and "tokens" in s.attrs]
    slots = sum(int(s.attrs["rows"]) * int(s.attrs["steps"]) for s in loops)
    if slots <= 0:
        return None
    return 100.0 * sum(int(s.attrs["tokens"]) for s in loops) / slots
