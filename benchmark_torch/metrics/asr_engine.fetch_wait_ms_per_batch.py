"""asr_engine.fetch_wait_ms_per_batch: milliseconds the analysis worker
blocked on the card's completion of a device batch before copying its
results (the program's ``asr_engine.fetch_wait`` spans inside
``ASREngine._fetch_pending``), summed over the traced sweep and divided by
the device batches dispatched in it (``asr_engine.dispatch`` spans).
Layer: ASR engine. Source: the program's spans, host clock."""

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
    n = sum(1 for s in sp if s.name == "asr_engine.dispatch")
    waits = [s for s in sp if s.name == "asr_engine.fetch_wait"]
    if n == 0 or not waits:
        return None
    return sum(s.t1 - s.t0 for s in waits) / 1e6 / n
