"""asr.mfu: model FLOP utilisation of the traced sweep, as a share (%) of
the card's bf16 peak: the operations of the fbank frontend, the encoder and
the CTC head over every real row's valid frames (three rows per chunk),
counted from shapes, over the traced window's length times 989 TFLOP/s.
Layer: the whole step. Source: counted from the dispatched lengths over the
profiler's window."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_counts", Path(__file__).with_name("_counts.py"))
_counts = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_counts)


def read(run):
    if run.trace is None or not run.traced_dispatches or not run.trace.device:
        return None
    flops = sum(3 * _counts.asr_row_flops(run.model, n)
                for d in run.traced_dispatches for n in d["real"])
    return 100.0 * flops / (run.trace.window_s * _counts.BF16_FLOPS)
