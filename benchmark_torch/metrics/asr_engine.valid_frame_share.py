"""asr_engine.valid_frame_share: valid encoder frames of the chunks the
engine dispatched in the window, as a share (%) of the rows it dispatched
times the frames of their length bucket: what bucketing and tail batches
waste in padding. Three rows (mixed, agent, client) per chunk. Layer: ASR
engine batching. Source: counted from the dispatched lengths."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_counts", Path(__file__).with_name("_counts.py"))
_counts = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_counts)


def read(run):
    valid = total = 0
    for d in run.dispatches:
        valid += 3 * sum(_counts.encoder_frames(n) for n in d["real"])
        total += 3 * d["n_dev"] * _counts.encoder_frames(d["bucket"])
    if total == 0:
        return None
    return 100.0 * valid / total
