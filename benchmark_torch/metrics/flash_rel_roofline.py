"""flash_rel_roofline: the relative-key attention kernel
(``csrc/flash_rel_attention.cu``) as a share (%) of its roofline over the
traced sweep: the sum over its launches of the least time the card could
take (the larger of operations over 989 TFLOP/s and bytes over 3.35 TB/s,
both counted over each real row's valid frames, padding rows and padded
frames excluded) over the sum of the kernel's measured times. Layer:
kernels. Source: the profiler's trace; the bound from ``_counts.py``."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "bench_counts", Path(__file__).with_name("_counts.py"))
_counts = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_counts)


def read(run):
    if run.trace is None or not run.traced_dispatches or not run.trace.device:
        return None
    kernel_s, launches = run.trace.kernel_s("flash_rel_kernel")
    layers = run.model["num_hidden_layers"]
    if kernel_s <= 0 or launches != layers * len(run.traced_dispatches):
        return None
    bound = 0.0
    for d in run.traced_dispatches:
        frames = [_counts.encoder_frames(n) for n in d["real"] for _ in "mac"]
        bound += layers * _counts.attention_bound_s(run.model, frames)
    return 100.0 * bound / kernel_s
