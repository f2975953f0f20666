"""decoder.device_ms_per_batch: device milliseconds of the work launched
inside ``TextDecoder.cross_kv`` (every layer's cross-attention K/V of the
adaptor output) and ``TextDecoder.decode`` (the greedy loop, its steps
replayed as CUDA graphs) per device batch of the traced sweep. Layer: text
decoder. Source: the profiler's trace, kernels matched to the benchmark's
spans by thread and correlation id."""


def read(run):
    if run.trace is None:
        return None
    cross_s, _ = run.trace.span_device_s("decoder.cross_kv")
    loop_s, n = run.trace.span_device_s("decoder.loop")
    if n == 0 or loop_s <= 0:
        return None
    return 1000.0 * (cross_s + loop_s) / n
