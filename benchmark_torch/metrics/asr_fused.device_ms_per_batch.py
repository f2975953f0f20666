"""asr_fused.device_ms_per_batch: device milliseconds of the work launched
inside ``ASREngine._fused`` (fbank frontend, the Wav2Vec2-BERT encoder with
its attention kernel, CTC ids, acoustic features) per device batch of the
traced sweep. Layer: device program. Source: the profiler's trace, kernels
matched to the benchmark's range by correlation id."""


def read(run):
    if run.trace is None:
        return None
    s, n = run.trace.span_device_s("asr_fused")
    if n == 0 or s <= 0:
        return None
    return 1000.0 * s / n
