"""asr_engine.prep_ms_per_batch: mean host milliseconds of one
``ASREngine._prepare_fused_buffer`` call (reflect-padded int16 device
buffer of one device batch) in the window. Layer: ASR engine. Source: the
benchmark's spans."""


def read(run):
    n = run.rec.count("asr_engine.prep")
    if n == 0:
        return None
    return 1000.0 * run.rec.total("asr_engine.prep") / n
