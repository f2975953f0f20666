"""engine.decode_s_per_audio_h: host seconds spent inside
``DataProcessor._decode_batch`` (native WAV read, decode, resampling,
chunking) per hour of call audio it decoded in the window. Layer: host
stages. Source: the benchmark's spans (host clock)."""


def read(run):
    if run.decoded_audio_s <= 0 or run.rec.count("engine.decode") == 0:
        return None
    return run.rec.total("engine.decode") / (run.decoded_audio_s / 3600.0)
