"""engine.analysis_s_per_audio_h: host seconds spent inside
``DataProcessor._analysis_stage`` (the device fetch and CTC decoding,
sentiment, CSV / database rows, markers) per hour of call audio it analysed
in the window. Layer: host stages. Source: the benchmark's spans."""


def read(run):
    if run.analysed_audio_s <= 0 or run.rec.count("engine.analysis") == 0:
        return None
    return run.rec.total("engine.analysis") \
        / (run.analysed_audio_s / 3600.0)
