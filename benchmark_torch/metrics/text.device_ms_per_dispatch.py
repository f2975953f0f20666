"""text.device_ms_per_dispatch: device milliseconds of the work launched
inside ``TextSentimentAnalyzer.dispatch_batch`` (tokenised transcripts
through a DarijaBERT-width classifier, fp32) per dispatch of the traced
sweep. Layer: text classifiers. Source: the profiler's trace, kernels
matched to the benchmark's spans by thread and correlation id."""


def read(run):
    if run.trace is None:
        return None
    s, n = run.trace.span_device_s("text.dispatch")
    if n == 0 or s <= 0:
        return None
    return 1000.0 * s / n
