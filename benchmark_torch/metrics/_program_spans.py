"""The program's own spans (``audio_processor_tpu_torch.obs.profiler``) of
the traced sweep, for the metrics that read them, and interval arithmetic
on the trace's clock.

The program records its spans while the benchmark's profiler records (the
traced first sweep of a batch cell). A program that records none (one
without ``obs.profiler.spans``) gives ``None``, and so do the readers.
"""


def spans(run):
    """The program's spans that start inside the traced window (host clock
    in ns), or None."""
    lo, hi = run.tracing_window
    if lo is None or hi is None:
        return None
    try:
        from audio_processor_tpu_torch.obs import profiler

        got = profiler.spans()
    except (ImportError, AttributeError):
        return None
    out = [s for s in got if lo * 1e9 <= s.t0 <= hi * 1e9]
    return out or None


def on_trace(run, s):
    """A span's (start, end) in microseconds of the trace's clock, mapped
    as ``harness/trace.py`` maps the benchmark's own spans."""
    off = run.trace.t0 - run.tracing_window[0] * 1e6
    return s.t0 / 1e3 + off, s.t1 / 1e3 + off


def trace_tids(s):
    """The ``tid`` the trace gives the span's thread: its native id where
    the profiler registered the thread, else the absolute value of the
    pthread id's low 32 bits read as a signed integer (what the profiler's
    CUDA runtime records carry for threads it did not register)."""
    low = s.pthread & 0xFFFFFFFF
    signed = low - (1 << 32) if low >= (1 << 31) else low
    return {s.tid, abs(signed)}


def union(intervals):
    """Merged, sorted intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def idle(trace):
    """Intervals of the traced window in which no kernel, copy or set ran
    on the card (the complement of ``Trace.intervals()``)."""
    gaps, end = [], trace.t0
    for lo, hi in trace.intervals():
        if lo > end:
            gaps.append((end, lo))
        end = max(end, hi)
    if trace.t1 > end:
        gaps.append((end, trace.t1))
    return gaps


def overlap(a, b):
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def length(intervals):
    return sum(hi - lo for lo, hi in intervals)
