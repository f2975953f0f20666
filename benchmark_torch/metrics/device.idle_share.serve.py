"""device.idle_share.serve: share (%) of the traced part of the serving
window (its first seconds) in which no kernel, copy or set ran on the card.
Layer: device. Source: the profiler's trace."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
