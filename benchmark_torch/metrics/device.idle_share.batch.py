"""device.idle_share.batch: share (%) of the traced sweep's window in which
no kernel, copy or set ran on the card (1 - union of device intervals /
window). Layer: device. Source: the profiler's trace."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
