"""device_idle_share: the share of the traced window in which no
operation ran on the device (profiler trace; CUPTI's "Command Buffer
Full" is not device work)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
