"""longest_step_ms: the longest step of the window after the trace's
stop (host clock, submission to the synchronise after it).  A watermark
drain runs inside one step and holds the closed loop's client for all of
it, so this is the longest foreground stall the window saw, which the
tails' percentiles pass over when drains are rare."""


def read(run):
    lat = run.latencies()
    return float(lat.max()) * 1e3 if lat.size else None
