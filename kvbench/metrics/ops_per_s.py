"""ops_per_s: every op completed in the window over the window's
seconds (host clock)."""


def read(run):
    return run.ops / run.seconds
