"""read_p95_ms.ycsb-a: the 95th percentile over every get op of the window
that ran with the profiler off, of its step's latency, in the YCSB-A
cells: there a step is a drain one time in ~110 and host-bound
otherwise, and the percentile's spread from run to run (10-13%) is
wider than an end-to-end bound can take."""


def read(run):
    return run.p95_ms("read")
