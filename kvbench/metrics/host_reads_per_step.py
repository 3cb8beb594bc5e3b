"""host_reads_per_step: the engine's device-to-host reads
(``engine.HOST_READS``, a counter of the program) over the window's
steps.  Each read drains the launch queue."""


def read(run):
    return run.host_reads / run.n_steps if run.n_steps else None
