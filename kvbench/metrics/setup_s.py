"""setup_s: process start to the first timed step (kernel build or load,
the store, the load, the op stream, the warm-up)."""


def read(run):
    return run.setup_s
