"""compactions_per_kop: the store's compaction counter over the window,
per thousand ops."""


def read(run):
    return 1e3 * run.compactions / run.ops if run.ops else None
