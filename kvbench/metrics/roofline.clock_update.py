"""roofline.clock_update: B1's share of its roofline.  The bound time of
every call of the tracker update's entry
(``kernels/clock_update/ops.clock_update``), from its shapes, over the
device time of every operation launched inside the range the benchmark
puts around that entry."""
from kvbench import kernel_bytes

NAME = "roofline.clock_update"


def keep(state, keys, locs, valid):
    return keys, valid, int(state[0].shape[0])


WRAP = (("repro_torch.kernels.clock_update.ops", "clock_update", keep),)


def read(run):
    calls = run.spans.kept.get(NAME)
    dev_s = run.trace.device_s(f"kvbench.{NAME}") if run.trace else 0.0
    if not calls or dev_s <= 0:
        return None
    bound = sum(kernel_bytes.clock_update(k, v, t) for k, v, t in calls)
    return 100.0 * bound / dev_s
