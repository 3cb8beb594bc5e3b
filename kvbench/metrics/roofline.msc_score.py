"""roofline.msc_score: B2's share of its roofline.  The bound time of
every call of approx-MSC scoring's entry
(``kernels/msc_score/ops.msc_scores``), from its shapes, over the device
time of every operation launched inside the range the benchmark puts
around that entry."""
from kvbench import kernel_bytes

NAME = "roofline.msc_score"


def keep(lo, hi, t_f, bucket_fast, *rest, **kw):
    return int(lo.shape[0]), int(bucket_fast.shape[0])


WRAP = (("repro_torch.kernels.msc_score.ops", "msc_scores", keep),)


def read(run):
    calls = run.spans.kept.get(NAME)
    dev_s = run.trace.device_s(f"kvbench.{NAME}") if run.trace else 0.0
    if not calls or dev_s <= 0:
        return None
    bound = sum(kernel_bytes.msc_score(k, nb) for k, nb in calls)
    return 100.0 * bound / dev_s
