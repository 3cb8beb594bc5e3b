"""roofline.tier_compact: B3 and B4's share of their roofline.  The bound
time of every call of the drain's row movers
(``kernels/tier_compact/ops.select_gather_rows`` and ``scatter_rows``),
from their shapes, over the device time of every operation launched
inside the ranges the benchmark puts around them."""
import torch

from kvbench import kernel_bytes

NAME = "roofline.tier_compact"


def _row_bytes(pool):
    return int(pool.shape[1]) * pool.element_size()


def _keep_select(fast_pool, slow_pool, src_slow, idx):
    return "select", int(idx.shape[0]), _row_bytes(fast_pool), None


def _keep_scatter(pool, idx, rows, valid):
    return "scatter", int(idx.shape[0]), _row_bytes(pool), valid


WRAP = (("repro_torch.kernels.tier_compact.ops", "select_gather_rows",
         _keep_select),
        ("repro_torch.kernels.tier_compact.ops", "scatter_rows",
         _keep_scatter))


def read(run):
    calls = run.spans.kept.get(NAME)
    dev_s = run.trace.device_s(f"kvbench.{NAME}") if run.trace else 0.0
    if not calls or dev_s <= 0:
        return None
    valid = [v for kind, _, _, v in calls if kind == "scatter"]
    n_valid = iter(torch.stack([v.sum() for v in valid]).tolist()
                   if valid else [])
    bound = 0.0
    for kind, m, rb, _ in calls:
        bound += (kernel_bytes.select_gather_rows(m, rb) if kind == "select"
                  else kernel_bytes.scatter_rows(m, rb, next(n_valid)))
    return 100.0 * bound / dev_s
