"""Host-side export of the device-resident ``ObsState``: one readback,
then numpy -- rank-interpolated p50/p99/p999 from the log2 histograms
(the JAX package's ``obs/export.py``)."""
from __future__ import annotations

from typing import Sequence

import numpy as np

QUANTILES = (0.5, 0.99, 0.999)
QUANTILE_NAMES = {0.5: "p50", 0.99: "p99", 0.999: "p999"}


def snapshot(obs) -> dict:
    """One readback of the obs state -> plain numpy dict."""
    # a copy: on the CPU, .numpy() would share the live (in-place
    # updated) obs tensors
    host = {k: v.detach().cpu().numpy().copy()
            for k, v in obs._asdict().items()}
    snap = dict(host)
    for k in ("t_pos", "ev_count", "ev_jobs"):
        snap[k] = int(host[k])
    snap["n_partitions"] = 1
    return snap


def bucket_bounds(n_buckets: int):
    """(lo, hi) in us: bucket 0 is (0, 1], bucket b is (2^(b-1), 2^b]."""
    b = np.arange(n_buckets)
    hi = np.exp2(b).astype(np.float64)
    lo = np.where(b == 0, 0.0, np.exp2(b - 1.0))
    return lo, hi


def quantile_from_hist(hist: np.ndarray, q: float,
                       sums: np.ndarray | None = None) -> float:
    """q-quantile of one histogram row: rank ceil(q * N), linear inside
    its bucket, recentred on the bucket's observed mean when ``sums``
    (the per-bucket cost sums) is given."""
    hist = np.asarray(hist, np.int64)
    n = int(hist.sum())
    if n == 0:
        return 0.0
    rank = min(max(int(np.ceil(q * n)), 1), n)
    cum = np.cumsum(hist)
    b = int(np.searchsorted(cum, rank, side="left"))
    lo, hi = bucket_bounds(hist.shape[0])
    before = int(cum[b - 1]) if b > 0 else 0
    frac = (rank - before) / float(hist[b])
    a, z = float(lo[b]), float(hi[b])
    if sums is not None and hist[b] > 0:
        m = float(np.asarray(sums, np.float64)[b]) / float(hist[b])
        m = min(max(m, a), z)
        a, z = max(a, 2.0 * m - z), min(z, 2.0 * m - a)
    return float(a + (z - a) * frac)


def quantiles_from_hist(hist: np.ndarray,
                        qs: Sequence[float] = QUANTILES,
                        sums: np.ndarray | None = None) -> dict:
    """{"p50", "p99", "p999"} for one row or a [kinds, buckets] matrix
    (summed over kinds first)."""
    hist = np.asarray(hist)
    if hist.ndim == 2:
        hist = hist.sum(axis=0)
    if sums is not None:
        sums = np.asarray(sums)
        if sums.ndim == 2:
            sums = sums.sum(axis=0)
    return {QUANTILE_NAMES.get(q, f"p{q}"):
            quantile_from_hist(hist, q, sums) for q in qs}


def hist_delta(after: dict, before: dict) -> np.ndarray:
    return np.asarray(after["hist"], np.int64) - np.asarray(
        before["hist"], np.int64)


def hist_sum_delta(after: dict, before: dict) -> np.ndarray:
    return np.asarray(after["hist_sum"], np.float64) - np.asarray(
        before["hist_sum"], np.float64)
