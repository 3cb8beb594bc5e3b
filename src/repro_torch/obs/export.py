"""Host-side export of the device-resident ``ObsState`` (the JAX package's
``obs/export.py``).

Everything here runs at segment boundaries, outside the engine step: one
readback of the whole (small, fixed-size) state, then numpy turns it into
dicts, rank-interpolated p50/p99/p999 from the log2 histograms, tables of
the timeline and compaction-event rings, and JSON lines.  The numpy
bucket function is a bit-exact mirror of the device one.
"""
from __future__ import annotations

import json
from typing import Iterable, Mapping, Sequence

import numpy as np

from repro_torch.obs.state import (EVENT_KIND_NAMES, KIND_NAMES, N_KINDS,
                                   TRIGGER_NAMES, timeline_fields)

QUANTILES = (0.5, 0.99, 0.999)
QUANTILE_NAMES = {0.5: "p50", 0.99: "p99", 0.999: "p999"}


def bucket_of_us_np(us, n_buckets: int):
    """Numpy mirror of ``state.bucket_of_us``: ceil(log2) read off the
    float32 bit pattern, integer ops only (bit-equal on every input)."""
    us = np.maximum(np.asarray(us, np.float32), np.float32(1e-6))
    bits = np.asarray(us, np.float32).view(np.int32)
    b = (bits >> 23) - 127 + (bits & 0x7FFFFF != 0).astype(np.int32)
    return np.clip(b, 0, n_buckets - 1)


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


def snapshot(obs) -> dict:
    """One readback of an ``ObsState`` -> plain numpy dict.  A stacked
    state (a leading partition axis on every leaf, as
    ``PartitionedDB.obs_snapshot`` passes) is merged: histograms, ring
    positions, event and job counts by summation; the timeline and event
    rings stay per partition, their positions in ``t_pos_per_part`` and
    ``ev_count_per_part`` (arrays of length 1 for one engine)."""
    # copies: on the CPU, .numpy() would share the live (in-place
    # updated) obs tensors
    host = {k: v.detach().cpu().numpy().copy()
            for k, v in obs._asdict().items()}
    hist = host["hist"]
    stacked = hist.ndim == 3
    t_pos = host["t_pos"].reshape(-1)
    ev_count = host["ev_count"].reshape(-1)
    hist_sum = host["hist_sum"]
    ev_jobs = host["ev_jobs"].reshape(-1)
    ev_jobs_b = host["ev_jobs_b"]
    return {
        "hist": hist.sum(axis=0) if stacked else hist,
        "hist_sum": hist_sum.sum(axis=0) if stacked else hist_sum,
        "t_pos": int(t_pos.sum()),
        "ev_count": int(ev_count.sum()),
        "ev_jobs": int(ev_jobs.sum()),
        "t_pos_per_part": t_pos,
        "ev_count_per_part": ev_count,
        "timeline": host["timeline"],
        "ev_step": host["ev_step"],
        "ev_trigger": host["ev_trigger"],
        "ev_score": host["ev_score"],
        "ev_moved": host["ev_moved"],
        "ev_superseded": host["ev_superseded"],
        "ev_io_us": host["ev_io_us"],
        "ev_kind": host["ev_kind"],
        "ev_boundary": host["ev_boundary"],
        "ev_jobs_b": (ev_jobs_b.sum(axis=0) if ev_jobs_b.ndim == 2
                      else ev_jobs_b),
        "n_partitions": hist.shape[0] if stacked else 1,
    }


def hist_delta(after: Mapping, before: Mapping) -> np.ndarray:
    return np.asarray(after["hist"], np.int64) - np.asarray(
        before["hist"], np.int64)


def hist_sum_delta(after: Mapping, before: Mapping) -> np.ndarray:
    return np.asarray(after["hist_sum"], np.float64) - np.asarray(
        before["hist_sum"], np.float64)


def _ring_order(count: int, length: int) -> np.ndarray:
    """Valid indices of a ring with ``count`` writes in all, oldest
    first."""
    if count <= length:
        return np.arange(count)
    start = count % length
    return np.concatenate([np.arange(start, length), np.arange(start)])


def _ring_count(snap: Mapping, per_part: str, total: str, p: int) -> int:
    per = np.asarray(snap.get(per_part, snap[total])).reshape(-1)
    return int(per[p]) if per.size > 1 else int(snap[total])


def events_table(snap: Mapping) -> list:
    """Compaction events, oldest surviving first, as dicts; a partitioned
    snapshot's rings are flattened with a ``partition`` field."""
    ev_step = np.asarray(snap["ev_step"])
    parts = 1 if ev_step.ndim == 1 else ev_step.shape[0]

    def leaf(name, p):
        if name not in snap:            # snapshots older than the field
            return np.zeros_like(leaf("ev_step", p))
        a = np.asarray(snap[name])
        return a[p] if a.ndim > 1 else a

    rows = []
    for p in range(parts):
        step, trig = leaf("ev_step", p), leaf("ev_trigger", p)
        score, moved = leaf("ev_score", p), leaf("ev_moved", p)
        sup, io = leaf("ev_superseded", p), leaf("ev_io_us", p)
        kind, bnd = leaf("ev_kind", p), leaf("ev_boundary", p)
        count = _ring_count(snap, "ev_count_per_part", "ev_count", p)
        for i in _ring_order(count, step.shape[0]):
            rows.append({
                "partition": p,
                "step": int(step[i]),
                "trigger": TRIGGER_NAMES[int(trig[i])],
                "kind": EVENT_KIND_NAMES[int(kind[i])],
                "boundary": int(bnd[i]),
                "msc_score": float(score[i]),
                "moved": int(moved[i]),
                "superseded": int(sup[i]),
                "io_us": float(io[i]),
            })
    return rows


# legacy two-tier names: (per-tier field, tier) with tier None meaning
# the sum over every tier below 0 and -1 the sum over all tiers
_LEGACY = {"hits_fast": ("hits", 0), "fast_reads": ("reads", 0),
           "fast_writes": ("writes", 0), "hits_slow": ("hits", None),
           "slow_reads": ("reads", None), "slow_writes": ("writes", None),
           "comp_reads": ("comp_reads", -1),
           "scan_reads": ("scan_reads", -1)}


def timeline_table(snap: Mapping) -> list:
    """Per-step counter-delta rows, oldest surviving first.  Per-tier
    counters appear expanded ("hits0", "hits1", ...) and under the
    legacy aggregate names ("hits_fast" = tier 0, "hits_slow" = the sum
    of every lower tier, ...)."""
    tl = np.asarray(snap["timeline"])
    if tl.ndim == 2:
        tl = tl[None]
    n_tiers = (tl.shape[-1] - 13) // 6      # width = 13 + 6 * T
    fields = timeline_fields(n_tiers)
    rows = []
    for p in range(tl.shape[0]):
        count = _ring_count(snap, "t_pos_per_part", "t_pos", p)
        for i in _ring_order(count, tl.shape[1]):
            row = {"partition": p}
            row.update({f: int(v) for f, v in zip(fields, tl[p, i])})
            for name, (base, t) in _LEGACY.items():
                vec = [row[f"{base}{j}"] for j in range(n_tiers)]
                row[name] = (vec[0] if t == 0
                             else sum(vec[1:]) if t is None
                             else sum(vec))
            rows.append(row)
    return rows


def to_records(snap: Mapping, meta: Mapping | None = None
               ) -> Iterable[dict]:
    """A snapshot as JSON-able records (one a line in ``write_jsonl``): a
    meta header, one histogram record per op kind seen and the total,
    then the timeline rows and the compaction events."""
    yield {"record": "meta", "t_pos": snap["t_pos"],
           "ev_count": snap["ev_count"],
           "n_partitions": snap.get("n_partitions", 1),
           **dict(meta or {})}
    hist = np.asarray(snap["hist"])
    sums = np.asarray(snap["hist_sum"]) if "hist_sum" in snap else None
    for k in range(N_KINDS):
        if hist[k].sum() == 0:
            continue
        yield {"record": "hist", "kind": KIND_NAMES[k],
               "counts": hist[k].tolist(),
               **quantiles_from_hist(
                   hist[k], sums=None if sums is None else sums[k])}
    yield {"record": "hist", "kind": "total",
           "counts": hist.sum(axis=0).tolist(),
           **quantiles_from_hist(hist, sums=sums)}
    for row in timeline_table(snap):
        yield {"record": "step", **row}
    for row in events_table(snap):
        yield {"record": "compaction", **row}


def write_jsonl(path, snap: Mapping, meta: Mapping | None = None) -> int:
    """Write the snapshot as JSON lines; returns the record count."""
    n = 0
    with open(path, "w") as fh:
        for rec in to_records(snap, meta):
            fh.write(json.dumps(rec) + "\n")
            n += 1
    return n
