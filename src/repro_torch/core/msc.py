"""Multi-tiered Storage Compaction metric (PrismDB §5, Eq. 1).

    MSC = benefit / cost,  benefit = sum_j 1 / (clock_j + 1),
    cost = F * (2 - o) / (1 - p) + 1

``approx_score`` (bucket statistics) is the main-path scorer; with
backend "cuda" it runs as the ``msc_score`` kernel.  Deep boundaries
(more than two tiers) pick a whole run with ``select_boundary_run``.  ``precise_score``
walks the objects of a range.  Candidate ranges come from power-of-k
sampling with ``jax.random``'s bits (``core.prng``).  The JAX package's
``vmap`` over candidates is a batch dimension here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import mapper, prng, tracker
from repro_torch.core.tiers import TierConfig, TierState, bucket_of
from repro_torch.core.utils import (PADKEY, count_into, fdiv, searchsorted,
                                    segment_in_range, sorted_lookup, take)


class Candidate(NamedTuple):
    lo: torch.Tensor          # i32[k]
    hi: torch.Tensor          # i32[k]
    run_start: torch.Tensor   # i32[k] first run id of window (-1 = synthetic)
    run_span: torch.Tensor    # i32[k] number of runs in window
    t_f: torch.Tensor         # i32[k] slow objects in window


def bucket_clock_hist(state: TierState, cfg: TierConfig) -> torch.Tensor:
    """int32[B, 4]: clock histogram of tracked fast-tier keys per bucket."""
    trk = state.tracker
    ok = (trk.keys >= 0) & (trk.loc == tracker.LOC_FAST)
    b = bucket_of(cfg, trk.keys.clamp(min=0))
    idx = torch.where(ok, b * 4 + trk.clock.to(torch.int64),
                      cfg.n_buckets * 4)
    flat = count_into(idx, cfg.n_buckets * 4 + 1)[:-1]
    return flat.view(cfg.n_buckets, 4).to(torch.int32)


def candidate_ranges(state: TierState, cfg: TierConfig,
                     key: torch.Tensor) -> Candidate:
    """Power-of-k candidate windows over run ownership ranges (or
    bucket-aligned synthetic ranges while no run exists)."""
    k, r = cfg.power_k, cfg.max_runs
    dev = state.keys[0].device
    i32 = torch.int32
    run_active, run_lo = state.dir_active[0], state.dir_lo[0]
    n_active = run_active.sum(dtype=i32)
    ar = torch.arange(r, dtype=torch.int64, device=dev)

    lo_key = torch.where(run_active, run_lo, PADKEY)
    order = torch.argsort(lo_key, stable=True)
    pos = prng.randint(key, (k,), 0, n_active.clamp(min=1))
    span = n_active.clamp(min=1).clamp(max=cfg.range_fanout_i)
    pos = torch.minimum(pos, (n_active - span).clamp(min=0)).to(torch.int64)
    first = order[pos.clamp(0, r - 1)]
    ordered_lo = lo_key[order]
    own_lo_all = torch.where(ar == 0, 0, ordered_lo)
    nxt = torch.cat([ordered_lo[1:],
                     torch.full((1,), PADKEY, dtype=i32, device=dev)])
    own_hi_all = torch.where(ar == n_active - 1, cfg.key_space,
                             nxt.clamp(max=cfg.key_space))
    lo_run = own_lo_all[pos.clamp(0, r - 1)]
    hi_run = own_hi_all[(pos + span - 1).clamp(0, r - 1)]
    win = (ar[None, :] >= pos[:, None]) & (ar[None, :] < (pos + span)[:, None])
    counts_by_order = state.dir_count[0][order]
    tf_run = torch.where(win, counts_by_order[None, :], 0).sum(
        1, dtype=i32)

    # synthetic candidates (bootstrap)
    b_width = max(cfg.key_space // cfg.n_buckets, 1)
    total_fast = state.bucket_fast.sum(dtype=i32).clamp(min=1)
    per_bucket = fdiv(total_fast.to(torch.float32), cfg.n_buckets)
    span_b = fdiv(cfg.run_size, per_bucket.clamp(min=1e-6)).to(i32).clamp(
        1, cfg.n_buckets)
    start_b = prng.randint(prng.fold_in(key, 1), (k,), 0, cfg.n_buckets,
                           device=dev)
    start_b = torch.minimum(start_b, (cfg.n_buckets - span_b).clamp(min=0))
    lo_syn = start_b * b_width
    hi_syn = ((start_b + span_b) * b_width).clamp(max=cfg.key_space)

    use_runs = n_active > 0
    w = torch.where
    return Candidate(
        lo=w(use_runs, lo_run, lo_syn).to(i32),
        hi=w(use_runs, hi_run, hi_syn).to(i32),
        run_start=w(use_runs, first, -1).to(i32),
        run_span=(w(use_runs, span, 0) * torch.ones(k, dtype=i32,
                                                    device=dev)).to(i32),
        t_f=w(use_runs, tf_run, 0).to(i32))


def dot4(h: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``h @ v`` for h [B, 4], summed left to right."""
    return ((h[:, 0] * v[0] + h[:, 1] * v[1]) + h[:, 2] * v[2]) \
        + h[:, 3] * v[3]


def _msc(benefit, t_n, t_f, p, o):
    p = p.clamp(0.0, 0.999)
    o = o.clamp(0.0, 1.0)
    f = t_f / t_n.clamp(min=1.0)
    cost = f * (2.0 - o) / (1.0 - p) + 1.0
    return torch.where(t_n > 0, benefit / cost, torch.zeros_like(benefit))


def approx_score(state: TierState, cfg: TierConfig, lo: torch.Tensor,
                 hi: torch.Tensor, t_f: torch.Tensor, bhist: torch.Tensor,
                 probs: torch.Tensor) -> torch.Tensor:
    """Eq. 1 from bucket statistics for K candidates at once (f32[K])."""
    f32 = torch.float32
    b_width = max(cfg.key_space // cfg.n_buckets, 1)
    edges_lo = torch.arange(cfg.n_buckets, dtype=torch.int32,
                            device=lo.device) * b_width
    edges_hi = edges_lo + b_width
    inter = (torch.minimum(edges_hi[None, :], hi[:, None])
             - torch.maximum(edges_lo[None, :], lo[:, None])).to(f32)
    w = fdiv(inter, float(b_width)).clamp(0.0, 1.0)          # [K, B]

    nf = state.bucket_fast.to(f32)
    ns = state.bucket_slow.to(f32)
    ov = state.bucket_overlap.to(f32)
    h = bhist.to(f32)
    tracked_fast = h.sum(1)
    untracked = (nf - tracked_fast).clamp(min=0.0)
    inv = fdiv(1.0, torch.arange(4, dtype=f32, device=lo.device) + 1.0)
    hinv, hprob = dot4(h, inv), dot4(h, probs)
    benefit = (w * (hinv + untracked)).sum(1)
    t_n = (w * nf).sum(1)
    pinned = (w * hprob).sum(1)
    p = pinned / t_n.clamp(min=1.0)
    tf_est = torch.maximum((w * ns).sum(1), t_f.to(f32))
    o = (w * ov).sum(1) / tf_est.clamp(min=1.0)
    return _msc(benefit, t_n, tf_est, p, o)


def precise_score(state: TierState, cfg: TierConfig, lo: torch.Tensor,
                  hi: torch.Tensor, t_f: torch.Tensor, probs: torch.Tensor,
                  cap_fast: int, cap_slow: int) -> torch.Tensor:
    """Exact Eq. 1 for one range: per-object tracker + index walks."""
    f32 = torch.float32
    fidx_k, fidx_s = state.idx_keys[0], state.idx_slots[0]
    pos, m = segment_in_range(fidx_k, lo, hi, cap_fast)
    fkeys = torch.where(m, fidx_k[pos], PADKEY)
    clock, tracked = tracker.lookup_clock(state.tracker, fkeys)
    cold = torch.where(m, mapper.coldness_from_clock(clock, tracked), 0.0)
    benefit = cold.sum()
    t_n = (searchsorted(fidx_k, hi) - searchsorted(fidx_k, lo)).to(f32)
    pin_p = torch.where(m, probs[clock.long().clamp(0, 3)]
                        * tracked.to(f32), 0.0)
    p = pin_p.sum() / m.to(f32).sum().clamp(min=1.0)
    spos, sm = segment_in_range(state.idx_keys[1], lo, hi, cap_slow)
    skeys = torch.where(sm, state.idx_keys[1][spos], PADKEY)
    _, in_fast = sorted_lookup(fidx_k, fidx_s, skeys)
    o = (in_fast & sm).to(f32).sum() / t_f.to(f32).clamp(min=1.0)
    return _msc(benefit, t_n, t_f.to(f32), p, o)


def min_overlap_score(state: TierState, cfg: TierConfig, lo: torch.Tensor,
                      hi: torch.Tensor, t_f: torch.Tensor) -> torch.Tensor:
    """RocksDB kMinOverlappingRatio analogue (f32[K])."""
    fidx_k = state.idx_keys[0]
    t_n = (searchsorted(fidx_k, hi) - searchsorted(fidx_k, lo)).to(
        torch.float32)
    f = t_f.to(torch.float32) / t_n.clamp(min=1.0)
    return torch.where(t_n > 0, fdiv(1.0, f + 1.0), torch.zeros_like(f))


# (TierConfig, device) pairs whose msc_score arguments have been checked
_KERNEL_ARGS_CHECKED: set = set()


def select_range(state: TierState, cfg: TierConfig, key: torch.Tensor,
                 precise: bool = False, cap_fast: int | None = None,
                 cap_slow: int | None = None, selection: str = "msc",
                 backend: str = "reference"
                 ) -> tuple[Candidate, torch.Tensor, torch.Tensor]:
    """Score k power-of-k candidates; returns (candidates, scores, best).
    ``backend`` routes approx-MSC scoring through the msc_score kernel,
    which also picks ``best``: one launch, no ``argmax``."""
    cand = candidate_ranges(state, cfg, key)
    hist = tracker.clock_histogram(state.tracker)
    probs = mapper.pin_probabilities(hist, cfg.pin_threshold)
    if selection == "min_overlap":
        scores = min_overlap_score(state, cfg, cand.lo, cand.hi, cand.t_f)
    elif precise:
        cf = cap_fast or 2 * cfg.run_size
        cs = cap_slow or 2 * cfg.run_size * max(cfg.range_fanout_i, 1)
        scores = torch.stack([
            precise_score(state, cfg, cand.lo[i], cand.hi[i], cand.t_f[i],
                          probs, cf, cs) for i in range(cfg.power_k)])
    elif backend != "reference":
        from repro_torch.kernels.msc_score.ops import score_candidates
        # TierState and TierConfig fix these arguments' devices, dtypes and
        # shapes: they are checked on a config's first compaction only
        checked = (cfg, cand.lo.device)
        scores, best = score_candidates(
            cand.lo, cand.hi, cand.t_f, state.bucket_fast, state.bucket_slow,
            state.bucket_overlap, bucket_clock_hist(state, cfg), probs,
            bucket_width=max(cfg.key_space // cfg.n_buckets, 1),
            backend=backend, check=checked not in _KERNEL_ARGS_CHECKED)
        _KERNEL_ARGS_CHECKED.add(checked)
        return cand, scores, best
    else:
        bhist = bucket_clock_hist(state, cfg)
        scores = approx_score(state, cfg, cand.lo, cand.hi, cand.t_f, bhist,
                              probs)
    return cand, scores, torch.argmax(scores)


# ------------------------------------------------- deep-boundary selection

def select_boundary_run(state: TierState, cfg: TierConfig, boundary: int,
                        cost=None) -> tuple:
    """Pick the tier-``boundary`` run to migrate down across the
    ``boundary`` -> ``boundary + 1`` boundary (``boundary >= 1``).

    Below the slab tier there is no popularity signal, so the score is
    MSC's benefit/cost core priced with this boundary's coefficients:

        score_j = rows_freed_j / (io_us_j + 1)
        io_us_j = t_u * seq_read(up) + t_l * seq_read(lo)
                  + (t_u + t_l) * seq_write(lo)

    where ``t_l`` sums the counts of every lower run overlapping run j's
    range.  Returns ``(rid, lo, hi, score, overlap_mask)`` as 0-d device
    tensors (no host read) and a bool[max_runs] over the lower tier's
    directory."""
    from repro_torch.obs.cost import CostModel
    cost = cost if cost is not None else CostModel()
    f32 = torch.float32
    du, dl = boundary - 1, boundary
    up_lo, up_hi = state.dir_lo[du], state.dir_hi[du]
    up_cnt, up_act = state.dir_count[du], state.dir_active[du]
    lo_lo, lo_hi = state.dir_lo[dl], state.dir_hi[dl]
    lo_cnt, lo_act = state.dir_count[dl], state.dir_active[dl]
    # [U, L] overlap of upper run u's range with lower run l's range
    ov = (lo_act[None, :] & (lo_lo[None, :] < up_hi[:, None])
          & (lo_hi[None, :] > up_lo[:, None]))
    t_l = torch.where(ov, lo_cnt[None, :], 0).sum(1, dtype=torch.int32).to(
        f32)
    t_u = up_cnt.to(f32)
    cu, cl = cost.tier(boundary), cost.tier(boundary + 1)
    io = (t_u * cu.seq_read_us_per_obj + t_l * cl.seq_read_us_per_obj
          + (t_u + t_l) * cl.seq_write_us_per_obj)
    score = torch.where(up_act & (up_cnt > 0), t_u / (io + 1.0),
                        torch.full_like(io, float("-inf")))
    rid = torch.argmax(score)
    return (rid, take(up_lo, rid), take(up_hi, rid), take(score, rid),
            take(ov, rid))
