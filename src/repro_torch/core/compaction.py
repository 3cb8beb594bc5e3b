"""Compaction engine (PrismDB §4.2, §5.3, §6), run to completion.

One compaction: select a key range (power-of-k + MSC), pin or demote the
range's fast-tier objects, read the overlapping slow-tier run window,
drop superseded run objects, optionally promote hot run objects, merge
the survivors and the demotions into fresh runs (new Bloom filters,
directory entries, incremental index maintenance), update tracker
location bits, bucket statistics and counters.  A port of the JAX
package's ``compact_once``, with its ``Movement`` output (for payload
mirrors and the in-flight carry), the preemptible micro-step drain of
``compaction_quantum > 0`` (``InFlight``, ``drain_quantum``,
``inflight_read``, ``defer_adjust``), and with more than two tiers the
deep run-to-run merges (``compact_boundary``).

Pool-sized tensors (both tiers' keys, values, versions, run ids, the run
directory, the Bloom filters and the tracker's location bits) are written
IN PLACE: ``compact_once`` consumes the state it is given.  Values that
the JAX package reads from the pre-compaction state are gathered before
the first write.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bloom, mapper, msc, prng, tracker
from repro_torch.core.backend import resolve_device
from repro_torch.core.tiers import (Counters, TierConfig, TierState,
                                    bucket_of, fast_occupancy, run_of_keys,
                                    tier_occupancy)
from repro_torch.core.utils import (PADKEY, add_where, alloc_slots, fdiv,
                                    merge_index_update, nonzero_fixed,
                                    searchsorted, segment_in_range,
                                    set_where, sorted_lookup, take)
from repro_torch.kernels.tier_compact.ops import movers


class Movement(NamedTuple):
    """Physical data movement of one compaction, for payload mirrors and
    the in-flight carry.  Static sizes (merged rows: cap_fast + cap_slow;
    promotions: cap_slow), masked by the ``*_valid`` fields; int32 slots,
    -1 where a row is not valid.  ``boundary`` names the tier boundary
    crossed: ``m_src_tier`` is then its upper (== boundary) or lower
    (== boundary + 1) tier, destinations lie in the lower tier; boundary
    0 is the slab merge (0 = fast, 1 = slow)."""
    m_src_tier: torch.Tensor   # i32[capm] source tier per merged write
    m_src_slot: torch.Tensor   # i32[capm] source slot in its tier
    m_dst_slot: torch.Tensor   # i32[capm] destination slow slot
    m_valid: torch.Tensor      # bool[capm]
    p_src_slot: torch.Tensor   # i32[cap_s] promotion source (slow slot)
    p_dst_slot: torch.Tensor   # i32[cap_s] promotion destination
    p_valid: torch.Tensor      # bool[cap_s]
    m_key: torch.Tensor = ()   # i32[capm] merged keys, sorted (PADKEY pad)
    boundary: torch.Tensor = ()  # i32: the tier boundary crossed


def _tset(t: tuple, i: int, v) -> tuple:
    return t[:i] + (v,) + t[i + 1:]


def _vec(n: int, dev, at: dict) -> torch.Tensor:
    """int32[n]: ``at[i]`` (0-d int32 tensors) at entry i, zeros elsewhere
    (the JAX package's ``zeros(n).at[i].set(v)``)."""
    z = torch.zeros((), dtype=torch.int32, device=dev)
    return torch.stack([at.get(i, z) for i in range(n)])


def _set_bool(dst: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor,
              vals: torch.Tensor) -> None:
    """In place: bool ``dst[idx[i]] = vals[i]`` on active lanes with
    distinct targets, as two scalar writes."""
    set_where(dst, mask & vals, idx, True)
    set_where(dst, mask & ~vals, idx, False)


class CompactionStats(NamedTuple):
    selected_lo: torch.Tensor
    selected_hi: torch.Tensor
    score: torch.Tensor
    n_demoted: torch.Tensor
    n_promoted: torch.Tensor
    n_merged: torch.Tensor
    n_superseded: torch.Tensor   # stale slow copies merged away
    n_run_read: torch.Tensor     # slow objects read (whole window, seq I/O)
    n_run_written: torch.Tensor  # slow objects written (new runs, seq I/O)


def compact_once(state: TierState, cfg: TierConfig, key: torch.Tensor,
                 promote: bool = True, precise: bool = False,
                 cap_fast: int | None = None, cap_slow: int | None = None,
                 force_pin_keys: torch.Tensor | None = None,
                 selection: str = "msc", pin_mode: str = "object",
                 backend: str = "reference", with_movement: bool = False):
    """One compaction at the slab/run boundary: ``(state', stats)``, and
    the ``Movement`` third when ``with_movement``.  ``backend`` routes the
    approx-MSC candidate scoring through the msc_score kernel.  With
    more than two tiers, tier-1 tombstone rows are never promoted, and a
    demoted tier-0 tombstone (or a surviving tier-1 tombstone row) whose
    key a deeper tier's Bloom filter may hold rides the merge into tier 1
    as a tombstone row; the rest are dropped."""
    n_tiers = state.n_tiers
    dev = state.keys[0].device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    cnt = lambda m: m.sum(dtype=i32)
    cap_fast = cap_fast or 2 * cfg.run_size
    cap_slow = cap_slow or 2 * cfg.run_size * max(cfg.range_fanout_i, 1)
    r_sel, r_pin, _ = prng.split(key, 3)

    cand, scores, best = msc.select_range(
        state, cfg, r_sel, precise=precise, cap_fast=cap_fast,
        cap_slow=cap_slow, selection=selection, backend=backend)
    lo, hi = take(cand.lo, best), take(cand.hi, best)
    run_start, run_span = take(cand.run_start, best), take(cand.run_span,
                                                          best)

    hist = tracker.clock_histogram(state.tracker)
    # capacity guard: the pin budget leaves headroom below fast capacity
    tracked_total = hist.sum().to(f32).clamp(min=1.0)
    cap_frac = fdiv(0.6 * cfg.fast_slots, tracked_total)
    threshold = torch.minimum(
        torch.full((), cfg.pin_threshold, dtype=f32, device=dev), cap_frac)
    probs = mapper.pin_probabilities(hist, threshold)

    # ---- fast-tier range: pin or demote --------------------------------
    fidx_keys, fidx_slots = state.idx_keys[0], state.idx_slots[0]
    fpos, fm = segment_in_range(fidx_keys, lo, hi, cap_fast)
    fkeys = torch.where(fm, fidx_keys[fpos], PADKEY)
    fslots = torch.where(fm, fidx_slots[fpos], 0).to(i64)
    tomb = state.fast_ver[fslots] < 0
    clock, tracked = tracker.lookup_clock(state.tracker, fkeys)
    if pin_mode == "none":
        pinned = torch.zeros_like(fm)
    elif pin_mode == "file":
        per_obj = probs[clock.to(i64).clamp(0, 3)] * tracked.to(f32)
        avg = torch.where(fm, per_obj, 0.0).sum() \
            / fm.to(f32).sum().clamp(min=1.0)
        pinned = fm & ~tomb & (avg >= 0.5)
    else:
        pinned = mapper.pin_decisions(clock, tracked, probs, r_pin) \
            & fm & ~tomb
    if force_pin_keys is not None:
        pos_f = searchsorted(force_pin_keys, fkeys).clamp(
            0, force_pin_keys.shape[0] - 1)
        pinned = pinned | ((force_pin_keys[pos_f] == fkeys) & fm & ~tomb)
    demote = fm & ~pinned                 # tombstones always leave fast tier
    demote_data = demote & ~tomb          # tombstones carry no payload

    # ---- slow-tier window ----------------------------------------------
    sidx_keys, sidx_slots = state.idx_keys[1], state.idx_slots[1]
    spos, sm = segment_in_range(sidx_keys, lo, hi, cap_slow)
    skeys = torch.where(sm, sidx_keys[spos], PADKEY)
    sslots = torch.where(sm, sidx_slots[spos], 0).to(i64)
    _, in_fast = sorted_lookup(fidx_keys, fidx_slots, skeys)
    superseded = in_fast & sm
    if n_tiers > 2:
        # tier-1 tombstone rows (deep-boundary delete carriers) are not
        # data; the deeper Bloom answers read the pre-compaction filters
        stomb = state.tombs[0][sslots]
        deeper_f = _maybe_deeper(state, cfg, fkeys, below=1)
        deeper_s = _maybe_deeper(state, cfg, skeys, below=1)

    # pre-write gathers (the JAX package reads the pre-compaction pools)
    fast_keys, fast_vals, fast_ver = state.keys[0], state.vals[0], \
        state.fast_ver
    slow_keys, slow_vals, slow_run = state.keys[1], state.vals[1], \
        state.runs[0]
    svals = slow_vals[sslots]
    mvals = torch.cat([fast_vals[fslots], svals])

    # ---- free demoted fast slots, then install promotions --------------
    nf = fast_keys.shape[0]
    set_where(fast_keys, demote, fslots, -1)
    set_where(fast_ver, demote, fslots, 0)
    n_dem_total = cnt(demote)
    sclock, stracked = tracker.lookup_clock(state.tracker, skeys)
    fully_pinned = probs[sclock.to(i64).clamp(0, 3)] >= torch.full(
        (), 0.999, dtype=f32, device=dev)
    if promote:
        promote_want = (sm & ~superseded & stracked & fully_pinned
                        & (sclock >= cfg.promote_min_clock))
    else:
        promote_want = torch.zeros_like(sm)
    if n_tiers > 2:
        promote_want = promote_want & ~stomb
    rank = torch.cumsum(promote_want, 0, dtype=i32) - 1
    promote_want = promote_want & (rank < n_dem_total)
    pro_slots = alloc_slots(fast_keys, promote_want)
    pro_ok = promote_want & (pro_slots >= 0)
    # tensor writes below target alloc_slots' or nonzero_fixed's distinct
    # slots and run ids; the scalar writes may repeat (win_rids)
    set_where(fast_keys, pro_ok, pro_slots, skeys)
    set_where(fast_vals, pro_ok, pro_slots, svals)
    set_where(fast_ver, pro_ok, pro_slots, 1)
    dropf = set_where(torch.zeros(nf, dtype=torch.bool, device=dev), demote,
                      fslots, True)
    fidx_keys, fidx_slots = merge_index_update(
        fidx_keys, fidx_slots, dropf, skeys, pro_slots, pro_ok)

    survive = sm & ~superseded & ~pro_ok

    # ---- merge (sorted; PADKEY sorts to the tail) ----------------------
    if n_tiers > 2:
        tomb_keep = demote & tomb & deeper_f
        survive = survive & (~stomb | deeper_s)
        f_half = demote_data | tomb_keep
        mtomb_half = torch.cat([tomb_keep, stomb & survive])
    else:
        f_half = demote_data
    mkeys = torch.cat([torch.where(f_half, fkeys, PADKEY),
                       torch.where(survive, skeys, PADKEY)])
    order = torch.argsort(mkeys, stable=True)
    mkeys, mvals = mkeys[order], mvals[order]
    mvalid = mkeys != PADKEY
    n_merged = cnt(mvalid)

    # ---- free the window runs' slots -----------------------------------
    r = cfg.max_runs
    fan = cfg.range_fanout_i
    run_active, run_lo, run_hi, run_count = (
        state.dir_active[0], state.dir_lo[0], state.dir_hi[0],
        state.dir_count[0])
    lo_key = torch.where(run_active, run_lo, PADKEY)
    order_runs = torch.argsort(lo_key, stable=True)
    pos_in_order = searchsorted(lo_key[order_runs],
                                take(run_lo, run_start.to(i64).clamp(0, r - 1)))
    ar_fan = torch.arange(fan, dtype=i64, device=dev)
    win_pos = pos_in_order + ar_fan
    win_rids = torch.where(
        (run_start >= 0) & (ar_fan < run_span),
        order_runs[win_pos.clamp(0, r - 1)], r)
    in_window = (slow_run[:, None] == win_rids[None, :]).any(dim=1)
    slow_keys.masked_fill_(in_window, -1)
    slow_run.masked_fill_(in_window, -1)

    # ---- write the merged output as sub-runs of <= run_size ------------
    m_total = mkeys.shape[0]
    n_sub = max(m_total // cfg.run_size, 1) + 1
    mrank = torch.cumsum(mvalid, 0, dtype=i32) - 1
    sub_of = torch.where(mvalid, torch.div(mrank, cfg.run_size,
                                           rounding_mode="floor"),
                         n_sub - 1).to(i64)
    new_slots = alloc_slots(slow_keys, mvalid)
    wrote = mvalid & (new_slots >= 0)
    set_where(slow_keys, wrote, new_slots, mkeys)
    set_where(slow_vals, wrote, new_slots, mvals)
    tombs = state.tombs
    if n_tiers > 2:
        tombs0 = tombs[0].masked_fill_(in_window, False)
        _set_bool(tombs0, wrote, new_slots, mtomb_half[order])
        tombs = _tset(tombs, 0, tombs0)

    all_fan = torch.ones(fan, dtype=torch.bool, device=dev)
    set_where(run_active, all_fan, win_rids, False)
    set_where(run_count, all_fan, win_rids, 0)
    free_rids = nonzero_fixed(~run_active, n_sub, r)
    set_where(slow_run, wrote, new_slots,
              free_rids[sub_of.clamp(0, n_sub - 1)].to(i32))
    sidx_keys, sidx_slots = merge_index_update(
        sidx_keys, sidx_slots, in_window, mkeys, new_slots, wrote)

    # per-sub-run counts and key bounds
    sub_counts = torch.zeros(n_sub, dtype=i32, device=dev).index_add_(
        0, sub_of, wrote.to(i32))
    sub_first = torch.full((n_sub,), PADKEY, dtype=i32,
                           device=dev).scatter_reduce_(
        0, sub_of, torch.where(wrote, mkeys, PADKEY), reduce="amin",
        include_self=True)
    ar_sub = torch.arange(n_sub, dtype=i64, device=dev)
    sub_lo = torch.where(ar_sub == 0, lo, sub_first)
    nxt_first = torch.cat([sub_first[1:],
                           torch.full((1,), PADKEY, dtype=i32, device=dev)])
    sub_hi = torch.minimum(nxt_first, hi)
    sub_ok = sub_counts > 0
    set_where(run_active, sub_ok, free_rids, True)
    set_where(run_lo, sub_ok, free_rids, sub_lo)
    set_where(run_hi, sub_ok, free_rids, sub_hi)
    set_where(run_count, sub_ok, free_rids, sub_counts)
    blooms = state.dir_blooms[0]
    rows = bloom.make_rows(mkeys, sub_of, wrote, n_sub, blooms.shape[1])
    set_where(blooms, sub_ok, free_rids, rows)

    # ---- tracker location bits -----------------------------------------
    trk = tracker.set_location(state.tracker, fkeys, tracker.LOC_SLOW,
                               demote)
    trk = tracker.set_location(trk, skeys, tracker.LOC_FAST, pro_ok)

    # ---- bucket statistics ---------------------------------------------
    nb = cfg.n_buckets
    fb, sb, mb = bucket_of(cfg, fkeys), bucket_of(cfg, skeys), \
        bucket_of(cfg, mkeys)
    bucket_fast, bucket_slow = state.bucket_fast, state.bucket_slow
    add_where(bucket_fast, demote, fb, -1)
    add_where(bucket_fast, pro_ok, sb, 1)
    add_where(bucket_slow, sm, sb, -1)
    add_where(bucket_slow, wrote, mb, 1)
    b_width = max(cfg.key_space // nb, 1)
    edges_lo = torch.arange(nb, dtype=i32, device=dev) * b_width
    cover = fdiv((torch.minimum(edges_lo + b_width, hi)
                  - torch.maximum(edges_lo, lo)).to(f32),
                 float(b_width)).clamp(0.0, 1.0)
    bucket_overlap = (state.bucket_overlap.to(f32) * (1.0 - cover)).to(i32)

    # ---- counters (object units) ---------------------------------------
    t_f = cnt(sm)
    n_dem = cnt(demote_data)
    n_pro = cnt(pro_ok)
    n_sup = cnt(superseded)
    zero = torch.zeros((), dtype=i32, device=dev)
    c = state.ctr
    ctr = c._replace(
        compactions=c.compactions + 1,
        demoted=c.demoted + n_dem,
        promoted=c.promoted + n_pro,
        reads=c.reads + _vec(n_tiers, dev, {0: n_dem, 1: t_f}),
        comp_reads=c.comp_reads + _vec(n_tiers, dev, {1: t_f}),
        writes=c.writes + _vec(n_tiers, dev, {0: n_pro, 1: n_merged}),
        comp_by_boundary=c.comp_by_boundary
        + _vec(n_tiers - 1, dev, {0: torch.ones_like(zero)}),
        rate_limited=c.rate_limited + cnt(mvalid & ~wrote))

    stats = CompactionStats(
        selected_lo=lo, selected_hi=hi, score=take(scores, best),
        n_demoted=n_dem, n_promoted=n_pro, n_merged=n_merged,
        n_superseded=n_sup, n_run_read=t_f, n_run_written=n_merged)
    new_state = state._replace(
        keys=(fast_keys, slow_keys) + state.keys[2:],
        vals=(fast_vals, slow_vals) + state.vals[2:],
        fast_ver=fast_ver, runs=_tset(state.runs, 0, slow_run), tombs=tombs,
        idx_keys=(fidx_keys, sidx_keys) + state.idx_keys[2:],
        idx_slots=(fidx_slots, sidx_slots) + state.idx_slots[2:],
        dir_lo=_tset(state.dir_lo, 0, run_lo),
        dir_hi=_tset(state.dir_hi, 0, run_hi),
        dir_count=_tset(state.dir_count, 0, run_count),
        dir_active=_tset(state.dir_active, 0, run_active),
        dir_blooms=_tset(state.dir_blooms, 0, blooms), tracker=trk,
        bucket_fast=bucket_fast, bucket_slow=bucket_slow,
        bucket_overlap=bucket_overlap, ctr=ctr)
    if not with_movement:
        return new_state, stats
    src_tier = torch.cat([torch.zeros_like(fslots), torch.ones_like(sslots)])
    mv = Movement(
        m_src_tier=src_tier[order].to(i32),
        m_src_slot=torch.cat([fslots, sslots])[order].to(i32),
        m_dst_slot=torch.where(wrote, new_slots, -1).to(i32),
        m_valid=wrote,
        p_src_slot=torch.where(pro_ok, sslots, -1).to(i32),
        p_dst_slot=torch.where(pro_ok, pro_slots, -1).to(i32),
        p_valid=pro_ok, m_key=mkeys.to(i32), boundary=zero.clone())
    return new_state, stats, mv



# ------------------------------------------- preemptible micro-step drain
#
# With ``EngineConfig.compaction_quantum > 0`` the trigger step still
# commits the compaction's logical transition (pools, indexes, run
# directory, counters), so the state is bit-identical for any quantum;
# the physical migration -- the staged Movement rows -- and its modeled
# I/O ride ``InFlight`` and drain at most ``quantum`` merged rows per
# engine step through the tier_compact movers.  A replayed row is copied
# only while its destination still holds the same key and value (the
# idempotence guard), so a drain never changes a value that is visible.


class InFlight(NamedTuple):
    """The un-drained remainder of triggered jobs, and the latest job's
    staged Movement rows (cap-shaped, never pool-shaped).  ``rem_*``
    accumulate over jobs; ``m_*`` describe the LATEST job only: older
    rows are already bit-resident at their destinations."""
    rem_rows: torch.Tensor         # i32: un-drained merged rows (all jobs)
    rem_run_read: torch.Tensor     # i32: un-attributed seq run reads
    rem_run_written: torch.Tensor  # i32: un-attributed seq run writes
    rem_fast_read: torch.Tensor    # i32: un-attributed demotion reads
    rem_fast_write: torch.Tensor   # i32: un-attributed promotion writes
    lo: torch.Tensor               # i32: union of in-flight key ranges
    hi: torch.Tensor
    score: torch.Tensor            # f32: latest job's MSC score
    trigger: torch.Tensor          # i32: latest job's TRIG_* kind
    m_key: torch.Tensor            # i32[capm] merged keys, sorted
    m_src_tier: torch.Tensor       # i32[capm] 0=fast 1=slow
    m_src_slot: torch.Tensor       # i32[capm]
    m_dst_slot: torch.Tensor       # i32[capm] destination slow slot, -1
    m_done: torch.Tensor           # i32: drained merge-row cursor
    m_total: torch.Tensor          # i32: latest job's merged-row count
    boundary: torch.Tensor = ()    # i32: latest job's boundary (0)


def inflight_cap(cfg: TierConfig) -> int:
    """Static staged-row capacity: one compaction's merge working set."""
    return 2 * cfg.run_size + 2 * cfg.run_size * max(cfg.range_fanout_i, 1)


def init_inflight(cfg: TierConfig, device=None) -> InFlight:
    """An empty carry on ``device`` (None: the card; raises without one)."""
    dev = resolve_device(device)
    capm = inflight_cap(cfg)
    z = lambda: torch.zeros((), dtype=torch.int32, device=dev)
    full = lambda v: torch.full((capm,), v, dtype=torch.int32, device=dev)
    return InFlight(
        rem_rows=z(), rem_run_read=z(), rem_run_written=z(),
        rem_fast_read=z(), rem_fast_write=z(), lo=z(), hi=z(),
        score=torch.zeros((), dtype=torch.float32, device=dev), trigger=z(),
        m_key=full(PADKEY), m_src_tier=full(0), m_src_slot=full(0),
        m_dst_slot=full(-1), m_done=z(), m_total=z(), boundary=z())


def stage_inflight(fl: InFlight, stats: CompactionStats, mv: Movement,
                   trigger: int) -> InFlight:
    """Fold one just-committed compaction into the carry.  ``rem_rows``
    grows by at least 1, so a job that merged nothing still drains (and
    logs its commit event) on a later step."""
    active = fl.rem_rows > 0
    return fl._replace(
        rem_rows=fl.rem_rows + stats.n_merged.clamp(min=1),
        rem_run_read=fl.rem_run_read + stats.n_run_read,
        rem_run_written=fl.rem_run_written + stats.n_run_written,
        rem_fast_read=fl.rem_fast_read + stats.n_demoted,
        rem_fast_write=fl.rem_fast_write + stats.n_promoted,
        lo=torch.where(active, torch.minimum(fl.lo, stats.selected_lo),
                       stats.selected_lo),
        hi=torch.where(active, torch.maximum(fl.hi, stats.selected_hi),
                       stats.selected_hi),
        score=stats.score.to(torch.float32),
        trigger=torch.full_like(fl.trigger, trigger),
        m_key=mv.m_key, m_src_tier=mv.m_src_tier, m_src_slot=mv.m_src_slot,
        m_dst_slot=mv.m_dst_slot, m_done=torch.zeros_like(fl.m_done),
        m_total=stats.n_merged.to(torch.int32),
        boundary=torch.zeros_like(fl.m_done))


def drain_quantum(state: TierState, fl: InFlight, quantum: int, *,
                  backend: str = "reference"
                  ) -> tuple[TierState, InFlight, tuple, torch.Tensor]:
    """Drain at most ``quantum`` merged rows of the in-flight migration.

    Attribution: ``k = min(quantum, rem_rows)`` rows come off the backlog
    with a proportional share of each modeled-I/O category (the final
    drain takes every remainder).  Replay: the window
    ``[m_done, m_done + k)`` of the latest job's staged rows is gathered
    through B3 (``select_gather_rows``) and scattered by B4
    (``scatter_rows``) to its destination slow slots, in place, where the
    destination still holds the row's key and value bits (compared as
    floats, as the JAX package does).

    No host read: the window start is index arithmetic on the device, and
    with nothing in flight ``k`` is 0, every row is masked off and no
    leaf changes, so the engine runs this branchless on every step.
    Returns ``(state', fl', (run_read, run_written, fast_read,
    fast_write), k)``."""
    f32 = torch.float32
    k = fl.rem_rows.clamp(max=int(quantum))
    rem_after = fl.rem_rows - k
    finish = (fl.rem_rows > 0) & (rem_after == 0)
    denom = fl.rem_rows.to(f32).clamp(min=1.0)

    def share(rem: torch.Tensor) -> torch.Tensor:
        prop = torch.floor(rem.to(f32) * k.to(f32) / denom).to(torch.int32)
        return torch.where(finish, rem, torch.minimum(prop, rem))

    d_rr, d_rw = share(fl.rem_run_read), share(fl.rem_run_written)
    d_fr, d_fw = share(fl.rem_fast_read), share(fl.rem_fast_write)

    # ---- physical replay of the staged window [m_done, m_done + k) -----
    capm = fl.m_key.shape[0]
    q = min(max(int(quantum), 1), capm)
    start = fl.m_done.clamp(0, capm - q)
    pos = start.to(torch.int64) + torch.arange(q, dtype=torch.int64,
                                               device=start.device)
    keys, tier_src = fl.m_key[pos], fl.m_src_tier[pos]
    src, dst = fl.m_src_slot[pos], fl.m_dst_slot[pos]
    in_q = (pos >= fl.m_done) & (pos < fl.m_done + k) & (pos < fl.m_total)
    fast_vals, slow_vals = state.vals[0], state.vals[1]
    slow_keys = state.keys[1]
    nf, ns = state.keys[0].shape[0], slow_keys.shape[0]
    src_slow = tier_src != 0
    idx = torch.where(src_slow, src.clamp(0, ns - 1), src.clamp(0, nf - 1))
    sel, _, scatter = movers(backend, slow_vals)
    rows = sel(fast_vals, slow_vals, src_slow, idx)
    dst_c = dst.to(torch.int64).clamp(0, ns - 1)
    live = (in_q & (keys != PADKEY) & (dst >= 0) & (slow_keys[dst_c] == keys)
            & (rows == slow_vals[dst_c]).all(dim=1))
    scatter(slow_vals, torch.where(live, dst, ns), rows, live)

    fl = fl._replace(
        rem_rows=rem_after,
        rem_run_read=fl.rem_run_read - d_rr,
        rem_run_written=fl.rem_run_written - d_rw,
        rem_fast_read=fl.rem_fast_read - d_fr,
        rem_fast_write=fl.rem_fast_write - d_fw,
        m_done=torch.minimum(fl.m_done + k, fl.m_total))
    return state, fl, (d_rr, d_rw, d_fr, d_fw), k


def inflight_read(state: TierState, fl: InFlight, keys: torch.Tensor,
                  vals: torch.Tensor, found: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """Dual lookup against a half-migrated range: a get found in the slow
    tier whose key has a staged, not yet drained row is served from that
    row's source slot while the source still matches the destination's
    key and value (so the value returned equals the logical lookup's)."""
    active = fl.rem_rows > 0
    in_range = (keys >= fl.lo) & (keys < fl.hi)
    capm = fl.m_key.shape[0]
    pos = searchsorted(fl.m_key, keys).clamp(0, capm - 1)
    staged = (fl.m_key[pos] == keys) & (pos >= fl.m_done) \
        & (pos < fl.m_total)
    fast_vals, slow_vals = state.vals[0], state.vals[1]
    slow_keys = state.keys[1]
    nf, ns = state.keys[0].shape[0], slow_keys.shape[0]
    s_slot = fl.m_src_slot[pos].to(torch.int64)
    s_dst = fl.m_dst_slot[pos]
    sval = torch.where((fl.m_src_tier[pos] != 0)[:, None],
                       slow_vals[s_slot.clamp(0, ns - 1)],
                       fast_vals[s_slot.clamp(0, nf - 1)])
    dst_c = s_dst.to(torch.int64).clamp(0, ns - 1)
    coherent = (s_dst >= 0) & (slow_keys[dst_c] == keys) \
        & (sval == slow_vals[dst_c]).all(dim=1)
    use = active & in_range & staged & coherent & found & (src == 1)
    return torch.where(use[:, None], sval, vals)


def defer_adjust(delta: Counters, before: InFlight,
                 after: InFlight) -> Counters:
    """Re-attribute one step's counter delta for the obs plane: take off
    the I/O deferred into the carry this step (staged minus drained, per
    category).  Quantized jobs are boundary 0: tier-0 random categories
    and tier-1 sequential ones.  The counters themselves are unchanged."""
    n_rr = after.rem_run_read - before.rem_run_read
    n_rw = after.rem_run_written - before.rem_run_written
    n_fr = after.rem_fast_read - before.rem_fast_read
    n_fw = after.rem_fast_write - before.rem_fast_write
    n, dev = delta.reads.shape[0], n_rr.device
    return delta._replace(
        reads=delta.reads - _vec(n, dev, {0: n_fr, 1: n_rr}),
        comp_reads=delta.comp_reads - _vec(n, dev, {1: n_rr}),
        writes=delta.writes - _vec(n, dev, {0: n_fw, 1: n_rw}))


# ----------------------------------------------- deep (run-to-run) merges
#
# Boundaries >= 1 connect two run-structured tiers: there is no slab, no
# clock tracker and no pin/promote decision (only boundary 0 has the
# popularity signal), so a deep compaction is a plain LSM-style merge:
# pick the upper-tier run whose migration buys the most rows per unit of
# boundary-priced I/O, merge it with every overlapping lower-tier run, and
# append the result as fresh lower-tier sub-runs.


def _maybe_deeper(state: TierState, cfg: TierConfig, keys: torch.Tensor,
                  below: int) -> torch.Tensor:
    """OR of the Bloom answers of every tier strictly below ``below``:
    may a copy of the key survive deeper than tier ``below``?  Decides
    whether a tombstone is carried down or dropped."""
    m = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    for t in range(below + 1, cfg.n_tiers):
        rid = run_of_keys(state, keys, tier=t)
        m = m | bloom.query_per_key(state.dir_blooms[t - 1], rid, keys)
    return m


def compact_boundary(state: TierState, cfg: TierConfig, boundary: int, *,
                     cost=None, cap_up: int | None = None,
                     cap_lo: int | None = None, with_movement: bool = False):
    """One deep compaction at ``boundary`` (>= 1): migrate the best-scoring
    tier-``boundary`` run (``msc.select_boundary_run``) into tier
    ``boundary + 1``.  Reads the run's rows and every overlapping lower
    run's rows (sequential I/O on both tiers), drops lower copies the
    run supersedes, drops tombstone rows whose key no deeper tier's Bloom
    filter may hold and carries the rest down, and writes the merge as
    fresh lower sub-runs of <= ``run_size`` (new Bloom filters, directory
    entries, incremental index maintenance on both tiers).

    The window bounds are static, as the JAX package sets them: the
    upper window is one run (<= 2 * run_size rows); the lower window is
    every overlapped run, capped at the exact bound min(tier size,
    max_runs * run_size) -- a shorter window would lose rows.  Counters:
    both windows in per-tier ``reads`` and ``comp_reads``, the output in
    ``writes[boundary + 1]``, one ``comp_by_boundary[boundary]``.
    Writes both tiers' tensors in place.  Returns ``(state', stats[,
    mv])``; ``stats.n_run_read`` covers both windows."""
    if boundary < 1:
        raise ValueError("boundary 0 is compact_once's slab merge")
    from repro_torch.core import msc
    dev = state.keys[0].device
    i32, i64 = torch.int32, torch.int64
    cnt = lambda m: m.sum(dtype=i32)
    u, l = boundary, boundary + 1
    du, dl = u - 1, l - 1
    cap_up = cap_up or 2 * cfg.run_size
    cap_lo = cap_lo or min(cfg.tier_sizes[l], cfg.max_runs * cfg.run_size)
    r = cfg.max_runs
    nt = cfg.n_tiers

    rid, lo, hi, score, ov = msc.select_boundary_run(state, cfg, boundary,
                                                     cost=cost)
    # output hull: the selected range plus every overlapped lower run's
    # range (lower runs are disjoint and each meets [lo, hi))
    ldir_lo, ldir_hi = state.dir_lo[dl], state.dir_hi[dl]
    out_lo = torch.minimum(lo, torch.where(ov, ldir_lo, PADKEY).min())
    out_hi = torch.maximum(hi, torch.where(ov, ldir_hi, -1).max())

    # ---- upper window: the selected run's rows -------------------------
    uik, uis = state.idx_keys[u], state.idx_slots[u]
    upos, um = segment_in_range(uik, lo, hi, cap_up)
    ukeys = torch.where(um, uik[upos], PADKEY)
    uslots = torch.where(um, uis[upos], 0).to(i64)
    # ---- lower window: all rows of the overlapped runs -----------------
    lik, lis = state.idx_keys[l], state.idx_slots[l]
    lpos, lm = segment_in_range(lik, out_lo, out_hi, cap_lo)
    lkeys = torch.where(lm, lik[lpos], PADKEY)
    lslots = torch.where(lm, lis[lpos], 0).to(i64)
    if state.tombs:
        utomb = state.tombs[du][uslots] & um
        ltomb = state.tombs[dl][lslots] & lm
    else:
        utomb, ltomb = torch.zeros_like(um), torch.zeros_like(lm)
    _, in_up = sorted_lookup(uik, uis, lkeys)
    superseded = in_up & lm & (lkeys >= lo) & (lkeys < hi)

    # ---- tombstone retention -------------------------------------------
    if l == nt - 1:
        keep_ut, keep_lt = torch.zeros_like(um), torch.zeros_like(lm)
    else:
        keep_ut = _maybe_deeper(state, cfg, ukeys, below=l)
        keep_lt = _maybe_deeper(state, cfg, lkeys, below=l)
    ukeep = um & (~utomb | keep_ut)
    lkeep = lm & ~superseded & (~ltomb | keep_lt)

    # ---- merge-sort (gathers before the first write) -------------------
    mkeys = torch.cat([torch.where(ukeep, ukeys, PADKEY),
                       torch.where(lkeep, lkeys, PADKEY)])
    mvals = torch.cat([state.vals[u][uslots], state.vals[l][lslots]])
    mtomb = torch.cat([utomb & ukeep, ltomb & lkeep])
    order = torch.argsort(mkeys, stable=True)
    mkeys, mvals, mtomb = mkeys[order], mvals[order], mtomb[order]
    mvalid = mkeys != PADKEY
    n_merged = cnt(mvalid)
    lrun = state.runs[dl]
    in_lo_win = (lrun >= 0) & ov[lrun.to(i64).clamp(0, r - 1)]
    in_up_win = state.runs[du] == rid

    # ---- free the sources ----------------------------------------------
    up_keys = state.keys[u].masked_fill_(in_up_win, -1)
    up_runs = state.runs[du].masked_fill_(in_up_win, -1)
    none = torch.zeros(1, dtype=torch.bool, device=dev)
    uidx_keys, uidx_slots = merge_index_update(
        uik, uis, in_up_win, torch.full((1,), PADKEY, dtype=i32, device=dev),
        torch.full((1,), -1, dtype=i32, device=dev), none)
    udir_act = state.dir_active[du].index_fill_(0, rid.view(1), False)
    udir_cnt = state.dir_count[du].index_fill_(0, rid.view(1), 0)
    lo_keys = state.keys[l].masked_fill_(in_lo_win, -1)
    lo_runs = lrun.masked_fill_(in_lo_win, -1)

    # ---- write the merged output into the lower tier -------------------
    m_total = mkeys.shape[0]
    rs = cfg.run_size
    n_sub = max(m_total // rs, 1) + 1
    mrank = torch.cumsum(mvalid, 0, dtype=i32) - 1
    sub_of = torch.where(mvalid, torch.div(mrank, rs, rounding_mode="floor"),
                         n_sub - 1).to(i64)
    new_slots = alloc_slots(lo_keys, mvalid)
    wrote = mvalid & (new_slots >= 0)
    lo_vals = state.vals[l]
    # tensor writes target alloc_slots' distinct free slots
    set_where(lo_keys, wrote, new_slots, mkeys)
    set_where(lo_vals, wrote, new_slots, mvals)
    ldir_act = state.dir_active[dl].masked_fill_(ov, False)
    ldir_cnt = state.dir_count[dl].masked_fill_(ov, 0)
    free_rids = nonzero_fixed(~ldir_act, n_sub, r)
    set_where(lo_runs, wrote, new_slots,
              free_rids[sub_of.clamp(0, n_sub - 1)].to(i32))
    lidx_keys, lidx_slots = merge_index_update(
        lik, lis, in_lo_win, mkeys, new_slots, wrote)

    sub_counts = torch.zeros(n_sub, dtype=i32, device=dev).index_add_(
        0, sub_of, wrote.to(i32))
    sub_first = torch.full((n_sub,), PADKEY, dtype=i32,
                           device=dev).scatter_reduce_(
        0, sub_of, torch.where(wrote, mkeys, PADKEY), reduce="amin",
        include_self=True)
    ar_sub = torch.arange(n_sub, dtype=i64, device=dev)
    sub_lo = torch.where(ar_sub == 0, out_lo, sub_first)
    nxt_first = torch.cat([sub_first[1:],
                           torch.full((1,), PADKEY, dtype=i32, device=dev)])
    sub_hi = torch.minimum(nxt_first, out_hi)
    sub_ok = sub_counts > 0
    set_where(ldir_act, sub_ok, free_rids, True)
    set_where(ldir_lo, sub_ok, free_rids, sub_lo)
    set_where(ldir_hi, sub_ok, free_rids, sub_hi)
    set_where(ldir_cnt, sub_ok, free_rids, sub_counts)
    # sub-run j's filter covers the run_size positions from
    # min(j * run_size, m_total - run_size): valid rows form a sorted
    # prefix, and the JAX package's dynamic_slice clamps the last
    # window's start, which adds the previous sub-run's tail to its row
    start = (ar_sub * rs).clamp(max=m_total - rs)
    pos = (start[:, None] + torch.arange(rs, dtype=i64, device=dev)
           ).reshape(-1)
    lblooms = state.dir_blooms[dl]
    rows = bloom.make_rows(mkeys[pos], ar_sub.repeat_interleave(rs),
                           wrote[pos], n_sub, lblooms.shape[1])
    set_where(lblooms, sub_ok, free_rids, rows)

    # ---- tombstone marks -----------------------------------------------
    tombs = state.tombs
    if tombs:
        utombs = tombs[du].masked_fill_(in_up_win, False)
        ltombs = tombs[dl].masked_fill_(in_lo_win, False)
        _set_bool(ltombs, wrote, new_slots, mtomb)
        tombs = _tset(_tset(tombs, du, utombs), dl, ltombs)

    # ---- counters -------------------------------------------------------
    t_u, t_l = cnt(um), cnt(lm)
    rinc = _vec(nt, dev, {u: t_u, l: t_l})
    c = state.ctr
    ctr = c._replace(
        compactions=c.compactions + 1,
        reads=c.reads + rinc, comp_reads=c.comp_reads + rinc,
        writes=c.writes + _vec(nt, dev, {l: n_merged}),
        comp_by_boundary=c.comp_by_boundary + _vec(
            nt - 1, dev, {boundary: torch.ones_like(t_u)}),
        rate_limited=c.rate_limited + cnt(mvalid & ~wrote))

    new_state = state._replace(
        keys=_tset(_tset(state.keys, u, up_keys), l, lo_keys),
        vals=_tset(state.vals, l, lo_vals),
        runs=_tset(_tset(state.runs, du, up_runs), dl, lo_runs),
        tombs=tombs,
        idx_keys=_tset(_tset(state.idx_keys, u, uidx_keys), l, lidx_keys),
        idx_slots=_tset(_tset(state.idx_slots, u, uidx_slots), l,
                        lidx_slots),
        dir_lo=_tset(state.dir_lo, dl, ldir_lo),
        dir_hi=_tset(state.dir_hi, dl, ldir_hi),
        dir_count=_tset(_tset(state.dir_count, du, udir_cnt), dl, ldir_cnt),
        dir_active=_tset(_tset(state.dir_active, du, udir_act), dl,
                         ldir_act),
        dir_blooms=_tset(state.dir_blooms, dl, lblooms), ctr=ctr)
    zero = torch.zeros((), dtype=i32, device=dev)
    stats = CompactionStats(
        selected_lo=out_lo, selected_hi=out_hi, score=score,
        n_demoted=zero, n_promoted=zero, n_merged=n_merged,
        n_superseded=cnt(superseded), n_run_read=t_u + t_l,
        n_run_written=n_merged)
    if not with_movement:
        return new_state, stats
    src_tier = torch.cat([torch.full_like(uslots, u),
                          torch.full_like(lslots, l)])
    mv = Movement(
        m_src_tier=src_tier[order].to(i32),
        m_src_slot=torch.cat([uslots, lslots])[order].to(i32),
        m_dst_slot=torch.where(wrote, new_slots, -1).to(i32),
        m_valid=wrote,
        p_src_slot=torch.full((cap_lo,), -1, dtype=i32, device=dev),
        p_dst_slot=torch.full((cap_lo,), -1, dtype=i32, device=dev),
        p_valid=torch.zeros(cap_lo, dtype=torch.bool, device=dev),
        m_key=mkeys.to(i32),
        boundary=torch.full((), boundary, dtype=i32, device=dev))
    return new_state, stats, mv


def needs_compaction(state: TierState, cfg: TierConfig) -> torch.Tensor:
    """The fast tier's occupancy has reached ``cfg.high_watermark`` (the
    §4.2 trigger): a 0-d bool tensor on the state's device."""
    return fast_occupancy(state) >= cfg.high_watermark


def below_low_watermark(state: TierState, cfg: TierConfig
                        ) -> torch.Tensor:
    """The fast tier's occupancy is under ``cfg.low_watermark``."""
    return fast_occupancy(state) < cfg.low_watermark


def tier_over_watermark(state: TierState, cfg: TierConfig,
                        tier: int) -> torch.Tensor:
    """Occupancy trigger of the ``tier`` -> ``tier + 1`` boundary (the
    §4.2 watermarks apply at every boundary)."""
    return tier_occupancy(state, tier) >= cfg.high_watermark


def tier_below_low(state: TierState, cfg: TierConfig,
                   tier: int) -> torch.Tensor:
    return tier_occupancy(state, tier) < cfg.low_watermark
