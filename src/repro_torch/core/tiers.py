"""TieredStore: PrismDB's tiered data layout as a tier list, in PyTorch.

Tier 0 is a fixed-slot unsorted slab pool with a sorted (key -> slot)
index; tiers 1..T-1 are slotted pools of immutable key-sorted runs, each
with a run directory and one Bloom filter per run.  The classic PrismDB
pair is T = 2; with T > 2 the middle tiers carry tombstone rows
(``tombs``) that shadow deeper copies of a deleted key.  The state
mirrors the JAX package's ``TierState`` leaf for leaf
(``core/engine.state_from_numpy`` carries one across).

Pool-sized tensors are updated IN PLACE where the JAX package built a
new array (``apply_point_ops`` writes the tier-0 pool, version and
bucket tensors of the state it is given): the state passed in is
consumed, like the donated buffers of the JAX engine.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bloom, tracker
from repro_torch.core.backend import resolve_device
from repro_torch.core.tracker import TrackerState
from repro_torch.core.utils import (PADKEY, add_where, alloc_slots,
                                    build_sorted_index, dedupe_keep_last,
                                    fdiv,
                                    merge_index_update, searchsorted,
                                    set_where, sorted_lookup)


class TierConfig(NamedTuple):
    key_space: int = 1 << 20        # keys live in [0, key_space)
    fast_slots: int = 1 << 14       # tier-0 capacity (objects)
    slow_slots: int = 1 << 17       # last-tier capacity (objects)
    value_width: int = 4            # payload lanes (float32) per object
    value_bytes: int = 1024         # *modeled* object size (paper: ~1 KB)
    max_runs: int = 256
    run_size: int = 4096            # target objects per run (SST size)
    bloom_bits_per_run: int = 1 << 15
    tracker_slots: int = 1 << 16    # paper: ~10-20% of key space
    n_buckets: int = 256            # approx-MSC buckets
    pin_threshold: float = 0.7      # paper default (§7)
    promote_min_clock: int = 3      # promote only the hottest clock class
    high_watermark: float = 0.98    # paper §4.2 (every tier boundary)
    low_watermark: float = 0.95
    range_fanout_i: int = 1         # compaction key range = i consecutive runs
    power_k: int = 8                # power-of-k range candidates (§A.1)
    tier_slots: tuple = ()          # N-tier slot counts; () = legacy pair

    @property
    def tier_sizes(self) -> tuple:
        return tuple(self.tier_slots) or (self.fast_slots, self.slow_slots)

    @property
    def n_tiers(self) -> int:
        return len(self.tier_sizes)


class Counters(NamedTuple):
    """Operation counters in object units (int32, as in the JAX package).
    ``hits/reads/writes/comp_reads/scan_reads`` are per-tier vectors,
    ``comp_by_boundary`` has one entry per tier boundary."""
    gets: torch.Tensor
    puts: torch.Tensor
    hits: torch.Tensor
    misses: torch.Tensor
    reads: torch.Tensor
    writes: torch.Tensor
    bloom_probes: torch.Tensor
    bloom_fps: torch.Tensor
    consolidations: torch.Tensor
    comp_reads: torch.Tensor
    scans: torch.Tensor
    scan_objs: torch.Tensor
    scan_reads: torch.Tensor
    compactions: torch.Tensor
    comp_by_boundary: torch.Tensor
    demoted: torch.Tensor
    promoted: torch.Tensor
    rate_limited: torch.Tensor

    @staticmethod
    def zeros(n_tiers: int = 2, device=None) -> "Counters":
        device = resolve_device(device)
        z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
        return Counters(
            gets=z(), puts=z(), hits=z(n_tiers), misses=z(),
            reads=z(n_tiers), writes=z(n_tiers), bloom_probes=z(),
            bloom_fps=z(), consolidations=z(), comp_reads=z(n_tiers),
            scans=z(), scan_objs=z(), scan_reads=z(n_tiers),
            compactions=z(), comp_by_boundary=z(n_tiers - 1), demoted=z(),
            promoted=z(), rate_limited=z())


class TierState(NamedTuple):
    """The tier list; tuple fields hold one tensor per tier (``keys``,
    ``vals``, ``idx_*``) or per run-structured tier (``runs``, ``tombs``,
    ``dir_*``), exactly as in the JAX package."""
    keys: tuple               # i32[N_t] per tier, -1 free
    vals: tuple               # f32[N_t, V] per tier
    fast_ver: torch.Tensor    # i32[N_0]; < 0 marks a tier-0 tombstone
    runs: tuple               # i32[N_t] run id per slot (-1 free), t >= 1
    tombs: tuple              # () at T=2
    idx_keys: tuple           # i32[N_t] sorted (PADKEY pad), per tier
    idx_slots: tuple          # i32[N_t], per tier
    dir_lo: tuple             # i32[R] per run-structured tier
    dir_hi: tuple             # i32[R]
    dir_count: tuple          # i32[R]
    dir_active: tuple         # bool[R]
    dir_blooms: tuple         # i32[R, W] (uint32 bit pattern)
    tracker: TrackerState
    bucket_fast: torch.Tensor     # i32[B] live tier-0 keys per bucket
    bucket_slow: torch.Tensor     # i32[B] live tier-1 keys per bucket
    bucket_overlap: torch.Tensor  # i32[B] est. tier-0∩tier-1 keys
    ctr: Counters

    @property
    def n_tiers(self) -> int:
        return len(self.keys)


def init(cfg: TierConfig, device=None, dtype=torch.float32) -> TierState:
    device = resolve_device(device)
    sizes = cfg.tier_sizes
    r, v = cfg.max_runs, cfg.value_width
    full = lambda n, x: torch.full((n,), x, dtype=torch.int32, device=device)
    idx = [build_sorted_index(full(n, -1)) for n in sizes]
    return TierState(
        keys=tuple(full(n, -1) for n in sizes),
        vals=tuple(torch.zeros((n, v), dtype=dtype, device=device)
                   for n in sizes),
        fast_ver=full(sizes[0], 0),
        runs=tuple(full(n, -1) for n in sizes[1:]),
        tombs=(() if len(sizes) == 2 else
               tuple(torch.zeros((n,), dtype=torch.bool, device=device)
                     for n in sizes[1:])),
        idx_keys=tuple(k for k, _ in idx),
        idx_slots=tuple(s for _, s in idx),
        dir_lo=tuple(full(r, PADKEY) for _ in sizes[1:]),
        dir_hi=tuple(full(r, PADKEY) for _ in sizes[1:]),
        dir_count=tuple(full(r, 0) for _ in sizes[1:]),
        dir_active=tuple(torch.zeros((r,), dtype=torch.bool, device=device)
                         for _ in sizes[1:]),
        dir_blooms=tuple(bloom.init(r, cfg.bloom_bits_per_run, device)
                         for _ in sizes[1:]),
        tracker=tracker.init(cfg.tracker_slots, device),
        bucket_fast=full(cfg.n_buckets, 0),
        bucket_slow=full(cfg.n_buckets, 0),
        bucket_overlap=full(cfg.n_buckets, 0),
        ctr=Counters.zeros(len(sizes), device))


def bucket_of(cfg: TierConfig, keys: torch.Tensor) -> torch.Tensor:
    width = max(cfg.key_space // cfg.n_buckets, 1)
    return torch.div(keys, width, rounding_mode="floor").clamp(
        0, cfg.n_buckets - 1).to(torch.int64)


def free_fast_slots(state: TierState) -> torch.Tensor:
    return (state.keys[0] < 0).sum(dtype=torch.int32)


def tier_occupancy(state: TierState, t: int) -> torch.Tensor:
    """float32 share of tier ``t``'s slots in use."""
    used = (state.keys[t] >= 0).sum(dtype=torch.int32)
    return fdiv(used.to(torch.float32), state.keys[t].shape[0])


def fast_occupancy(state: TierState) -> torch.Tensor:
    return tier_occupancy(state, 0)


def run_of_keys(state: TierState, keys: torch.Tensor,
                tier: int = 1) -> torch.Tensor:
    """int64[n] covering-run id per key (-1 = none) in run-structured
    ``tier``: the JAX package's [R, n] cover matrix, kept as the
    reference semantics (O(R * n) work per call)."""
    lo, hi = state.dir_lo[tier - 1], state.dir_hi[tier - 1]
    act = state.dir_active[tier - 1]
    cover = (act[:, None] & (lo[:, None] <= keys[None, :])
             & (keys[None, :] < hi[:, None]))
    any_cover = cover.any(dim=0)
    rid = torch.argmax(cover.to(torch.uint8), dim=0)
    return torch.where(any_cover, rid, -1)


def _on(m: torch.Tensor, flag: bool) -> torch.Tensor:
    return m if flag else torch.zeros_like(m)


def _cnt(m: torch.Tensor) -> torch.Tensor:
    return m.sum(dtype=torch.int32)


def apply_point_ops(state: TierState, cfg: TierConfig, keys: torch.Tensor,
                    vals: torch.Tensor, valid: torch.Tensor, *,
                    is_put: bool, is_get: bool, is_del: bool,
                    backend: str = "reference"
                    ) -> tuple[TierState, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Put/get/delete as one masked pass (JAX ``tiers.apply_point_ops``).
    The kind flags are Python bools (at most one true): the lanes of the
    other kinds are masked off exactly as in the JAX package, and work
    whose every lane is masked off (the get lane of a put, the pool
    writes of a get, the deeper tiers' Bloom probes of a put) is skipped
    -- it would write nothing.

    get walks the tiers downward: tier-0 index, then tier by tier a Bloom
    probe and a run lookup, every Bloom-positive probe charged a read on
    that tier; a tombstone row of a middle tier is a definitive miss, as
    a tier-0 tombstone hides the whole lower hierarchy.  delete frees the
    tier-0 copy, and leaves a tier-0 tombstone where any lower tier's
    Bloom filter says the key may live.

    Returns ``(state', vals, found, source)``; the get-lane outputs are
    zeros / False / -1 unless ``is_get``, ``source`` the serving tier.
    Writes the tier-0 pool of ``state`` in place."""
    dev = keys.device
    keys = keys.to(torch.int32)
    n_tiers = state.n_tiers
    nf = state.keys[0].shape[0]
    keep = dedupe_keep_last(keys, valid)

    # ---- shared lookups -------------------------------------------------
    fslot, flook = sorted_lookup(state.idx_keys[0], state.idx_slots[0],
                                 keys)
    fslot = fslot.to(torch.int64)
    fc = fslot.clamp(min=0)
    tomb = state.fast_ver[fc] < 0
    # per-lower-tier Bloom answers ("key may live in tier t"); a put needs
    # tier 1's only (the bucket overlap estimate)
    maybe_raw = []
    for t in range(1, n_tiers if (is_get or is_del) else 2):
        rid = run_of_keys(state, keys, tier=t)
        maybe_raw.append(bloom.query_per_key(state.dir_blooms[t - 1], rid,
                                             keys))
    maybe0 = maybe_raw[0]
    maybe_any = maybe_raw[0]
    for m in maybe_raw[1:]:
        maybe_any = maybe_any | m
    b = bucket_of(cfg, keys)

    # ---- get lane (reads the pre-op pools; kinds are exclusive) ---------
    g = _on(valid, is_get)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    hit_list = [torch.zeros_like(valid)] * (n_tiers - 1)
    probe_list = list(hit_list)
    probe_cnt = fp_cnt = zero
    if is_get:
        fhit = flook & g & ~tomb
        searching = g & ~flook           # a tombstone hides lower copies
        tier_vals = []
        for t in range(1, n_tiers):
            maybe_t = maybe_raw[t - 1] & searching
            sslot, sfound = sorted_lookup(state.idx_keys[t],
                                          state.idx_slots[t], keys)
            sc = sslot.to(torch.int64).clamp(min=0)
            hit_t = sfound & maybe_t
            if state.tombs:
                ltomb = state.tombs[t - 1][sc]
                tombhit_t = hit_t & ltomb
                hit_t = hit_t & ~ltomb
            else:
                tombhit_t = torch.zeros_like(hit_t)
            probe_cnt = probe_cnt + _cnt(searching)
            fp_cnt = fp_cnt + _cnt(maybe_t & ~sfound)
            hit_list[t - 1], probe_list[t - 1] = hit_t, maybe_t
            tier_vals.append(state.vals[t][sc])
            searching = searching & ~(hit_t | tombhit_t)
        fvals = state.vals[0][fc]
        out_vals = torch.zeros_like(fvals)
        source = torch.full(keys.shape, -1, dtype=torch.int32, device=dev)
        shit_any = torch.zeros_like(fhit)
        for t in range(n_tiers - 1, 0, -1):
            h = hit_list[t - 1]
            out_vals = torch.where(h[:, None], tier_vals[t - 1], out_vals)
            source = torch.where(h, t, source).to(torch.int32)
            shit_any = shit_any | h
        out_vals = torch.where(fhit[:, None], fvals, out_vals)
        source = torch.where(fhit, 0, source).to(torch.int32)
        found = fhit | shit_any
    else:
        fhit = shit_any = found = torch.zeros_like(valid)
        out_vals = torch.zeros((keys.shape[0], state.vals[0].shape[1]),
                               dtype=state.vals[0].dtype, device=dev)
        source = torch.full(keys.shape, -1, dtype=torch.int32, device=dev)

    # ---- lane masks -----------------------------------------------------
    putk = _on(keep, is_put)
    delk = _on(keep, is_del)
    fast_keys, fast_vals, fast_ver = state.keys[0], state.vals[0], \
        state.fast_ver
    bucket_fast, bucket_overlap = state.bucket_fast, state.bucket_overlap
    fidx_keys, fidx_slots = state.idx_keys[0], state.idx_slots[0]
    if is_put or is_del:
        upd = flook & putk
        fresh_put = putk & ~flook
        dfound = flook & delk
        maybe_del = maybe_any & delk
        free_d = dfound & ~maybe_del
        tomb_old = dfound & maybe_del
        tomb_fresh = maybe_del & ~dfound

        # ---- allocation (delete's frees are visible to its tombstones) --
        set_where(fast_keys, free_d, fslot, -1)
        want = fresh_put | tomb_fresh
        new_slots = alloc_slots(fast_keys, want)
        ins_ok = want & (new_slots >= 0)

        # ---- pool writes ------------------------------------------------
        ver_upd = fast_ver[fc].abs() + 1
        # tensor writes: upd lanes are distinct keys (dedupe_keep_last) in
        # distinct live slots; alloc_slots hands out distinct free slots,
        # and a tombstone lands on a live slot it keeps or on a new one
        set_where(fast_vals, upd, fslot, vals)
        set_where(fast_ver, upd, fslot, ver_upd)
        ins_put = ins_ok & fresh_put
        set_where(fast_keys, ins_put, new_slots, keys)
        set_where(fast_vals, ins_put, new_slots, vals)
        set_where(fast_ver, ins_put, new_slots, 1)
        tomb_ok = tomb_old | (tomb_fresh & ins_ok)
        ttgt = torch.where(tomb_old, fslot, new_slots.to(torch.int64))
        set_where(fast_keys, tomb_ok, ttgt, keys)
        set_where(fast_ver, tomb_ok, ttgt, -1)

        # ---- one incremental index update for both mutating lanes ------
        dropm = set_where(torch.zeros(nf, dtype=torch.bool, device=dev),
                          free_d, fslot, True)
        fidx_keys, fidx_slots = merge_index_update(
            fidx_keys, fidx_slots, dropm, keys, new_slots, ins_ok)

        # ---- bucket stats (boundary 0) ----------------------------------
        add_where(bucket_fast, ins_ok, b, 1)
        add_where(bucket_fast, free_d, b, -1)
        add_where(bucket_overlap, maybe0 & ins_put, b, 1)

    # ---- tracker --------------------------------------------------------
    trk = state.tracker
    if is_put or is_get:
        trk_locs = shit_any.to(torch.int8)
        trk_mask = putk | (g & found)
        if backend == "reference":
            trk = tracker.access_batched(trk, keys, trk_locs, trk_mask)
        else:
            from repro_torch.kernels.clock_update.ops import tracker_access
            trk = tracker_access(trk, keys, trk_locs, trk_mask,
                                 backend=backend)

    # ---- counters -------------------------------------------------------
    n_put = _cnt(putk)
    ctr = state.ctr
    ctr = ctr._replace(
        puts=ctr.puts + n_put,
        gets=ctr.gets + _cnt(g),
        hits=ctr.hits + torch.stack([_cnt(fhit)]
                                    + [_cnt(h) for h in hit_list]),
        misses=ctr.misses + _cnt(g & ~found),
        reads=ctr.reads + torch.stack([_cnt(fhit)]
                                      + [_cnt(m) for m in probe_list]),
        writes=ctr.writes + torch.stack([n_put] + [zero] * (n_tiers - 1)),
        bloom_probes=ctr.bloom_probes + probe_cnt,
        bloom_fps=ctr.bloom_fps + fp_cnt)
    state = state._replace(
        keys=(fast_keys,) + state.keys[1:],
        vals=(fast_vals,) + state.vals[1:], fast_ver=fast_ver,
        idx_keys=(fidx_keys,) + state.idx_keys[1:],
        idx_slots=(fidx_slots,) + state.idx_slots[1:],
        bucket_fast=bucket_fast, bucket_overlap=bucket_overlap,
        tracker=trk, ctr=ctr)
    return state, out_vals, found, source


def put_batch(state: TierState, cfg: TierConfig, keys: torch.Tensor,
              vals: torch.Tensor, valid: torch.Tensor, *,
              backend: str = "reference") -> TierState:
    """Insert/update a batch (JAX ``tiers.put_batch``: the put-only form
    of ``apply_point_ops``).  ``backend`` routes the tracker update (B1 on
    backend "cuda"); the JAX package's wrapper always takes its plain
    tracker, and the kernel is bit-exact to it."""
    state, _, _, _ = apply_point_ops(state, cfg, keys, vals, valid,
                                     is_put=True, is_get=False, is_del=False,
                                     backend=backend)
    return state


def get_batch(state: TierState, cfg: TierConfig, keys: torch.Tensor,
              valid: torch.Tensor, *, backend: str = "reference"
              ) -> tuple[TierState, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """Returns (state', vals, found, source); source is the serving tier
    (0 = fast slab), -1 a miss.  ``backend`` as in
    ``put_batch``."""
    vals = torch.zeros((keys.shape[0], state.vals[0].shape[1]),
                       dtype=state.vals[0].dtype, device=keys.device)
    return apply_point_ops(state, cfg, keys, vals, valid, is_put=False,
                           is_get=True, is_del=False, backend=backend)


def delete_batch(state: TierState, cfg: TierConfig, keys: torch.Tensor,
                 valid: torch.Tensor) -> TierState:
    """Client deletes (paper §6): the delete-only form of
    ``apply_point_ops``."""
    vals = torch.zeros((keys.shape[0], state.vals[0].shape[1]),
                       dtype=state.vals[0].dtype, device=keys.device)
    state, _, _, _ = apply_point_ops(state, cfg, keys, vals, valid,
                                     is_put=False, is_get=False, is_del=True)
    return state


def consolidate_indexes(state: TierState) -> TierState:
    """Full-rebuild fallback: re-derive every sorted tier index."""
    idx = [build_sorted_index(k) for k in state.keys]
    ctr = state.ctr._replace(consolidations=state.ctr.consolidations + 1)
    return state._replace(idx_keys=tuple(k for k, _ in idx),
                          idx_slots=tuple(s for _, s in idx), ctr=ctr)


def _scan_windows(state: TierState, lo: torch.Tensor, take: int) -> tuple:
    """The next ``take`` index entries >= ``lo[b]`` from each tier, per
    lane b ([B, take] each), with tombstoned entries and upper-tier-
    shadowed lower entries masked to PADKEY."""
    ar = torch.arange(take, dtype=torch.int64, device=lo.device)
    wins = []
    for t in range(len(state.keys)):
        ik, isl = state.idx_keys[t], state.idx_slots[t]
        n = ik.shape[0]
        start = searchsorted(ik, lo)
        raw = start[..., None] + ar
        pos = raw.clamp(0, n - 1)
        k = torch.where(raw < n, ik[pos], torch.full_like(ik[pos], PADKEY))
        if t == 0:
            dead = state.fast_ver[isl[pos].to(torch.int64).clamp(min=0)] < 0
        else:
            if state.tombs:
                dead = state.tombs[t - 1][
                    isl[pos].to(torch.int64).clamp(min=0)]
            else:
                dead = torch.zeros(k.shape, dtype=torch.bool,
                                   device=k.device)
            # keys shadowed by any upper-tier index entry (tombstones
            # included) are dead
            for u in range(t):
                _, shadowed = sorted_lookup(state.idx_keys[u],
                                            state.idx_slots[u],
                                            k.reshape(-1))
                dead = dead | shadowed.view(k.shape)
        wins.append(torch.where(dead, torch.full_like(k, PADKEY), k))
    return tuple(wins)


def scan(state: TierState, lo, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Up to ``n`` live keys >= lo in sorted order, merged across tiers."""
    lo = torch.as_tensor(lo, dtype=torch.int32, device=state.keys[0].device)
    wins = _scan_windows(state, lo, n)
    allk = torch.sort(torch.cat(wins)).values
    keys = allk[:n]
    return keys, keys != PADKEY


def scan_batch(state: TierState, cfg: TierConfig, starts: torch.Tensor,
               lens: torch.Tensor, valid: torch.Tensor, *, chunk: int
               ) -> tuple[TierState, torch.Tensor]:
    """Batched bounded range scans (YCSB-E) over the merged sorted
    indexes (JAX ``tiers.scan_batch``, the vmap written out as a batch
    dimension).  Returns ``(state', n_live)``."""
    n_tiers = len(state.keys)
    dev = starts.device
    wins = _scan_windows(state, starts.to(torch.int32), chunk)
    keys = torch.cat(wins, dim=1)                              # [B, T*c]
    tier_of = torch.arange(n_tiers, dtype=torch.int32,
                           device=dev).repeat_interleave(chunk)
    order = torch.argsort(keys, dim=1, stable=True)
    keys = torch.gather(keys, 1, order)
    tier_of = tier_of[order]
    ln = torch.where(valid, lens.clamp(min=0), 0)
    live = keys != PADKEY
    sel = live & (torch.cumsum(live, 1, dtype=torch.int32) <= ln[:, None])
    per_tier = torch.stack([(sel & (tier_of == t)).sum(1, dtype=torch.int32)
                            for t in range(n_tiers)], dim=1)   # [B, T]
    n_live = sel.sum(1, dtype=torch.int32)
    tier_tot = per_tier.sum(0, dtype=torch.int32)
    seq_tot = tier_tot.clone()
    seq_tot[0] = 0
    c = state.ctr
    ctr = c._replace(scans=c.scans + _cnt(valid),
                     scan_objs=c.scan_objs + tier_tot.sum(dtype=torch.int32),
                     reads=c.reads + tier_tot,
                     scan_reads=c.scan_reads + seq_tot)
    return state._replace(ctr=ctr), n_live


def counters_dict(ctr, partitioned: bool = False) -> dict:
    """Host-side counter export: every pair-era scalar key plus the
    ``*_by_tier`` vector keys (the JAX package's ``counters_dict``).
    With ``partitioned=True``, ``ctr`` is a list of per-partition
    ``Counters`` or stacked ones (a leading partition axis on every
    leaf), and each value becomes a per-partition list."""
    if not isinstance(ctr, Counters):
        ctr = Counters(*[torch.stack(x) for x in zip(*ctr)])
    vec = {"hits", "reads", "writes", "comp_reads", "scan_reads",
           "comp_by_boundary"}

    def ints(a):
        return [ints(row) for row in a] if a.ndim > 1 else \
            [int(x) for x in a]

    def cast(a):
        return [int(x) for x in a] if partitioned else int(a)

    d = {}
    host = {k: np.asarray(v.cpu()) for k, v in ctr._asdict().items()}
    for k, a in host.items():
        if k in vec:
            key = k if k == "comp_by_boundary" else k + "_by_tier"
            d[key] = ints(a)
        else:
            d[k] = ints(a) if partitioned else int(a)
    d["hits_fast"] = cast(host["hits"][..., 0])
    d["hits_slow"] = cast(host["hits"][..., 1:].sum(axis=-1))
    d["fast_reads"] = cast(host["reads"][..., 0])
    d["slow_reads"] = cast(host["reads"][..., 1:].sum(axis=-1))
    d["fast_writes"] = cast(host["writes"][..., 0])
    d["slow_writes"] = cast(host["writes"][..., 1:].sum(axis=-1))
    d["comp_reads"] = cast(host["comp_reads"].sum(axis=-1))
    d["scan_reads"] = cast(host["scan_reads"].sum(axis=-1))
    return d
