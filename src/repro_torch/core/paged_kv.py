"""Tiered paged KV cache: PrismDB's core applied to long-context serving
(the port's copy of the JAX package's ``core/paged_kv.py``).

object = one KV page (page_tokens tokens x kv_heads x head_dim for every
layer); key = seq_id * max_pages_per_seq + page_idx.  The fast tier is
the page pool on the card (decode appends in place), the slow tier a
second pool written in sorted runs by MSC compactions.  Popularity is the
attention page-access stream: Quest-style per-page key summaries score
pages against the query, and the top-k attended pages feed the clock
tracker (``tiers.get_batch``; B1 on backend "cuda").  The ``TierState``
tracks placement; every compaction's ``Movement`` is replayed on the
page pools (``apply_movement``; the tier_compact movers B3/B5/B4 on
backend "cuda").

Pools are [L, P, T, H, D] (summaries [L, P, H, D]), as in the JAX
package, but ``init`` stores them slot-major: one slot's pages of every
layer are one contiguous row, so the Movement replay moves rows in place
and one layer's pool is a strided [P, T, H, D] view that the
paged_attention kernel (B6) reads in place.  They are updated IN PLACE:
a state passed to ``append_tokens``, ``bulk_insert``, ``gather_pages``,
``compact`` or ``apply_movement`` is consumed, like the donated buffers
of the JAX engine.  ``x.at[...].set(mode="drop")`` becomes
``_set_pages`` / ``_set_tokens`` (lanes masked off or out of range write
nothing).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import compaction, tiers
from repro_torch.core.backend import resolve_device
from repro_torch.core.compaction import Movement
from repro_torch.core.tiers import TierConfig, TierState
from repro_torch.core.utils import add_where, set_where, sorted_lookup, take

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PagedKVConfig(NamedTuple):
    n_layers: int = 4            # attention layers sharing this pool
    kv_heads: int = 8
    head_dim: int = 128
    page_tokens: int = 64
    fast_pages: int = 512
    slow_pages: int = 4096
    max_seqs: int = 16
    max_pages_per_seq: int = 256
    topk_pages: int = 16         # pages attended per step (Quest-style)
    recent_pages: int = 2        # most recent pages always attended
    dtype: str = "bfloat16"

    def tier(self) -> TierConfig:
        return TierConfig(
            key_space=self.max_seqs * self.max_pages_per_seq,
            fast_slots=self.fast_pages,
            slow_slots=self.slow_pages,
            value_width=1,
            value_bytes=(2 * self.n_layers * self.page_tokens * self.kv_heads
                         * self.head_dim * 2),      # bf16 K+V payload bytes
            max_runs=max(self.slow_pages // 128, 16),
            run_size=128,
            bloom_bits_per_run=1 << 12,
            tracker_slots=max(self.fast_pages * 2, 256),
            n_buckets=min(256, max(self.max_seqs * 4, 16)),
            pin_threshold=0.7,
        )


class PagedKVState(NamedTuple):
    tier: TierState | None
    # payload pools: [L, P, T, H, D]
    k_fast: torch.Tensor
    v_fast: torch.Tensor
    k_slow: torch.Tensor
    v_slow: torch.Tensor
    # Quest page summaries, per pool slot: [L, P, H, D]
    kmax_fast: torch.Tensor
    kmin_fast: torch.Tensor
    kmax_slow: torch.Tensor
    kmin_slow: torch.Tensor
    seq_len: torch.Tensor        # i32[max_seqs] tokens written per sequence


def page_key(cfg: PagedKVConfig, seq_ids: torch.Tensor,
             page_idx: torch.Tensor) -> torch.Tensor:
    return (seq_ids * cfg.max_pages_per_seq + page_idx).to(torch.int32)


def init(cfg: PagedKVConfig, device=None) -> PagedKVState:
    """Empty pools on ``device`` (None: the card; raises without one)."""
    dev = resolve_device(device)
    dt = _DTYPES[cfg.dtype]
    l, t, h, d = cfg.n_layers, cfg.page_tokens, cfg.kv_heads, cfg.head_dim
    pf, ps = cfg.fast_pages, cfg.slow_pages
    big = torch.finfo(dt).max
    def pool(n, fill, *inner):
        """[L, n, *inner], stored slot-major: one slot's pages of every
        layer are one contiguous row, so the Movement replay moves rows
        in place."""
        return torch.full((n, l) + inner, fill, dtype=dt,
                          device=dev).movedim(0, 1)

    return PagedKVState(
        tier=tiers.init(cfg.tier(), dev),
        k_fast=pool(pf, 0.0, t, h, d), v_fast=pool(pf, 0.0, t, h, d),
        k_slow=pool(ps, 0.0, t, h, d), v_slow=pool(ps, 0.0, t, h, d),
        kmax_fast=pool(pf, -big, h, d), kmin_fast=pool(pf, big, h, d),
        kmax_slow=pool(ps, -big, h, d), kmin_slow=pool(ps, big, h, d),
        seq_len=torch.zeros((cfg.max_seqs,), dtype=torch.int32, device=dev))


def _set_pages(pool: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor,
               vals) -> torch.Tensor:
    """In place along the pool axis (1): ``pool[:, idx[i]] = vals[:, i]``
    where ``mask[i]`` and ``idx[i]`` is in range; a scalar ``vals`` is
    broadcast (a scalar may repeat a target; ``set_where``).  Tensor
    writes target distinct pages: each live sequence owns its page, and
    a Movement's destination slots are distinct."""
    if torch.is_tensor(vals) and vals.dim() > 0:
        vals = torch.movedim(vals, 1, 0)
    set_where(torch.movedim(pool, 1, 0), mask, idx.to(torch.int64), vals)
    return pool


def _set_tokens(pool: torch.Tensor, mask: torch.Tensor, slot: torch.Tensor,
                off: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """In place: ``pool[:, slot[i], off[i]] = vals[:, i]`` for [L, P, T,
    ...] pools where ``mask[i]`` and the slot is in range: each target
    page is copied out, the token written into the copy, and the page
    set back (``_set_pages``)."""
    pages = _pages(pool, slot)                            # [L, B, T, ...]
    pages[:, torch.arange(slot.shape[0], device=slot.device),
          off.to(torch.int64)] = vals.to(pool.dtype)
    return _set_pages(pool, mask, slot, pages)


def _pages(pool: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``pool[:, slots]`` with the slots clamped into range (a gather of
    the JAX package clamps)."""
    return pool[:, slots.to(torch.int64).clamp(0, pool.shape[1] - 1)]


# ------------------------------------------------------------------ lookup

def _fast_lookup(tier: TierState, keys: torch.Tensor):
    return sorted_lookup(tier.idx_keys[0], tier.idx_slots[0], keys)


def _slow_lookup(tier: TierState, keys: torch.Tensor):
    return sorted_lookup(tier.idx_keys[1], tier.idx_slots[1], keys)


def fast_slots_of(state: PagedKVState, keys: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    slot, found = _fast_lookup(state.tier, keys)
    return torch.where(found, slot, -1), found


def slow_slots_of(state: PagedKVState, keys: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    slot, found = _slow_lookup(state.tier, keys)
    return torch.where(found, slot, -1), found


# ------------------------------------------------------------------ append

def append_tokens(state: PagedKVState, cfg: PagedKVConfig,
                  seq_ids: torch.Tensor, k_new: torch.Tensor,
                  v_new: torch.Tensor, valid: torch.Tensor, *,
                  backend: str = "reference") -> PagedKVState:
    """Append one token per (valid) sequence; the decode-step write path.

    k_new/v_new: [L, B, H, D].  Opens a fresh fast-tier page on page
    boundaries; a demoted tail page is *reopened*: a new fast version is
    inserted and its payload copied back from the slow pool (one slow
    read; the stale slow copy is superseded at the next merge).
    ``backend`` routes the tracker update of the page insert.
    """
    t, pf = cfg.page_tokens, cfg.fast_pages
    i32 = torch.int32
    pos = state.seq_len[seq_ids.to(torch.int64)]
    pidx = torch.div(pos, t, rounding_mode="floor")
    off = pos % t
    keys = page_key(cfg, seq_ids, pidx)

    # the slow index is not touched by a put: look it up once, up front
    sslot, sfound = _slow_lookup(state.tier, keys)
    _, found0 = _fast_lookup(state.tier, keys)
    reopen = valid & ~found0 & (off > 0)
    opening = valid & (((off == 0) & ~found0) | reopen)
    dummy = torch.zeros((keys.shape[0], 1), dtype=state.tier.vals[0].dtype,
                        device=keys.device)
    tier = tiers.put_batch(state.tier, cfg.tier(), keys, dummy, opening,
                           backend=backend)

    slot, found = _fast_lookup(tier, keys)
    ok = valid & found
    tgt_slot = torch.where(ok, slot, pf)

    # copy demoted tail pages back from the slow pool before writing
    cp = reopen & sfound & found
    ss = sslot.clamp(min=0)
    for fast, slow in ((state.k_fast, state.k_slow),
                       (state.v_fast, state.v_slow),
                       (state.kmax_fast, state.kmax_slow),
                       (state.kmin_fast, state.kmin_slow)):
        _set_pages(fast, cp, slot, _pages(slow, ss))
    # fresh pages start from clean summaries (slots recycle)
    big = torch.finfo(state.k_fast.dtype).max
    fresh = ok & (off == 0)
    _set_pages(state.kmax_fast, fresh, slot, -big)
    _set_pages(state.kmin_fast, fresh, slot, big)
    reads = tier.ctr.reads
    tier = tier._replace(ctr=tier.ctr._replace(reads=torch.stack(
        [reads[0], reads[1] + cp.sum(dtype=i32)])))

    _set_tokens(state.k_fast, ok, tgt_slot, off, k_new)
    _set_tokens(state.v_fast, ok, tgt_slot, off, v_new)
    kmax, kmin = state.kmax_fast, state.kmin_fast
    kn = k_new.to(kmax.dtype)
    _set_pages(kmax, ok, tgt_slot, torch.maximum(_pages(kmax, tgt_slot), kn))
    _set_pages(kmin, ok, tgt_slot, torch.minimum(_pages(kmin, tgt_slot), kn))
    add_where(state.seq_len, ok, seq_ids, 1)
    return state._replace(tier=tier)


def bulk_insert(state: PagedKVState, cfg: PagedKVConfig,
                seq_id: torch.Tensor, k_seq: torch.Tensor,
                v_seq: torch.Tensor, n_tokens: torch.Tensor, *,
                backend: str = "reference") -> PagedKVState:
    """Prefill write path: insert a whole sequence's KV at once.

    k_seq/v_seq: [L, S, H, D] with S a multiple of page_tokens (padded);
    ``seq_id`` and ``n_tokens`` are 0-dim int tensors on the pools' device.
    """
    l, s, h, d = k_seq.shape
    t = cfg.page_tokens
    dev = k_seq.device
    n_pages_max = s // t
    pidx = torch.arange(n_pages_max, dtype=torch.int32, device=dev)
    keys = page_key(cfg, seq_id, pidx)
    live = pidx * t < n_tokens
    dummy = torch.zeros((n_pages_max, 1), dtype=state.tier.vals[0].dtype,
                        device=dev)
    tier = tiers.put_batch(state.tier, cfg.tier(), keys, dummy, live,
                           backend=backend)
    slot, found = _fast_lookup(tier, keys)
    ok = live & found
    kp = k_seq.reshape(l, n_pages_max, t, h, d)
    vp = v_seq.reshape(l, n_pages_max, t, h, d)
    _set_pages(state.k_fast, ok, slot, kp)
    _set_pages(state.v_fast, ok, slot, vp)
    _set_pages(state.kmax_fast, ok, slot, torch.amax(kp, dim=2))
    _set_pages(state.kmin_fast, ok, slot, torch.amin(kp, dim=2))
    sid = seq_id.reshape(1).to(torch.int64)
    set_where(state.seq_len, torch.ones_like(sid, dtype=torch.bool), sid,
              torch.maximum(take(state.seq_len, sid[0]),
                            n_tokens.to(torch.int32)).reshape(1))
    return state._replace(tier=tier)


# ------------------------------------------------- page selection + gather

def select_pages(state: PagedKVState, cfg: PagedKVConfig,
                 seq_ids: torch.Tensor, q: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quest-style top-k page selection per sequence.

    q: [L, B, Hq, D] current queries.  Returns (page_idx [B, K], mask).
    Scores every logical page of the sequence from its summaries (either
    pool), keeps the top-k plus the most recent pages.  Ties (the recent
    pages at +inf, absent ones at -inf) keep the lower page index first,
    as XLA's top_k does: a stable descending sort, then the first k.
    """
    b = seq_ids.shape[0]
    mp, t = cfg.max_pages_per_seq, cfg.page_tokens
    dev = seq_ids.device
    pidx = torch.arange(mp, dtype=torch.int32, device=dev)[None, :]
    keys = page_key(cfg, seq_ids[:, None], pidx)               # [B, MP]
    n_pages = torch.div(state.seq_len[seq_ids.to(torch.int64)] + t - 1, t,
                        rounding_mode="floor")
    exists = pidx < n_pages[:, None]

    fslot, ffound = _fast_lookup(state.tier, keys.reshape(-1))
    sslot, sfound = _slow_lookup(state.tier, keys.reshape(-1))
    fslot, sslot = fslot.reshape(b, mp), sslot.reshape(b, mp)
    ffound = ffound.reshape(b, mp) & exists
    sfound = sfound.reshape(b, mp) & exists & ~ffound

    # group queries onto kv heads: [L, B, Hq, D] -> [L, B, Hkv, D]
    g = q.shape[2] // cfg.kv_heads
    qg = q.reshape(q.shape[0], b, cfg.kv_heads, g, q.shape[3]).mean(dim=3)

    def summ(pool_max, pool_min, slots, found):
        pm = _pages(pool_max, slots).to(qg.dtype)             # [L,B,MP,H,D]
        pn = _pages(pool_min, slots).to(qg.dtype)
        s = torch.maximum(qg[:, :, None] * pm, qg[:, :, None] * pn)
        s = torch.sum(s, dim=(0, 3, 4))                        # [B, MP]
        return torch.where(found, s, -torch.inf)

    score = torch.where(
        ffound, summ(state.kmax_fast, state.kmin_fast, fslot, ffound),
        summ(state.kmax_slow, state.kmin_slow, sslot, sfound))
    score = torch.where(ffound | sfound, score, -torch.inf)
    # recent pages always win
    recent = pidx >= torch.clamp(n_pages[:, None] - cfg.recent_pages, min=0)
    score = torch.where(recent & exists, torch.inf, score)

    k = min(cfg.topk_pages, mp)
    top_score, top_idx = torch.sort(score, dim=1, descending=True,
                                    stable=True)
    top_score, top_idx = top_score[:, :k], top_idx[:, :k]
    return top_idx.to(torch.int32), top_score > -torch.inf


def gather_pages(state: PagedKVState, cfg: PagedKVConfig,
                 seq_ids: torch.Tensor, page_idx: torch.Tensor,
                 mask: torch.Tensor, *, backend: str = "reference"
                 ) -> tuple[PagedKVState, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Gather the selected pages for attention; returns (state', k, v,
    token_mask) with k/v [L, B, K*T, H, D].  Pages resident in the slow
    pool are read directly (charged as slow reads through the tier
    store); the access feeds the tracker (B1 on backend "cuda")."""
    b, k = page_idx.shape
    keys = page_key(cfg, seq_ids[:, None], page_idx)          # [B, K]
    flat = keys.reshape(-1)
    fslot, ffound = _fast_lookup(state.tier, flat)
    sslot, sfound = _slow_lookup(state.tier, flat)
    tier, _, _, _ = tiers.get_batch(state.tier, cfg.tier(), flat,
                                    mask.reshape(-1), backend=backend)
    m = mask.reshape(-1)
    use_fast = ffound & m
    use_slow = sfound & ~ffound & m
    have = use_fast | use_slow

    sel = use_fast[None, :, None, None, None]
    hv = have[None, :, None, None, None]
    out = []
    for fast, slow in ((state.k_fast, state.k_slow),
                       (state.v_fast, state.v_slow)):
        x = torch.where(sel, _pages(fast, fslot), _pages(slow, sslot)) \
            * hv.to(fast.dtype)
        l, _, t, h, d = x.shape
        out.append(x.reshape(l, b, k * t, h, d))

    # token-level mask: page valid AND token < seq_len at that page
    t = cfg.page_tokens
    pos = page_idx[..., None] * t + torch.arange(t, device=flat.device)
    tok_ok = (pos < state.seq_len[seq_ids.to(torch.int64)][:, None, None]) \
        & have.reshape(b, k)[..., None]
    return state._replace(tier=tier), out[0], out[1], tok_ok.reshape(b, k * t)


# --------------------------------------------------------------- compaction

def tail_page_keys(state: PagedKVState, cfg: PagedKVConfig) -> torch.Tensor:
    """Sorted keys of every active sequence's mutable tail page (must
    pin)."""
    sl = state.seq_len
    t = cfg.page_tokens
    tail = torch.clamp(torch.div(sl + t - 1, t, rounding_mode="floor") - 1,
                       min=0)
    keys = page_key(cfg, torch.arange(cfg.max_seqs, dtype=torch.int32,
                                      device=sl.device), tail)
    keys = torch.where(sl > 0, keys, 2**31 - 1)
    return torch.sort(keys).values


def movement_mirror(cfg: PagedKVConfig, backend: str = "reference"):
    """Engine mirror: replay each compaction's Movement on the page pools.
    The payload may carry ``tier=None`` (the engine owns the TierState)."""
    def mirror(payload: PagedKVState, mv: Movement) -> PagedKVState:
        return apply_movement(payload, cfg, mv, backend=backend)
    return mirror


def compact(state: PagedKVState, cfg: PagedKVConfig, rng: torch.Tensor,
            promote: bool = True, backend: str = "reference"):
    """One MSC compaction + the payload movement mirror."""
    tier, stats, mv = compaction.compact_once(
        state.tier, cfg.tier(), rng, promote=promote, with_movement=True,
        force_pin_keys=tail_page_keys(state, cfg), backend=backend)
    state = apply_movement(state, cfg, mv, backend=backend)._replace(
        tier=tier)
    return state, stats


def apply_movement(state: PagedKVState, cfg: PagedKVConfig, mv: Movement,
                   backend: str = "reference") -> PagedKVState:
    """Replay a compaction's physical moves on the page payload pools.

    Backend "cuda" runs the replay through the tier_compact movers
    (``apply_movement_pools``, pool axis 1: one conditional-source gather
    per merged row, the run write, the promotion scatter); "reference"
    is the same dataflow in plain tensor ops.  Both gathers read the pools
    as they were before the replay's first write."""
    if backend != "reference":
        from repro_torch.kernels.tier_compact.ops import apply_movement_pools
        pairs = [(state.k_fast, state.k_slow), (state.v_fast, state.v_slow),
                 (state.kmax_fast, state.kmax_slow),
                 (state.kmin_fast, state.kmin_slow)]
        moved = [apply_movement_pools(f, s, mv, pool_axis=1, backend=backend)
                 for f, s in pairs]
        (kf, ksl), (vf, vs), (kxf, kxs), (knf, kns) = moved
        return state._replace(k_fast=kf, v_fast=vf, k_slow=ksl, v_slow=vs,
                              kmax_fast=kxf, kmin_fast=knf, kmax_slow=kxs,
                              kmin_slow=kns)
    from_fast = mv.m_src_tier == 0
    pairs = [(state.k_fast, state.k_slow), (state.v_fast, state.v_slow),
             (state.kmax_fast, state.kmax_slow),
             (state.kmin_fast, state.kmin_slow)]
    srcs, pros = [], []
    for fast, slow in pairs:
        sel = from_fast.view((1, -1) + (1,) * (fast.dim() - 2))
        srcs.append(torch.where(sel, _pages(fast, mv.m_src_slot),
                                _pages(slow, mv.m_src_slot)))
        pros.append(_pages(slow, mv.p_src_slot))
    for (fast, slow), src, pro in zip(pairs, srcs, pros):
        _set_pages(slow, mv.m_valid, mv.m_dst_slot, src)
        _set_pages(fast, mv.p_valid, mv.p_dst_slot, pro)
    return state


def needs_compaction(state: PagedKVState, cfg: PagedKVConfig
                     ) -> torch.Tensor:
    return compaction.needs_compaction(state.tier, cfg.tier())
