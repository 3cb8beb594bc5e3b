"""Clock-based popularity tracker (PrismDB §4.3, §6).

A direct-mapped hash table with clock-protected overwrite, as in the JAX
package: a hit sets clock 3, an empty or clock-0 slot takes the new key,
an occupied slot with clock > 0 decays by one.  ``access_batched`` is the
canonical batched semantics and the plain version of the
``clock_update`` kernel (``repro_torch.kernels.clock_update``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.backend import resolve_device
from repro_torch.core.utils import count_into, hash_mod, set_where

CLOCK_MAX = 3  # 2-bit clock
LOC_FAST = 0
LOC_SLOW = 1
_I32_MIN, _I32_MAX = -2**31, 2**31 - 1


class TrackerState(NamedTuple):
    keys: torch.Tensor   # int32[T], -1 = empty
    clock: torch.Tensor  # int8[T] in [0, 3]
    loc: torch.Tensor    # int8[T]  0=fast tier, 1=slow tier

    @property
    def capacity(self) -> int:
        return int(self.keys.shape[0])


def init(capacity: int, device=None) -> TrackerState:
    device = resolve_device(device)
    return TrackerState(
        keys=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        clock=torch.zeros((capacity,), dtype=torch.int8, device=device),
        loc=torch.zeros((capacity,), dtype=torch.int8, device=device))


def slot_of(capacity: int, keys: torch.Tensor) -> torch.Tensor:
    return hash_mod(keys, capacity, salt=1)


def _segment(vals: torch.Tensor, gid: torch.Tensor, n: int, reduce: str,
             init: int) -> torch.Tensor:
    """``jax.ops.segment_{max,min}`` with n segments (empty = init)."""
    out = torch.full((n,), init, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, gid, vals, reduce=reduce,
                               include_self=True)


def access_batched(state: TrackerState, keys: torch.Tensor,
                   locs: torch.Tensor, valid: torch.Tensor) -> TrackerState:
    """Vectorized batch update (JAX ``tracker.access_batched``).

    Per slot, over the batch: any access matching the resident key ->
    clock 3 (loc of the last matching access); otherwise the LAST valid
    access targeting the slot is the insert candidate: resident entries
    with clock > 0 decay by 1, empty or clock-0 slots take the candidate
    (clock 3 if the batch accessed that key >= 2 times, else 0).
    Returns new tables; the input tables are left untouched."""
    n = keys.shape[0]
    t = state.capacity
    dev = keys.device
    i32 = torch.int32
    slots = torch.where(valid, slot_of(t, keys), t)
    sk = torch.where(valid, keys, torch.full_like(keys, -1))
    if n <= 512:
        occ = ((sk[None, :] == sk[:, None]) & valid[None, :]).sum(
            dim=1, dtype=i32)
    else:
        occ = occ_large(sk, valid)

    order = torch.argsort(slots, stable=True)
    s_sorted = slots[order]
    seg_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         s_sorted[1:] != s_sorted[:-1]])
    gid = torch.cumsum(seg_new, 0) - 1

    res_key = state.keys[s_sorted.clamp(0, t - 1)]
    match = (keys[order] == res_key) & (s_sorted < t)
    j_idx = torch.arange(n, dtype=torch.int64, device=dev)
    neg = torch.full_like(j_idx, -1)
    any_hit = _segment(match.to(i32), gid, n, "amax", _I32_MIN) > 0
    last_match = _segment(torch.where(match, j_idx, neg), gid, n, "amax",
                          _I32_MIN)
    last_cand = _segment(torch.where(s_sorted < t, j_idx, neg), gid, n,
                         "amax", _I32_MIN)
    seg_slot = _segment(torch.where(s_sorted < t, s_sorted,
                                    torch.full_like(s_sorted, t)),
                        gid, n, "amin", _I32_MAX)

    cand = order[last_cand.clamp(min=0)]
    hit_j = order[last_match.clamp(min=0)]
    sslot = seg_slot.clamp(0, t - 1)
    res_clock = state.clock[sslot].to(i32)
    res_empty = state.keys[sslot] < 0
    protect = ~any_hit & ~res_empty & (res_clock > 0)
    insert = ~any_hit & (res_empty | (res_clock == 0))

    new_key = torch.where(insert, keys[cand], state.keys[sslot])
    new_clock = torch.where(
        any_hit, CLOCK_MAX,
        torch.where(protect, res_clock - 1,
                    torch.where(occ[cand] >= 2, CLOCK_MAX, 0))).to(torch.int8)
    new_loc = torch.where(any_hit, locs[hit_j].to(torch.int8),
                          torch.where(insert, locs[cand].to(torch.int8),
                                      state.loc[sslot]))

    live = (seg_slot < t) & (last_cand >= 0)
    # one lane per segment, and segments are distinct slots: unique
    tk = set_where(state.keys.clone(), live, seg_slot, new_key)
    tc = set_where(state.clock.clone(), live, seg_slot, new_clock)
    tl = set_where(state.loc.clone(), live, seg_slot, new_loc)
    return TrackerState(tk, tc, tl)


def occ_large(sk: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """O(n log n) per-access count of its key in the batch (JAX
    ``tracker._occ_large``): sort + segment sums; 0 on invalid lanes."""
    n = sk.shape[0]
    dev = sk.device
    order = torch.argsort(sk, stable=True)
    s = sk[order]
    new_grp = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         s[1:] != s[:-1]])
    gid = torch.cumsum(new_grp, 0) - 1
    counts = torch.zeros(n, dtype=torch.int32, device=dev)
    counts.index_add_(0, gid, torch.ones(n, dtype=torch.int32, device=dev))
    occ = torch.zeros(n, dtype=torch.int32, device=dev)
    occ[order] = counts[gid]
    return torch.where(valid, occ, 0)


def lookup_clock(state: TrackerState, keys: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(clock int8, tracked) per key; untracked keys get clock 0."""
    slots = slot_of(state.capacity, keys)
    tracked = state.keys[slots] == keys
    clock = torch.where(tracked, state.clock[slots],
                        torch.zeros((), dtype=torch.int8, device=keys.device))
    return clock, tracked


def set_location(state: TrackerState, keys: torch.Tensor, loc: int,
                 valid: torch.Tensor) -> TrackerState:
    """Update location bits after demotion/promotion (only if still
    tracked).  Writes ``state.loc`` in place and returns the state.

    ``keys`` may repeat a tracked key: every hit slot gets ``loc``, as
    the JAX package's ``.at[].set`` gives (a scalar ``set_where``)."""
    slots = slot_of(state.capacity, keys)
    hit = (state.keys[slots] == keys) & valid
    set_where(state.loc, hit, slots, loc)
    return state


def clock_histogram(state: TrackerState) -> torch.Tensor:
    """int32[4] histogram of clock values over resident tracked keys."""
    resident = state.keys >= 0
    vals = torch.where(resident, state.clock.to(torch.int64), 4)
    return count_into(vals, 5)[:4].to(torch.int32)


def fast_fraction_of_tracked(state: TrackerState) -> torch.Tensor:
    """Fraction (f32) of tracked keys whose last access hit the fast tier."""
    resident = state.keys >= 0
    n = resident.sum(dtype=torch.int32).clamp(min=1)
    fast = (resident & (state.loc == LOC_FAST)).sum(dtype=torch.int32)
    return fast.to(torch.float32) / n.to(torch.float32)
