"""Shared helpers for the port's core: hashing, sorted-index ops, masking.

Conventions (as in the JAX package):
  * keys are int32 in ``[0, key_space)``
  * ``-1`` marks a free pool slot
  * ``PADKEY = 2**31 - 1`` pads sorted indices (sorts after every real key)
  * variable-size sets are carried as ``(tensor, mask)`` pairs of static
    shape, so no helper here reads a value back to the host.

uint32 hashing runs in int64 with ``& 0xFFFFFFFF`` masks (torch has no
right shift on uint32 on the CPU).  ``x.at[i].set(v, mode="drop")`` of
the JAX package becomes ``set_where``: lanes that are masked off or out
of range must write nothing, and the CUDA scatter has no drop mode.
"""
from __future__ import annotations

import torch

PADKEY = 2**31 - 1
M32 = 0xFFFFFFFF

# Knuth multiplicative hashing constants (distinct streams per use-site).
_HASH_MULS = (2654435761, 2246822519, 3266489917, 668265263, 374761393)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), overflow-free."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & M32


def u32(keys: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 holding the uint32 value."""
    return keys.to(torch.int64) & M32


def hash_u32(keys: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """Deterministic 32-bit mix of int32 keys (xorshift-multiply); int64
    result in [0, 2**32), equal to the JAX package's uint32 hash."""
    x = u32(keys) ^ ((salt * 0x9E3779B9) & M32)
    x = mul32(x, _HASH_MULS[salt % len(_HASH_MULS)])
    x = x ^ (x >> 15)
    x = mul32(x, 2246822519)
    x = x ^ (x >> 13)
    return x


def hash_mod(keys: torch.Tensor, n: int, salt: int = 0) -> torch.Tensor:
    """Hash keys into ``[0, n)`` (int64)."""
    return hash_u32(keys, salt) % n


def mix32(x: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """Splitmix-style 32-bit finalizer (murmur3 fmix32 constants)."""
    x = u32(x) ^ ((salt * 0x9E3779B9) & M32)
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def part_of_key(keys: torch.Tensor, n_parts: int, salt: int = 4
                ) -> torch.Tensor:
    """Owning partition of each key (int32): ``mix32`` then modulo.  The
    one rule of key placement, shared by ``db.route_batch`` and the
    process-group exchange (``distributed.collectives.exchange_keys``)."""
    return (mix32(keys, salt) % n_parts).to(torch.int32)


def pack_buckets(keys: torch.Tensor, part: torch.Tensor, n: int, cap: int,
                 valid: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter a batch into ``[n, cap]`` per-destination buckets, in-batch
    order kept within a bucket (a stable sort).  Returns ``(buckets,
    bucket_valid, dropped)``: empty slots hold -1, and the lanes beyond
    ``cap`` in one bucket are counted in the per-destination ``dropped``
    (int32[n]).  ``valid=None`` treats every lane live; invalid lanes
    land nowhere and count nowhere.  Overflow and invalid lanes write to
    a spare row ``n`` that is cut off (torch has no drop mode)."""
    b = keys.shape[0]
    dev = keys.device
    if valid is None:
        valid = torch.ones(b, dtype=torch.bool, device=dev)
    part = torch.where(valid, part.to(torch.int64), n)
    part_s, order = torch.sort(part, stable=True)
    keys_s = keys[order].to(torch.int32)
    rank = torch.arange(b, device=dev) - torch.searchsorted(part_s, part_s)
    ok = rank < cap
    tgt = torch.where(ok, part_s, n)
    out = torch.full(((n + 1) * cap,), -1, dtype=torch.int32, device=dev)
    out.index_put_((tgt * cap + rank.clamp(0, cap - 1),), keys_s)
    out = out.view(n + 1, cap)[:n]
    dropped = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    dropped.index_add_(0, part_s, (~ok).to(torch.int32))
    return out, out >= 0, dropped[:n]


def fdiv(a, b) -> torch.Tensor:
    """IEEE float32 division ``a / b`` where either side may be a Python
    number.  torch computes ``number / tensor`` as ``reciprocal * number``,
    and on CUDA ``tensor / number`` as ``tensor * (1 / number)``: both
    can round differently from the JAX package's division, so constants
    become 0-dim tensors on the operand's device first."""
    like = a if torch.is_tensor(a) else b
    if not torch.is_tensor(a):
        a = torch.full((), a, dtype=like.dtype, device=like.device)
    if not torch.is_tensor(b):
        b = torch.full((), b, dtype=like.dtype, device=like.device)
    return torch.div(a, b)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value -> int32 with the same bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


# ------------------------------------------------------- masked scatters

def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-dim device index without a host read (indexing
    with a 0-dim tensor reads it back to select)."""
    return x.index_select(0, i.reshape(1)).squeeze(0)


def count_into(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(idx, minlength=n)`` (int64) for ``0 <= idx < n < 2**24``
    and fewer than 2**24 elements.  CUDA's bincount reads the maximum back
    to the host to size its output, and a scatter-add into a few bins
    serialises on atomics (tens of ms over a 10 M-slot tracker); histc
    with explicit bounds does neither, and is exact here: integer values
    and counts below 2**24 are exact in float32, and bin ``(x - 0) * n / n``
    is ``x``."""
    return torch.histc(idx.to(torch.float32), bins=n, min=0, max=n).to(
        torch.int64)


_BITS = {torch.float32: torch.int32, torch.int32: torch.int32,
         torch.bfloat16: torch.int16, torch.int8: torch.int8,
         torch.bool: torch.uint8, torch.int64: torch.int64}


def set_where(dst: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor,
              vals) -> torch.Tensor:
    """In place: ``dst[idx[i]] = vals[i]`` for every lane with ``mask[i]``
    and ``0 <= idx[i] < len(dst)``; other lanes write nothing (the JAX
    package's ``.at[].set(mode="drop")``).  Returns ``dst``.

    The rule: a scalar ``vals`` may repeat a target, a tensor ``vals``
    may not.  A scalar is written by marking the active targets in a
    mask one longer than ``dst`` (inactive lanes mark the spare entry)
    and filling the value in where the mask is set, so a target hit n
    times still gets the value.  A tensor is written as an exact integer
    scatter-add of bit-pattern differences: on the integer view of
    ``dst`` each active lane adds ``new - old`` (wrapping), each inactive
    lane adds 0 at a clamped target -- inactive lanes cannot clobber an
    active target, but a repeated active target would get the sum of
    its differences, so each caller that passes a tensor guarantees
    unique active targets.  Neither form reads back to the host or has
    a data-dependent shape."""
    n = dst.shape[0]
    ok = mask & (idx >= 0) & (idx < n)
    if not (torch.is_tensor(vals) and vals.dim() > 0):
        hit = torch.zeros(n + 1, dtype=torch.bool, device=dst.device)
        hit.index_fill_(0, torch.where(ok, idx, n).to(torch.int64), True)
        return dst.masked_fill_(hit[:n].view((n,) + (1,) * (dst.dim() - 1)),
                                vals)
    tgt = torch.where(ok, idx, 0)
    bits = dst.view(_BITS[dst.dtype])
    old = bits[tgt]
    new = vals.to(dst.dtype).view(bits.dtype)
    okb = ok.view((-1,) + (1,) * (old.dim() - 1))
    bits.index_add_(0, tgt, torch.where(okb, new - old, 0))
    return dst


def add_where(dst: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor,
              vals) -> torch.Tensor:
    """In place: ``dst[idx[i]] += vals[i]`` on active in-range lanes
    (integer ``dst``: exact in any order).  Returns ``dst``."""
    n = dst.shape[0]
    idx = idx.to(torch.int64)
    ok = mask & (idx >= 0) & (idx < n)
    if not torch.is_tensor(vals):
        vals = torch.full(idx.shape, vals, dtype=dst.dtype,
                          device=dst.device)
    vals = torch.where(ok, vals.to(dst.dtype), torch.zeros_like(
        vals, dtype=dst.dtype))
    dst.index_add_(0, idx.clamp(0, n - 1), vals)
    return dst


def nonzero_fixed(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)[0]`` as int64,
    without a host read: the j-th set position is the first index whose
    inclusive prefix count reaches j + 1."""
    n = mask.shape[0]
    cum = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32)
    q = torch.arange(1, size + 1, dtype=torch.int32, device=mask.device)
    pos = torch.searchsorted(cum, q)
    return torch.where(pos < n, pos, torch.full_like(pos, fill))


# ------------------------------------------------------------ sorted index

def searchsorted(sorted_keys: torch.Tensor, query: torch.Tensor
                 ) -> torch.Tensor:
    """``jnp.searchsorted`` (side="left"); accepts a 0-dim query."""
    q = query.to(sorted_keys.dtype)
    if q.dim() == 0:
        return torch.searchsorted(sorted_keys, q.view(1))[0]
    return torch.searchsorted(sorted_keys, q.contiguous())


def sorted_lookup(index_keys: torch.Tensor, index_vals: torch.Tensor,
                  query: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Look up ``query`` keys in a PADKEY-padded sorted index.
    Returns ``(vals, found)``; ``vals`` is garbage where not found."""
    pos = searchsorted(index_keys, query).clamp(0, index_keys.shape[0] - 1)
    return index_vals[pos], index_keys[pos] == query


def build_sorted_index(pool_keys: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sorted_keys, slot_of_sorted); free slots sort to the end."""
    k = torch.where(pool_keys < 0, torch.full_like(pool_keys, PADKEY),
                    pool_keys)
    order = torch.argsort(k, stable=True)
    return k[order], order.to(torch.int32)


def merge_index_update(idx_keys: torch.Tensor, idx_slots: torch.Tensor,
                       drop: torch.Tensor, ins_keys: torch.Tensor,
                       ins_slots: torch.Tensor, ins_valid: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Incremental sorted-index maintenance (JAX ``merge_index_update``):
    entries whose pool slot is marked in ``drop`` become pads, the
    batch ``ins_*`` merges in; O(N) data movement, no full re-sort.
    Pad-entry slot values follow the JAX package exactly."""
    n = idx_keys.shape[0]
    dev = idx_keys.device
    i32 = torch.int32
    live0 = idx_keys != PADKEY
    dead = live0 & drop[idx_slots.clamp(0, n - 1)]
    live_b = live0 & ~dead

    ik = torch.where(ins_valid, ins_keys,
                     torch.full_like(ins_keys, PADKEY))
    order = torch.argsort(ik, stable=True)
    ik, islot = ik[order], ins_slots[order]
    ilive = ik != PADKEY
    n_ins = ilive.sum(dtype=i32)

    dead_cum = torch.cumsum(dead, 0, dtype=i32)
    p = searchsorted(idx_keys, ik)
    dead_below = torch.where(p > 0, dead_cum[(p - 1).clamp(min=0)], 0)
    rank_i = torch.cumsum(ilive, 0, dtype=i32) - 1
    pos_i = torch.where(ilive, rank_i + p - dead_below, n).clamp(max=n)

    hist = torch.zeros(n + 1, dtype=i32, device=dev)
    hist.index_add_(0, torch.where(ilive & (p < n), p, n),
                    torch.ones_like(p, dtype=i32))
    below_i = torch.cumsum(hist[:n], 0, dtype=i32)
    rank_b = torch.cumsum(live_b, 0, dtype=i32) - 1
    pos_b = torch.where(live_b, rank_b + below_i, n).clamp(max=n)

    n_live = rank_b[-1] + 1 + n_ins
    rank_p = torch.cumsum(~live_b, 0, dtype=i32) - 1
    pos_p = torch.where(~live_b, n_live + rank_p, n).clamp(max=n)

    out_keys = torch.full((n + 1,), PADKEY, dtype=i32, device=dev)
    out_slots = torch.zeros(n + 1, dtype=i32, device=dev)
    out_keys.index_put_((pos_b,), idx_keys)
    out_slots.index_put_((pos_b,), idx_slots)
    out_slots.index_put_((pos_p,), idx_slots)
    out_keys.index_put_((pos_i,), ik)
    out_slots.index_put_((pos_i,), islot.to(i32))
    return out_keys[:n], out_slots[:n]


def alloc_slots(pool_keys: torch.Tensor, want_mask: torch.Tensor
                ) -> torch.Tensor:
    """One free slot per True in ``want_mask`` (lowest-numbered first);
    int32, -1 where not wanted or the pool is full."""
    m = int(want_mask.shape[0])
    free = pool_keys < 0
    req_rank = torch.cumsum(want_mask, 0, dtype=torch.int32) - 1
    free_slots = nonzero_fixed(free, m, -1).to(torch.int32)
    slots = torch.where(want_mask,
                        free_slots[req_rank.long().clamp(0, m - 1)], -1)
    n_free = free.sum(dtype=torch.int32)
    return torch.where(want_mask & (req_rank < n_free), slots,
                       -1).to(torch.int32)


def dedupe_keep_last(keys: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """Mask keeping only the LAST occurrence of each valid key."""
    n = keys.shape[0]
    k = torch.where(valid, keys, torch.full_like(keys, PADKEY))
    order = torch.argsort(k, stable=True)
    ks = k[order]
    is_last = torch.cat([ks[:-1] != ks[1:],
                         torch.ones(1, dtype=torch.bool, device=k.device)])
    keep = torch.zeros(n, dtype=torch.bool, device=k.device)
    keep[order] = is_last & (ks != PADKEY)
    return keep & valid


def segment_in_range(sorted_keys: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, cap: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions of sorted_keys in [lo, hi), capped at ``cap``: int64
    positions clipped in-bounds, and their mask."""
    start = searchsorted(sorted_keys, lo)
    end = searchsorted(sorted_keys, hi)
    pos = start + torch.arange(cap, dtype=torch.int64,
                               device=sorted_keys.device)
    mask = pos < end
    return pos.clamp(0, sorted_keys.shape[0] - 1), mask
