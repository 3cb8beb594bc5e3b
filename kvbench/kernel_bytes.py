"""The least work each kernel call of the main path needs, from its
shapes: each input byte read once, each output byte written once
(copied from the bound arithmetic of the port's kernel table, PERF.md's
Findings).  A call's bound time is the larger of its bytes over the
HBM rate and its operations over the float32 rate; the work stays the
same whatever kernel implements the call."""
from __future__ import annotations

import torch

from kvbench.peaks import F32_FLOPS, HBM_BYTES_PER_S

M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & M32


def tracker_slot(keys: torch.Tensor, capacity: int) -> torch.Tensor:
    """The CLOCK tracker's slot of each key: the store's 32-bit
    xorshift-multiply hash with salt 1, modulo the capacity."""
    x = (keys.to(torch.int64) & M32) ^ ((1 * 0x9E3779B9) & M32)
    x = _mul32(x, 2246822519)
    x = x ^ (x >> 15)
    x = _mul32(x, 2246822519)
    x = x ^ (x >> 13)
    return x % capacity


def bound_s(nbytes: float, flops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def clock_update(keys: torch.Tensor, valid: torch.Tensor,
                 capacity: int) -> float:
    """B1: the batch's keys (int32), locations (int8) and flags read
    once; each tracker slot the valid keys touch read and written once
    (key int32, clock int8, location int8)."""
    touched = torch.unique(tracker_slot(keys[valid], capacity)).numel()
    return bound_s(keys.shape[0] * (4 + 1 + 1) + touched * (6 + 6))


def msc_score(k: int, nb: int) -> float:
    """B2: K candidates' bounds and slow counts, B buckets' three counts
    and 4-bin clock histogram, 4 probabilities read; K scores and the
    pick written; 24 operations a candidate and bucket."""
    return bound_s(k * 4 * 4 + nb * 3 * 4 + nb * 16 + 16 + 8,
                   k * nb * 24)


def select_gather_rows(m: int, row_bytes: int) -> float:
    """B3: each of ``m`` rows read once and written once, its index
    (int32) and source flag read."""
    return bound_s(m * (2 * row_bytes + 5))


def scatter_rows(m: int, row_bytes: int, n_valid: int) -> float:
    """B4: each valid row read and written once with its index; every
    flag read."""
    return bound_s(n_valid * (2 * row_bytes + 4) + m)
