"""Per-run Bloom filters, kept on the fast tier (PrismDB §4.1).

The JAX package holds the filters as ``uint32[R, W]``; the port keeps
int32 tensors with the same bit pattern (torch has no right shift on
uint32 on the CPU), so the filters carry across bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.backend import resolve_device
from repro_torch.core.utils import M32, hash_u32, to_i32


def init(n_runs: int, bits_per_run: int, device=None) -> torch.Tensor:
    if bits_per_run % 32:
        raise ValueError("bits_per_run must be a multiple of 32")
    return torch.zeros((n_runs, bits_per_run // 32), dtype=torch.int32,
                       device=resolve_device(device))


def _positions(keys: torch.Tensor, n_bits: int, k_hashes: int
               ) -> torch.Tensor:
    """[k, n] bit positions via double hashing: h1 + i*h2 mod n_bits
    (uint32 wrap of the sum, as in the JAX package)."""
    h1 = hash_u32(keys, salt=2)
    h2 = hash_u32(keys, salt=3) | 1
    i = torch.arange(k_hashes, dtype=torch.int64, device=keys.device)[:, None]
    return ((h1[None, :] + i * h2[None, :]) & M32) % n_bits


def make_rows(keys: torch.Tensor, row_of: torch.Tensor, valid: torch.Tensor,
              n_rows: int, n_words: int, k_hashes: int = 4) -> torch.Tensor:
    """Build ``n_rows`` filter rows at once: row r holds the valid keys
    with ``row_of == r``.  Scatter-add into a [rows, words, 32] count plane,
    then one repack; int32 rows with the uint32 bit pattern."""
    n_bits = n_words * 32
    pos = _positions(keys, n_bits, k_hashes)                 # [k, n]
    flat = (row_of.to(torch.int64).clamp(0, n_rows - 1)[None, :] * n_bits
            + pos).reshape(-1)
    upd = valid[None, :].expand(pos.shape).reshape(-1).to(torch.int32)
    counts = torch.zeros(n_rows * n_bits, dtype=torch.int32,
                         device=keys.device)
    counts.index_add_(0, flat, upd)
    bits = (counts.view(n_rows, n_words, 32) > 0).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=keys.device)
    words = (bits << shifts).sum(dim=2)
    return to_i32(words)


def make_row(keys: torch.Tensor, valid: torch.Tensor, n_words: int,
             k_hashes: int = 4) -> torch.Tensor:
    """One filter row containing ``keys[valid]``."""
    return make_rows(keys, torch.zeros_like(keys), valid, 1, n_words,
                     k_hashes)[0]


def set_run(filters: torch.Tensor, run_id, keys: torch.Tensor,
            valid: torch.Tensor, k_hashes: int = 4) -> torch.Tensor:
    """``filters`` with row ``run_id`` replaced by a fresh filter over
    ``keys[valid]`` (a new tensor; ``filters`` is kept)."""
    out = filters.clone()
    out[run_id] = make_row(keys, valid, filters.shape[1], k_hashes)
    return out


def clear_run(filters: torch.Tensor, run_id) -> torch.Tensor:
    """``filters`` with row ``run_id`` emptied (a new tensor)."""
    out = filters.clone()
    out[run_id] = 0
    return out


def query(filters: torch.Tensor, run_ids: torch.Tensor, keys: torch.Tensor,
          k_hashes: int = 4) -> torch.Tensor:
    """bool[R, n]: might run ``run_ids[r]`` contain ``keys[j]``?"""
    n_bits = filters.shape[1] * 32
    pos = _positions(keys, n_bits, k_hashes)                 # [k, n]
    word, bit = pos // 32, pos % 32
    rows = filters[run_ids.to(torch.int64)]                  # [R, W]
    got = rows[:, word].to(torch.int64)                      # [R, k, n]
    hit = (got >> bit[None]) & 1
    return (hit == 1).all(dim=1)


def query_per_key(filters: torch.Tensor, run_of_key: torch.Tensor,
                  keys: torch.Tensor, k_hashes: int = 4) -> torch.Tensor:
    """bool[n]: might run ``run_of_key[j]`` contain ``keys[j]``?
    Entries < 0 return False (no covering run)."""
    n_bits = filters.shape[1] * 32
    pos = _positions(keys, n_bits, k_hashes)                 # [k, n]
    word, bit = pos // 32, pos % 32
    rows = run_of_key.to(torch.int64).clamp(min=0)[None, :]
    got = filters[rows, word].to(torch.int64)                # [k, n]
    hit = (got >> bit) & 1
    return (hit == 1).all(dim=0) & (run_of_key >= 0)
