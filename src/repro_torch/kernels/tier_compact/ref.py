"""Plain PyTorch versions of the tier_compact row movers (the JAX
package's ``kernels/tier_compact/ref.py``).

Gathers clamp each index into ``[0, P - 1]``, as a JAX gather does.  The
scatter writes the pool IN PLACE through ``utils.set_where`` (an exact
integer scatter-add of bit differences): invalid or out-of-range rows
write nothing, with no host read and no trash row.
"""
from __future__ import annotations

import torch

from repro_torch.core.utils import set_where


def gather_rows_ref(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pool [P, W], idx [M] -> [M, W]."""
    return pool[idx.to(torch.int64).clamp(0, pool.shape[0] - 1)]


def select_gather_rows_ref(fast_pool: torch.Tensor, slow_pool: torch.Tensor,
                           src_slow: torch.Tensor, idx: torch.Tensor
                           ) -> torch.Tensor:
    """out[i] = (slow if src_slow[i] else fast)[idx[i]].  Gathers from
    both pools and selects: the single-read form is the kernel's job."""
    return torch.where(src_slow[:, None], gather_rows_ref(slow_pool, idx),
                       gather_rows_ref(fast_pool, idx))


def scatter_rows_ref(pool: torch.Tensor, idx: torch.Tensor,
                     rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """pool[idx[i]] = rows[i] where valid[i] (valid idx unique), in place;
    returns ``pool``."""
    return set_where(pool, valid, idx.to(torch.int64), rows)
