"""Modeled per-op service costs (paper Table 1 + §2), the port's own copy.

The constants ride inside ``ObsConfig`` (and from there
``EngineConfig``); the arithmetic is float32 in the JAX package's
operation order, one torch op at a time (no fused multiply-add), so the
modeled costs agree bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TierCost(NamedTuple):
    """Per-op service costs of ONE storage tier, in microseconds."""
    read_us: float
    write_us: float
    seq_read_us_per_obj: float
    seq_write_us_per_obj: float


class CostModel(NamedTuple):
    """Per-op service costs in microseconds (paper Table 1)."""
    fast_read_us: float = 6.0                # Optane 4KB random read
    fast_write_us: float = 10.0
    slow_read_us: float = 391.0              # QLC 4KB random read
    slow_seq_read_us_per_obj: float = 0.5    # ~2 GB/s sequential, 1KB objs
    slow_seq_write_us_per_obj: float = 1.0   # ~1 GB/s sequential
    tiers: tuple = ()                        # tuple[TierCost, ...] or ()

    def tier(self, i: int) -> TierCost:
        if self.tiers:
            return TierCost(*self.tiers[i])
        if i == 0:
            return TierCost(self.fast_read_us, self.fast_write_us,
                            self.fast_read_us, self.fast_write_us)
        return TierCost(self.slow_read_us, self.slow_read_us,
                        self.slow_seq_read_us_per_obj,
                        self.slow_seq_write_us_per_obj)

    def resolve(self, n_tiers: int) -> tuple:
        """``n_tiers``-length TierCost tuple (legacy fields expanded);
        raises when an explicit vector has another length."""
        if self.tiers and len(self.tiers) != n_tiers:
            raise ValueError(
                f"CostModel.tiers has {len(self.tiers)} entries, "
                f"engine has {n_tiers} tiers")
        return tuple(self.tier(i) for i in range(n_tiers))


def step_io_us(delta, cost: CostModel,
               fast_write_amp: float = 1.0) -> torch.Tensor:
    """Modeled I/O microseconds (f32) of one engine step from its counter
    deltas: tier 0's random charges, then each lower tier's (client,
    seq-read, seq-write) triple in tier order."""
    f32 = torch.float32
    n = int(delta.hits.shape[-1])
    c0 = cost.tier(0)
    total = (delta.reads[0].to(f32) * c0.read_us
             + delta.writes[0].to(f32) * (c0.write_us * fast_write_amp))
    for t in range(1, n):
        ct = cost.tier(t)
        seq = (delta.comp_reads[t] + delta.scan_reads[t]).to(f32)
        client = (delta.reads[t].to(f32) - seq).clamp(min=0.0)
        total = (total + client * ct.read_us
                 + seq * ct.seq_read_us_per_obj
                 + delta.writes[t].to(f32) * ct.seq_write_us_per_obj)
    return total


def compaction_io_us(stats, cost: CostModel, fast_write_amp: float = 1.0,
                     boundary: int = 0) -> torch.Tensor:
    """Modeled I/O microseconds (f32) of ONE compaction, attributed as
    ``compact_once`` charges its counters."""
    f32 = torch.float32
    up, lo = cost.tier(boundary), cost.tier(boundary + 1)
    return (stats.n_run_read.to(f32) * lo.seq_read_us_per_obj
            + stats.n_run_written.to(f32) * lo.seq_write_us_per_obj
            + stats.n_demoted.to(f32) * up.read_us
            + stats.n_promoted.to(f32) * (up.write_us * fast_write_amp))


def boundary_io_us(n_up_read: torch.Tensor, n_lo_read: torch.Tensor,
                   n_written: torch.Tensor, cost: CostModel,
                   boundary: int) -> torch.Tensor:
    """Modeled I/O microseconds (f32) of a deep (run-to-run) compaction at
    ``boundary``: both source windows are sequential run reads priced per
    tier, the merged output a sequential write into the lower tier."""
    f32 = torch.float32
    up, lo = cost.tier(boundary), cost.tier(boundary + 1)
    return (n_up_read.to(f32) * up.seq_read_us_per_obj
            + n_lo_read.to(f32) * lo.seq_read_us_per_obj
            + n_written.to(f32) * lo.seq_write_us_per_obj)


def drain_io_us(run_read: torch.Tensor, run_written: torch.Tensor,
                fast_read: torch.Tensor, fast_write: torch.Tensor,
                cost: CostModel, fast_write_amp: float = 1.0) -> torch.Tensor:
    """Modeled I/O microseconds (f32) of one compaction QUANTUM, the slice
    of an in-flight migration drained in one engine step
    (``compaction.drain_quantum``).  Quantized jobs are boundary 0, so the
    categories are ``compaction_io_us``'s, and a job's quanta sum to its
    run-to-completion charge."""
    f32 = torch.float32
    up, lo = cost.tier(0), cost.tier(1)
    return (run_read.to(f32) * lo.seq_read_us_per_obj
            + run_written.to(f32) * lo.seq_write_us_per_obj
            + fast_read.to(f32) * up.read_us
            + fast_write.to(f32) * (up.write_us * fast_write_amp))
