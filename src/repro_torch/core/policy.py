"""Read-triggered compaction state machine (PrismDB §5.3).

DETECT -> ACTIVE -> COOLDOWN, as in the JAX package.  The JAX
``lax.switch`` over the phase becomes: compute the three transitions and
select by phase on the device (no host read).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import tracker
from repro_torch.core.backend import resolve_device
from repro_torch.core.tiers import TierState

DETECT, ACTIVE, COOLDOWN = 0, 1, 2


class PolicyConfig(NamedTuple):
    epoch_ops: int = 1_000_000
    cooldown_ops: int = 10_000_000
    min_improvement: float = 0.01
    read_heavy_frac: float = 0.8      # reads/ops above this = read-dominated
    slow_tracked_frac: float = 0.3    # tracked-on-slow share that triggers
    compactions_per_epoch_step: int = 1
    detect_ops: int = 0               # DETECT rate window (0 -> epoch_ops)

    @property
    def detect_window(self) -> int:
        return self.detect_ops or self.epoch_ops


class PolicyState(NamedTuple):
    phase: torch.Tensor            # i32: DETECT / ACTIVE / COOLDOWN
    ops_mark: torch.Tensor         # i32 op counter at phase entry
    fast_hits_mark: torch.Tensor   # i32 ctr.hits_fast at epoch start
    gets_mark: torch.Tensor        # i32 ctr.gets at epoch start
    reads_mark: torch.Tensor       # i32 ctr.gets + ctr.scans at window start
    prev_ratio: torch.Tensor       # f32 fast-read ratio of previous epoch


def init(device=None) -> PolicyState:
    device = resolve_device(device)
    z = lambda: torch.zeros((), dtype=torch.int32, device=device)
    return PolicyState(phase=z(), ops_mark=z(), fast_hits_mark=z(),
                       gets_mark=z(), reads_mark=z(),
                       prev_ratio=torch.zeros((), dtype=torch.float32,
                                              device=device))


def _f32(x):
    return x.to(torch.float32)


def _fast_ratio(state: TierState, pol: PolicyState) -> torch.Tensor:
    d_gets = _f32(state.ctr.gets - pol.gets_mark)
    d_fast = _f32(state.ctr.hits[0] - pol.fast_hits_mark)
    return d_fast / d_gets.clamp(min=1.0)


def _f(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def step(pol: PolicyState, state: TierState, cfg: PolicyConfig,
         total_ops: torch.Tensor) -> tuple[PolicyState, torch.Tensor]:
    """Advance the state machine; returns (policy', should_compact_now)."""
    w = torch.where
    ctr = state.ctr
    hits_fast = ctr.hits[0]
    ops_in_phase = total_ops - pol.ops_mark
    reads = ctr.gets + ctr.scans
    reads_w = _f32(reads - pol.reads_mark)
    ops_w = _f32(ops_in_phase).clamp(min=1.0)
    read_heavy = reads_w / ops_w >= _f(cfg.read_heavy_frac, reads_w)
    window_full = ops_in_phase >= cfg.detect_window
    slow_tracked = (1.0 - tracker.fast_fraction_of_tracked(state.tracker)
                    ) >= _f(cfg.slow_tracked_frac, reads_w)
    ratio = _fast_ratio(state, pol)

    # DETECT
    trigger = window_full & read_heavy & slow_tracked
    moved = trigger | (window_full & ~trigger)
    d = PolicyState(
        phase=w(trigger, ACTIVE, DETECT).to(torch.int32),
        ops_mark=w(moved, total_ops, pol.ops_mark),
        fast_hits_mark=w(moved, hits_fast, pol.fast_hits_mark),
        gets_mark=w(moved, ctr.gets, pol.gets_mark),
        reads_mark=w(moved, reads, pol.reads_mark),
        prev_ratio=w(trigger, ratio, pol.prev_ratio))
    # ACTIVE
    epoch_done = ops_in_phase >= cfg.epoch_ops
    improved = (ratio - pol.prev_ratio) >= _f(cfg.min_improvement, ratio)
    cool = epoch_done & ~improved
    a = PolicyState(
        phase=w(cool, COOLDOWN, ACTIVE).to(torch.int32),
        ops_mark=w(epoch_done, total_ops, pol.ops_mark),
        fast_hits_mark=w(epoch_done, hits_fast, pol.fast_hits_mark),
        gets_mark=w(epoch_done, ctr.gets, pol.gets_mark),
        reads_mark=w(epoch_done, reads, pol.reads_mark),
        prev_ratio=w(epoch_done, ratio, pol.prev_ratio))
    # COOLDOWN
    done = ops_in_phase >= cfg.cooldown_ops
    c = PolicyState(
        phase=w(done, DETECT, COOLDOWN).to(torch.int32),
        ops_mark=w(done, total_ops, pol.ops_mark),
        fast_hits_mark=w(done, hits_fast, pol.fast_hits_mark),
        gets_mark=w(done, ctr.gets, pol.gets_mark),
        reads_mark=w(done, reads, pol.reads_mark),
        prev_ratio=pol.prev_ratio)

    is_d, is_a = pol.phase == DETECT, pol.phase == ACTIVE
    newp = PolicyState(*[w(is_d, x, w(is_a, y, z))
                         for x, y, z in zip(d, a, c)])
    go = w(is_d, trigger, w(is_a, ~cool, torch.zeros_like(cool)))
    return newp, go
