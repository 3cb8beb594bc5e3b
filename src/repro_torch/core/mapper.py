"""Mapper: clock-value distribution -> pinning decisions (PrismDB §4.3).

Walk clock values 3 -> 0 pinning whole classes while the budget lasts;
the boundary class is pinned with probability ``remaining / class_size``.
Untracked objects never pin.  Float32 throughout, in the JAX package's
operation order, so the probabilities agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.utils import fdiv

N_CLOCK = 4


def pin_probabilities(hist: torch.Tensor, threshold) -> torch.Tensor:
    """float32[4]: probability that an object with clock value c pins.
    ``threshold`` is the target pinned fraction of tracked objects (a
    float32 tensor or a Python float)."""
    f32 = torch.float32
    hist = hist.to(f32)
    if not torch.is_tensor(threshold):
        threshold = torch.full((), threshold, dtype=f32, device=hist.device)
    total = hist.sum().clamp(min=1.0)
    budget = threshold * total
    desc = hist.flip(0)                                   # [c3, c2, c1, c0]
    cum_above = torch.cat([torch.zeros(1, dtype=f32, device=hist.device),
                           torch.cumsum(desc, 0)[:-1]])
    remaining = (budget - cum_above).clamp(min=0.0)
    probs_desc = (remaining / desc.clamp(min=1.0)).clamp(0.0, 1.0)
    probs_desc = torch.where(desc > 0, probs_desc, (remaining > 0).to(f32))
    return probs_desc.flip(0)                             # [c0, c1, c2, c3]


def pin_decisions(clock: torch.Tensor, tracked: torch.Tensor,
                  probs: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Bernoulli pin decision per object (untracked objects never pin);
    the uniforms are ``jax.random.uniform(key, clock.shape)`` bit for bit."""
    p = probs[clock.to(torch.int64).clamp(0, N_CLOCK - 1)]
    p = torch.where(tracked, p, torch.zeros_like(p))
    u = prng.uniform(key, tuple(clock.shape), device=clock.device)
    return u < p


def expected_pinned_fraction(hist: torch.Tensor, probs: torch.Tensor
                             ) -> torch.Tensor:
    """The share of tracked objects expected to pin: the clock
    histogram ``hist`` weighted by the pin probabilities ``probs``
    (float32)."""
    hist = hist.to(torch.float32)
    return torch.sum(hist * probs) / torch.clamp(torch.sum(hist), min=1.0)


def coldness_from_clock(clock: torch.Tensor, tracked: torch.Tensor
                        ) -> torch.Tensor:
    """coldness(j) = 1 / (clock_j + 1); untracked -> coldness 1."""
    c = torch.where(tracked, clock.to(torch.float32),
                    torch.zeros((), dtype=torch.float32, device=clock.device))
    return fdiv(1.0, c + 1.0)
