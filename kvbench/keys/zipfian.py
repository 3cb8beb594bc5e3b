"""YCSB's bounded zipfian key distribution (Gray et al., SIGMOD 1994, as
YCSB's ``ZipfianGenerator``), scrambled onto the key domain by an affine
bijection, so the hot keys spread over the key space and its runs.

Copied from ``chip_smoke.Zipf`` (its zeta sum, ``eta``, ``alpha`` and
the rank formula), with the draws made on the device from a
``torch.Generator``: the yardstick keeps its own copy, so it does not
move when the program's does.
"""
from __future__ import annotations

import torch

SCRAMBLE_MUL, SCRAMBLE_ADD = 2654435761, 12345
CHUNK = 1 << 24


class Zipf:
    """Ranks in ``[0, n)`` with P(rank r) proportional to 1 / (r + 1)^theta,
    mapped to keys ``(r * 2654435761 + 12345) % n``."""

    def __init__(self, n: int, theta: float = 0.99, device="cpu"):
        self.n, self.theta = int(n), float(theta)
        z = torch.zeros((), dtype=torch.float64, device=device)
        for a in range(1, self.n + 1, CHUNK):
            r = torch.arange(a, min(self.n, a + CHUNK - 1) + 1,
                             dtype=torch.float64, device=device)
            z += r.pow_(-self.theta).sum()
        self.zetan = float(z)
        self.zeta2 = 1.0 + 0.5 ** self.theta
        self.alpha = 1.0 / (1.0 - self.theta)
        self.eta = ((1 - (2.0 / self.n) ** (1 - self.theta))
                    / (1 - self.zeta2 / self.zetan))

    def ranks(self, u: torch.Tensor) -> torch.Tensor:
        """Ranks (int64) of uniform draws ``u`` in [0, 1) (float64)."""
        uz = u * self.zetan
        rank = torch.floor(self.n * (self.eta * u - self.eta + 1)
                           .pow(self.alpha))
        rank = torch.where(uz < 1.0, 0.0,
                           torch.where(uz < self.zeta2, 1.0, rank))
        return rank.clamp(0, self.n - 1).to(torch.int64)

    def keys(self, gen: torch.Generator, size: int) -> torch.Tensor:
        """``size`` scrambled keys (int32) on the generator's device."""
        out = torch.empty(size, dtype=torch.int32, device=gen.device)
        for a in range(0, size, CHUNK):
            b = min(size, a + CHUNK)
            u = torch.rand(b - a, dtype=torch.float64, device=gen.device,
                           generator=gen)
            r = self.ranks(u)
            out[a:b] = ((r * SCRAMBLE_MUL + SCRAMBLE_ADD) % self.n).to(
                torch.int32)
        return out


def sampler(spec: dict, n: int, device) -> Zipf:
    """The distribution a traffic file's ``keys`` entry asks for over a
    domain of ``n`` keys (``theta``, default YCSB's 0.99)."""
    return Zipf(n, spec.get("theta", 0.99), device)
