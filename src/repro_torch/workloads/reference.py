"""Host (numpy) reference samplers + analytic distributions (the port's
own copy of the JAX package's ``workloads/reference.py``).

These mirror the sampler's bounded inverse-CDF math (same formula, same
uint32 scramble) so distribution tests can compare the sampler against
them and both against the analytic rank pmf.  The old host generator's
``(rng.zipf(a, n) - 1) % key_space`` folded numpy's unbounded tail back
onto the low ranks (the modulo-aliasing bias); these do not.
"""
from __future__ import annotations

import numpy as np

from repro_torch.workloads.sampler import SCRAMBLE_MUL


def _theta(theta: float) -> float:
    t = max(theta, 1e-3)
    return t + 2e-4 if abs(t - 1.0) < 1e-4 else t


def zipf_rank_pmf(key_space: int, theta: float) -> np.ndarray:
    """Analytic pmf over ranks of the bounded inverse-CDF zipfian:
    P(rank=r) = ((r+2)^(1-t) - (r+1)^(1-t)) / (N^(1-t) - 1)."""
    t = _theta(theta)
    edges = np.power(np.arange(key_space + 1, dtype=np.float64) + 1, 1 - t)
    return (edges[1:] - edges[:-1]) / (key_space ** (1 - t) - 1)


def ranks_from_uniforms_host(u: np.ndarray, key_space: int,
                             theta: float) -> np.ndarray:
    """The inverse-CDF transform alone (float32 math, as the sampler's
    ``zipf_ranks``)."""
    t = _theta(theta)
    c = np.float32(key_space) ** np.float32(1 - t)
    ranks = ((c - 1) * np.asarray(u, np.float32) + 1) \
        ** np.float32(1 / (1 - t)) - 1
    return np.clip(ranks, 0, key_space - 1).astype(np.int32)


def zipf_ranks_host(rng: np.random.Generator, theta: float, n: int,
                    key_space: int) -> np.ndarray:
    """Bounded inverse-CDF zipfian ranks from numpy's generator."""
    return ranks_from_uniforms_host(rng.random(n, dtype=np.float32),
                                    key_space, theta)


def scramble_host(ranks, offset: int, key_space: int) -> np.ndarray:
    """uint32-wraparound mirror of ``sampler.scramble``."""
    x = (np.asarray(ranks).astype(np.int64) + offset).astype(np.uint32)
    x = (x * np.uint32(SCRAMBLE_MUL)).astype(np.uint32)
    return (x % np.uint32(key_space)).astype(np.int32)


def zipf_keys_host(rng: np.random.Generator, theta: float, n: int,
                   key_space: int, hot_offset: int = 0) -> np.ndarray:
    """Host zipfian keys: bounded ranks, then the shared scramble."""
    return scramble_host(zipf_ranks_host(rng, theta, n, key_space),
                         hot_offset, key_space)


def latest_keys_host(rng: np.random.Generator, theta: float, n: int,
                     key_space: int, ptr: int) -> np.ndarray:
    """YCSB-"latest": recency ranks behind the insert pointer."""
    ranks = zipf_ranks_host(rng, theta, n, key_space)
    return np.mod(ptr - 1 - ranks, key_space).astype(np.int32)


def zipf_key_pmf(key_space: int, theta: float,
                 hot_offset: int = 0) -> np.ndarray:
    """Analytic pmf over KEYS: the rank pmf pushed through the scramble."""
    pmf = zipf_rank_pmf(key_space, theta)
    keys = scramble_host(np.arange(key_space), hot_offset, key_space)
    out = np.zeros(key_space)
    np.add.at(out, keys, pmf)
    return out
