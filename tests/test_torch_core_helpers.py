"""Five public helpers of the JAX core that nothing in either package
calls, held bit-equal to the JAX package's on seeded inputs:
``bloom.set_run``, ``bloom.clear_run``, ``bloom.query``,
``compaction.below_low_watermark`` and ``mapper.expected_pinned_fraction``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import bloom, compaction, mapper, tiers
from torch_parity import assert_bit_equal, t

N_RUNS, WORDS, N_KEYS = 8, 16, 64


def _filters(rng):
    return rng.integers(0, 2 ** 32, (N_RUNS, WORDS), dtype=np.uint64) \
        .astype(np.uint32)


def _keys(rng, n=N_KEYS):
    return rng.integers(0, 1 << 30, n).astype(np.int32)


def _fill_fast(state, occupied: int, arange, where):
    """``state`` with the first ``occupied`` fast-tier slots holding keys
    and the others empty (-1); ``keys`` is a tuple, one array a tier."""
    k0 = state.keys[0]
    n = k0.shape[0]
    keys0 = where(arange(n) < occupied, arange(n), -1)
    keys0 = keys0.astype(k0.dtype) if hasattr(keys0, "astype") else \
        keys0.to(k0.dtype)
    return state._replace(keys=(keys0, *state.keys[1:]))


def _case(name: str, seed: int):
    """(JAX's result, the port's) of helper ``name`` on inputs drawn from
    ``seed``."""
    import jax.numpy as jnp
    from repro.core import bloom as jbloom
    from repro.core import compaction as jcompaction
    from repro.core import mapper as jmapper
    from repro.core import tiers as jtiers
    rng = np.random.default_rng(seed)
    if name in ("set_run", "clear_run", "query"):
        f = _filters(rng)
        keys = _keys(rng)
        run = int(rng.integers(0, N_RUNS))
        tf = t(f.view(np.int32))
        if name == "set_run":
            valid = rng.random(N_KEYS) < 0.7
            want = jbloom.set_run(jnp.asarray(f), jnp.int32(run),
                                  jnp.asarray(keys), jnp.asarray(valid))
            got = bloom.set_run(tf, run, t(keys), t(valid))
        elif name == "clear_run":
            want = jbloom.clear_run(jnp.asarray(f), jnp.int32(run))
            got = bloom.clear_run(tf, run)
        else:
            # filters that hold some of the keys, so that hits occur
            f = np.asarray(jbloom.set_run(jnp.asarray(f), jnp.int32(run),
                                          jnp.asarray(keys[:32]),
                                          jnp.ones(32, bool)))
            runs = rng.integers(0, N_RUNS, 5).astype(np.int32)
            runs[0] = run
            want = jbloom.query(jnp.asarray(f), jnp.asarray(runs),
                                jnp.asarray(keys))
            got = bloom.query(t(f.view(np.int32)), t(runs), t(keys))
            assert bool(np.asarray(want)[0, :32].all())
        if got.dtype == torch.int32:
            got = got.numpy().view(np.uint32)
        return np.asarray(want), np.asarray(got)
    if name == "below_low_watermark":
        occupied = 59 + seed            # 59, 60 / 64 under 0.95; 61 over
        kw = dict(fast_slots=64, slow_slots=256, max_runs=8, run_size=64,
                  bloom_bits_per_run=1 << 9, tracker_slots=128, n_buckets=8)
        jcfg, pcfg = jtiers.TierConfig(**kw), tiers.TierConfig(**kw)
        want = jcompaction.below_low_watermark(_fill_fast(
            jtiers.init(jcfg), occupied, jnp.arange, jnp.where), jcfg)
        got = compaction.below_low_watermark(_fill_fast(
            tiers.init(pcfg, "cpu"), occupied, torch.arange, torch.where),
            pcfg)
        return np.asarray(want), got.numpy()
    hist = rng.integers(0, 1000, 4).astype(np.int32)
    probs = rng.random(4).astype(np.float32)
    want = jmapper.expected_pinned_fraction(jnp.asarray(hist),
                                            jnp.asarray(probs))
    got = mapper.expected_pinned_fraction(t(hist), t(probs))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["set_run", "clear_run", "query",
                                  "below_low_watermark",
                                  "expected_pinned_fraction"])
def test_helper_bit_equal_to_jax(name, seed):
    want, got = _case(name, seed)
    assert want.shape == got.shape, (name, want.shape, got.shape)
    assert_bit_equal(want, got, name)
