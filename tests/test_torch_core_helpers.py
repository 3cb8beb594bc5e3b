"""Public helpers of the JAX core held bit-equal to the JAX package's on
seeded inputs: five that nothing in either package calls
(``bloom.set_run``, ``bloom.clear_run``, ``bloom.query``,
``compaction.below_low_watermark`` and ``mapper.expected_pinned_fraction``)
and ``compaction.needs_compaction``, through which ``paged_kv`` and
``embedding_store`` ask whether their fast tier has reached its high
watermark, on fast tiers preloaded below, at and above it.
"""
from __future__ import annotations

import functools
import zlib

import numpy as np
import pytest
import torch

from repro_torch.core import (bloom, compaction, embedding_store, mapper,
                              paged_kv, prng, tiers)
from torch_parity import assert_bit_equal, t

N_RUNS, WORDS, N_KEYS = 8, 16, 64
# fast tiers of 50 slots: 49 of them in use is the 0.98 high watermark
FAST = 50
OCCUPIED = {"below": 48, "at": 49, "above": 50}


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


# ------------------------------------------------------- needs_compaction

def _stores():
    """{store: (JAX's module, JAX's config, the port's config)}, each
    store's fast tier FAST slots."""
    from repro.core import embedding_store as jes
    from repro.core import paged_kv as jpk
    pk = dict(n_layers=1, kv_heads=1, head_dim=8, page_tokens=4,
              fast_pages=FAST, slow_pages=256, max_seqs=4,
              max_pages_per_seq=64)
    es = dict(vocab=4096, dim=4, fast_rows=FAST)
    return {"paged_kv": (jpk, jpk.PagedKVConfig(**pk),
                         paged_kv.PagedKVConfig(**pk)),
            "embedding_store": (jes, jes.EmbedStoreConfig(**es),
                                embedding_store.EmbedStoreConfig(**es))}


@functools.lru_cache(maxsize=None)
def _jax_put(tcfg):
    import jax
    from repro.core import tiers as jtiers
    return jax.jit(functools.partial(jtiers.put_batch, cfg=tcfg))


@pytest.mark.parametrize("where", sorted(OCCUPIED))
@pytest.mark.parametrize("store", ["paged_kv", "embedding_store"])
def test_needs_compaction_bit_equal_to_jax(store, where):
    """A store's fast tier preloaded by one put of ``OCCUPIED[where]``
    distinct keys (drawn from the test's own generator, the batch padded
    to FAST lanes by an invalid tail): the store's ``needs_compaction``
    and ``compaction.needs_compaction`` give JAX's 0-d bool, bit for
    bit, False below the watermark and True at and above it."""
    import jax
    import jax.numpy as jnp
    from repro.core import compaction as jcompaction
    from repro.core import tiers as jtiers
    jmod, jcfg, pcfg = _stores()[store]
    tcfg = pcfg.tier()
    rng = np.random.default_rng(zlib.crc32(f"{store}-{where}".encode()))
    keys = rng.choice(tcfg.key_space, FAST, replace=False).astype(np.int32)
    valid = np.arange(FAST) < OCCUPIED[where]
    vals = rng.random((FAST, tcfg.value_width)).astype(np.float32)

    jtier = _jax_put(jcfg.tier())(jtiers.init(jcfg.tier()),
                                  keys=jnp.asarray(keys),
                                  vals=jnp.asarray(vals),
                                  valid=jnp.asarray(valid))
    ptier = tiers.put_batch(tiers.init(tcfg, "cpu"), tcfg, t(keys), t(vals),
                            t(valid))
    assert_bit_equal(np.asarray(jtier.keys[0]), ptier.keys[0].numpy(),
                     "preloaded fast keys")
    if store == "paged_kv":
        jstate = jmod.init(jcfg)
        pstate = paged_kv.init(pcfg, "cpu")
    else:
        jstate = jmod.init(jcfg, jax.random.PRNGKey(0))
        pstate = embedding_store.init(pcfg, prng.PRNGKey(0), "cpu")
    jstate, pstate = jstate._replace(tier=jtier), pstate._replace(tier=ptier)
    want = np.asarray(jmod.needs_compaction(jstate, jcfg))
    mod = paged_kv if store == "paged_kv" else embedding_store
    got = mod.needs_compaction(pstate, pcfg)
    assert got.shape == () and got.dtype == torch.bool
    assert_bit_equal(want, got.numpy(), store)
    assert_bit_equal(
        np.asarray(jcompaction.needs_compaction(jtier, jcfg.tier())),
        compaction.needs_compaction(ptier, tcfg).numpy(), "compaction")
    assert bool(got) == (where != "below")
