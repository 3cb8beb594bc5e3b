"""The embedding-store payload mirror of the port against the JAX package
on the CPU: ``compact_once``'s Movement, the Movement replay
(``apply_movement_rows``/``apply_movement_pools``) and the embedding row
store driven through ``prepare_step``.

Tolerances: bit-equality for every integer leaf, index, counter,
Movement field and row pool.  Stated exceptions: ``obs.ev_score`` at rtol
1e-6 (a float32 sum over buckets in another order, as
tests/test_torch_engine.py holds it), and at 2e-6 where the port runs
backend "reference", whose ``msc.approx_score`` is a float32 matmul that
torch's BLAS accumulates in another order than XLA's dot (measured:
1.02e-6, one event of the stream); ``init``'s normal draw at rtol 1e-5
(torch's ``erfinv`` is not XLA's float32 approximation: measured up to
5.6e-6 relative, in the tails |x| > 3.5); ``apply_grad`` at rtol 1e-6
(a float32 scatter-add whose order of duplicate slots is not fixed).
The port runs backend "cuda" on CPU tensors (the movers' plain versions)
and "reference"; the kernels are held to those on the card in
tests/test_torch_kernels.py.  The movers only move rows, so a dense copy
of the initial table must give back every token's row exactly, after
any number of compactions: a check independent of the plain path.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compaction as jcompaction
from repro.core import embedding_store as jes
from repro.core.compaction import Movement as JMovement
from repro.kernels.tier_compact import ops as jops
from repro_torch.core import compaction, embedding_store as es, engine, prng
from repro_torch.core.compaction import Movement
from repro_torch.kernels.tier_compact.ops import (apply_movement_pools,
                                                  apply_movement_rows)
from torch_parity import assert_bit_equal, assert_trees_equal, leaves, t

# the config of tests/test_embedding_store.py
JCFG = jes.EmbedStoreConfig(vocab=2048, dim=8, fast_rows=128)
CFG = es.EmbedStoreConfig(vocab=2048, dim=8, fast_rows=128)
STEPS, TOKENS = 24, 48
SCORE_TOL = {".obs.ev_score": 1e-6}
RNG = np.random.default_rng(0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for this module: its tensors are small, and the
    test workers run side by side (eight threads each would contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(seed: int = 0):
    """tests/test_embedding_store.py's zipf(1.3) token batches."""
    r = np.random.default_rng(seed)
    return [(r.zipf(1.3, TOKENS) % CFG.vocab).astype(np.int32)
            for _ in range(STEPS)]


def _movement(P, S, M, rng):
    """A random Movement as tests/test_kernels.py:57 builds it: valid
    destinations unique, slots -1 where not valid."""
    p_dst = np.concatenate([rng.permutation(P),
                            np.zeros(max(M - P, 0), np.int64)])[:M]
    p_valid = (rng.random(M) > 0.5) & (np.arange(M) < P)
    m_valid = rng.random(M) > 0.3
    fields = dict(
        m_src_tier=rng.integers(0, 2, M).astype(np.int32),
        m_src_slot=rng.integers(0, P, M).astype(np.int32),
        m_dst_slot=np.where(m_valid, rng.permutation(S)[:M], -1)
        .astype(np.int32),
        m_valid=m_valid,
        p_src_slot=np.where(p_valid, rng.integers(0, S, M), -1)
        .astype(np.int32),
        p_dst_slot=np.where(p_valid, p_dst, -1).astype(np.int32),
        p_valid=p_valid)
    return (JMovement(**{k: jnp.asarray(v) for k, v in fields.items()}),
            Movement(**{k: t(v) for k, v in fields.items()}))


# ------------------------------------------------------------- movers

@pytest.mark.parametrize("P,S,W,M,jax_backend", [
    (16, 32, 128, 12, "reference"), (8, 64, 256, 30, "reference"),
    (16, 32, 128, 12, "pallas"), (8, 64, 256, 30, "pallas"),
    (16, 40, 2, 24, "reference"), (24, 24, 8, 24, "reference")])
def test_apply_movement_rows_matches_jax(P, S, W, M, jax_backend):
    """Random Movements (the sweep of tests/test_kernels.py:57, against
    JAX's plain movers and its Pallas kernels in interpret mode, plus
    the narrow widths of the stores against the plain movers):
    destination rows hold other values than the rows moved there, so a
    wrong or missing copy shows."""
    rng = np.random.default_rng(P * 1000 + W)
    jmv, mv = _movement(P, S, M, rng)
    fp = rng.normal(size=(P, W)).astype(np.float32)
    sp = rng.normal(size=(S, W)).astype(np.float32)
    want = jops.apply_movement_rows(jnp.asarray(fp), jnp.asarray(sp), jmv,
                                    backend=jax_backend)
    got = apply_movement_rows(t(fp), t(sp), mv, backend="cuda")
    for a, b in zip(want, got):
        assert_bit_equal(np.asarray(a), b.numpy())
    assert not np.array_equal(np.asarray(want[1]), sp)     # rows moved


def test_apply_movement_pools_matches_jax():
    """The paged-KV layout [L, P, T] (pool_axis=1), as
    tests/test_kernels.py:246 drives it."""
    L, P, S, T, M = 2, 8, 16, 64, 10
    rng = np.random.default_rng(3)
    jmv, mv = _movement(P, S, M, rng)
    fp = rng.normal(size=(L, P, T)).astype(np.float32)
    sp = rng.normal(size=(L, S, T)).astype(np.float32)
    want = jops.apply_movement_pools(jnp.asarray(fp), jnp.asarray(sp), jmv,
                                     pool_axis=1, backend="reference")
    got = apply_movement_pools(t(fp), t(sp), mv, pool_axis=1,
                               backend="cuda")
    for a, b in zip(want, got):
        assert_bit_equal(np.asarray(a), b.numpy())


# ------------------------------------------------------- one compaction

@pytest.fixture(scope="module")
def store_state():
    """A JAX store after one prepared batch (tests/test_kernels.py's
    embedding-store backend parity setup), as numpy leaves."""
    cfg = jes.EmbedStoreConfig(vocab=4096, dim=32, fast_rows=512)
    state = jax.jit(jes.init, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    toks = jnp.asarray(np.random.default_rng(1).integers(0, cfg.vocab, 256),
                       jnp.int32)
    state, _ = jax.jit(jes.prepare_batch, static_argnums=1)(state, cfg, toks)
    return cfg, jax.device_get(state)


def _to_port(tree):
    """numpy leaves -> CPU tensors (uint32 blooms as int32 bits)."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = {"TierState": engine.TierState, "Counters": engine.Counters,
               "TrackerState": engine.TrackerState,
               "EmbedStoreState": es.EmbedStoreState}[type(tree).__name__]
        return cls(*[_to_port(x) for x in tree])
    if isinstance(tree, tuple):
        return tuple(_to_port(x) for x in tree)
    a = np.asarray(tree)
    return t(a.view(np.int32) if a.dtype == np.uint32 else a)


def test_movement_matches_jax(store_state):
    """``compact_once(with_movement=True)`` on the same store state: the
    new tier state, the stats and every Movement field bit-equal."""
    jcfg, jstate = store_state
    cfg = es.EmbedStoreConfig(*jcfg)
    key = jax.random.PRNGKey(1)
    jt, jstats, jmv = jax.jit(functools.partial(
        jcompaction.compact_once, cfg=jcfg.tier(), promote=True,
        with_movement=True))(jax.tree.map(jnp.asarray, jstate.tier),
                             rng=key)
    tt, tstats, tmv = compaction.compact_once(
        _to_port(jstate.tier), cfg.tier(), prng.PRNGKey(1), promote=True,
        with_movement=True)
    assert int(np.asarray(jstats.n_merged)) > 0
    assert_trees_equal(jax.device_get(jmv), tmv)
    assert_trees_equal(jax.device_get(jstats), tstats,
                       {".score": 1e-6})
    want = leaves(jax.device_get(jt))
    got = leaves(tt)
    for (p, a), (_, b) in zip(want, got):
        assert_bit_equal(a.view(np.int32) if a.dtype == np.uint32 else a,
                         b, p)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_store_compact_matches_jax(store_state, backend):
    """``embedding_store.compact``: a real compaction's Movement replayed
    on the row pools (JAX's reference branch vs the port's movers)."""
    jcfg, jstate = store_state
    cfg = es.EmbedStoreConfig(*jcfg)
    want, _ = jax.jit(jes.compact, static_argnums=1)(
        jax.tree.map(jnp.asarray, jstate), jcfg, jax.random.PRNGKey(2))
    got, _ = es.compact(_to_port(jstate), cfg, prng.PRNGKey(2),
                        backend=backend)
    assert_bit_equal(np.asarray(want.rows_fast), got.rows_fast.numpy())
    assert_bit_equal(np.asarray(want.rows_slow), got.rows_slow.numpy())
    assert not np.array_equal(np.asarray(want.rows_slow), jstate.rows_slow)


# ------------------------------------------------- the engine-driven store

@pytest.fixture(scope="module")
def jax_store_run():
    """JAX ``engine_init`` + ``prepare_step`` over the token stream: the
    initial state, each step's slots, the final state."""
    ecfg = jes.engine_config(JCFG)
    est = jes.engine_init(JCFG, jax.random.PRNGKey(0))
    init = jax.device_get(est)
    prepare = jax.jit(functools.partial(jes.prepare_step, cfg=JCFG,
                                        ecfg=ecfg))
    slots = []
    for toks in _tokens():
        est, s = prepare(est, token_ids=jnp.asarray(toks))
        slots.append(np.asarray(s))
    return dict(init=init, slots=slots, end=jax.device_get(est))


def test_state_from_numpy_takes_payload_types(jax_store_run):
    """The engine knows no payload: a JAX store state carries across only
    with the store's class in ``payload_types``."""
    ecfg = es.engine_config(CFG)
    with pytest.raises(ValueError, match="EmbedStoreState"):
        engine.state_from_numpy(jax_store_run["init"], ecfg, device="cpu")
    est = engine.state_from_numpy(jax_store_run["init"], ecfg, device="cpu",
                                  payload_types=(es.EmbedStoreState,))
    assert isinstance(est.payload, es.EmbedStoreState)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_prepare_step_stream_matches_jax(jax_store_run, backend):
    """The store's engine state (tier, counters, obs, both row pools)
    carried from the JAX ``engine_init``; every step's slots and the end
    state bit-equal; the dense-table check on every step."""
    ref = jax_store_run
    ecfg = es.engine_config(CFG, backend=backend)
    est = engine.state_from_numpy(ref["init"], ecfg, device="cpu",
                                  payload_types=(es.EmbedStoreState,))
    dense = ref["init"].payload.rows_slow.copy()
    for toks, want in zip(_tokens(), ref["slots"]):
        est, slots = es.prepare_step(est, CFG, ecfg, t(toks))
        assert_bit_equal(want, slots.numpy())
        emb = es.lookup(est.payload._replace(tier=est.tier), t(toks))
        assert_bit_equal(dense[toks], emb.numpy())
    assert int(est.tier.ctr.compactions) > 0
    assert int(est.tier.ctr.demoted) > 0
    tol = SCORE_TOL if backend == "cuda" else {".obs.ev_score": 2e-6}
    assert_trees_equal(ref["end"], engine.state_to_numpy(est), tol)


def test_dense_table_holds_through_compactions():
    """The port on its own (its own ``init`` draw): after every step, the
    fast-pool lookup of every token returns its initial row exactly,
    while compactions keep demoting rows to the slow pool and back."""
    ecfg = es.engine_config(CFG, backend="cuda")
    est = es.engine_init(CFG, prng.PRNGKey(4), ecfg, device="cpu")
    dense = est.payload.rows_slow.clone()
    for toks in _tokens(seed=9) + _tokens(seed=10):
        est, _ = es.prepare_step(est, CFG, ecfg, t(toks))
        emb = es.lookup(est.payload._replace(tier=est.tier), t(toks))
        assert torch.equal(emb, dense[t(toks).long()])
    assert int(est.tier.ctr.compactions) > 10


def test_init_matches_jax():
    """``init``: the tier state bit-equal; the rows' normal draw within
    rtol 1e-5 of ``jax.random.normal`` (see the module docstring)."""
    want = jax.device_get(jes.engine_init(JCFG, jax.random.PRNGKey(3)))
    got = engine.state_to_numpy(
        es.engine_init(CFG, prng.PRNGKey(3), device="cpu"))
    assert_trees_equal(want._replace(payload=()), got._replace(payload=()))
    assert_bit_equal(want.payload.rows_fast, got.payload.rows_fast)
    np.testing.assert_allclose(got.payload.rows_slow,
                               want.payload.rows_slow, rtol=1e-5, atol=0)


def test_apply_grad_matches_jax(store_state):
    """The in-place slab update, duplicate slots included."""
    _, jstate = store_state
    slots = RNG.integers(0, 64, 200).astype(np.int32)
    grads = RNG.normal(size=(200, jstate.rows_fast.shape[1])) \
        .astype(np.float32)
    want = jes.apply_grad(jax.tree.map(jnp.asarray, jstate),
                          jnp.asarray(slots), jnp.asarray(grads), lr=0.5)
    got = es.apply_grad(_to_port(jstate), t(slots), t(grads), lr=0.5)
    np.testing.assert_allclose(got.rows_fast.numpy(),
                               np.asarray(want.rows_fast), rtol=1e-6,
                               atol=1e-7)


def test_unique_padded_matches_jnp_unique():
    x = RNG.integers(0, 50, 64).astype(np.int32)
    want = np.asarray(jnp.unique(jnp.asarray(x), size=x.size, fill_value=-1))
    assert_bit_equal(want, es._unique_padded(t(x)).numpy())
