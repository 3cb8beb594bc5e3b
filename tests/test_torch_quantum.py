"""Preemptible compaction (``compaction_quantum > 0``) of the port against
the JAX package on the CPU.

The configuration and op stream are those of
tests/test_compaction_incremental.py.  Every leaf of the engine state --
the in-flight carry ``comp`` and the event ring's kinds and job counts
included -- and every per-op result must be bit-equal to the JAX
package's at the same quantum, except ``obs.ev_score`` and
``obs.ev_io_us``, held to rtol 1e-6 (float32 sums whose order differs
between XLA and torch; as tests/test_torch_engine.py holds ``ev_score``).
The port's end state and results at any quantum must equal its own
quantum-0 run's, and its host reads must not grow with the quantum.
The port runs backend "cuda" on CPU tensors, i.e. the movers' plain
versions; the kernels themselves are held to those on the card
(tests/test_torch_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PrismDB as JDB
from repro.core import TierConfig as JTierConfig
from repro.core.engine import OpBatch as JOp
from repro_torch.core import compaction, engine
from repro_torch.core.db import PrismDB
from repro_torch.core.tiers import TierConfig
from torch_parity import assert_bit_equal, assert_trees_equal, leaves, t

# CFG of tests/test_compaction_incremental.py
CFG_KW = dict(key_space=512, fast_slots=64, slow_slots=1024, value_width=2,
              max_runs=32, run_size=32, bloom_bits_per_run=1 << 10,
              tracker_slots=256, n_buckets=16, pin_threshold=0.1)
N_BATCHES, BATCH, HALF = 96, 32, 48
FLOAT_TOL = {".obs.ev_score": 1e-6, ".obs.ev_io_us": 1e-6}
JAX_QUANTA = (1, 64, 1 << 20)
PORT_QUANTA = (1, 3, 7, 64, 1 << 20)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for this module: its tensors are small, and the
    test workers run side by side (eight threads each would contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(n_batches: int = N_BATCHES, batch: int = BATCH, seed: int = 3):
    """The PUT/GET/PUT/DELETE stream of test_compaction_incremental's
    ``_op_stream`` (values = broadcast keys, every lane valid)."""
    rng = np.random.default_rng(seed)
    kinds, keys = [], []
    for i in range(n_batches):
        keys.append(rng.integers(0, CFG_KW["key_space"], size=batch)
                    .astype(np.int32))
        kinds.append((0, 1, 0, 2)[i % 4])
    keys = np.asarray(keys, np.int32)
    vals = np.broadcast_to(keys[..., None].astype(np.float32),
                           keys.shape + (CFG_KW["value_width"],)).copy()
    return (np.asarray(kinds, np.int32), keys, vals,
            np.ones(keys.shape, bool), np.zeros(keys.shape, np.int32))


def _part(s, lo, hi):
    return tuple(x[lo:hi] for x in s)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX runs per quantum: the stream in two halves (one compile of
    ``run_ops`` per quantum); the state after the first half (mid-backlog
    at small quanta), the end state and all results."""
    s = _stream()
    out = {}
    for q in JAX_QUANTA:
        db = JDB(JTierConfig(**CFG_KW), seed=0, compaction_quantum=q)
        r1 = jax.device_get(db.run_ops(JOp(*map(jnp.asarray,
                                                _part(s, 0, HALF)))))
        mid = jax.device_get(db.estate)
        r2 = jax.device_get(db.run_ops(JOp(*map(jnp.asarray,
                                                _part(s, HALF, None)))))
        out[q] = dict(mid=mid, end=jax.device_get(db.estate),
                      res=[np.concatenate([a, b]) for a, b in zip(r1, r2)],
                      counters=db.counters)
    return out


def _port(q: int, backend: str = "cuda") -> PrismDB:
    return PrismDB(TierConfig(**CFG_KW), seed=0, compaction_quantum=q,
                   backend=backend, device="cpu")


def _ops(s):
    return engine.OpBatch(*[t(x) for x in s])


_PORT_RUNS: dict = {}


def port_run(q: int):
    """The port's run of the whole stream at quantum ``q`` (cached):
    the facade and its stacked results."""
    if q not in _PORT_RUNS:
        db = _port(q)
        res = db.run_ops(_ops(_stream()))
        _PORT_RUNS[q] = (db, res)
    return _PORT_RUNS[q]


@pytest.mark.parametrize("q", JAX_QUANTA)
def test_quantized_engine_matches_jax(q, jax_runs):
    """Port and JAX at the same quantum: every per-op result and every
    state leaf, the in-flight carry and the event ring included."""
    ref = jax_runs[q]
    db, res = port_run(q)
    for a, b in zip(ref["res"], res):
        assert_bit_equal(a, b.numpy())
    assert_trees_equal(ref["end"], engine.state_to_numpy(db.estate),
                       FLOAT_TOL)
    assert db.counters == ref["counters"]
    assert db.counters["compactions"] > 0
    obs = db.estate.obs
    assert int(obs.ev_jobs) == db.counters["compactions"]
    assert int((obs.ev_kind == 1).sum()) > 0            # EV_START entries


@pytest.mark.parametrize("q", PORT_QUANTA)
def test_any_quantum_matches_run_to_completion(q):
    """The any-quantum contract on the port: tier state and per-op results
    bit-equal to quantum 0's, and no more host reads."""
    db0, res0 = port_run(0)
    dbq, resq = port_run(q)
    assert db0.counters["compactions"] > 0
    assert_trees_equal(db0.estate.tier, dbq.estate.tier)
    for a, b in zip(res0, resq):
        assert torch.equal(a, b)
    assert dbq.host_reads == db0.host_reads


def test_carried_backlog_continues_like_jax(jax_runs):
    """A JAX state carried across mid-backlog (``state_from_numpy``) must
    drain on and end bit-equal to the JAX run."""
    ref = jax_runs[1]
    assert int(np.asarray(ref["mid"].comp.rem_rows)) > 0     # a backlog
    db = _port(1)
    db.estate = engine.state_from_numpy(ref["mid"], db.ecfg, device="cpu")
    assert_trees_equal(ref["mid"], engine.state_to_numpy(db.estate))
    res = db.run_ops(_ops(_part(_stream(), HALF, None)))
    for a, b in zip(ref["res"], res):
        assert_bit_equal(a[HALF:], b.numpy())
    assert_trees_equal(ref["end"], engine.state_to_numpy(db.estate),
                       FLOAT_TOL)


def test_drain_is_idempotent_after_commit():
    """Draining an empty carry moves nothing and changes no leaf
    (test_compaction_incremental's post-commit idempotence)."""
    db, _ = port_run(1 << 20)
    est = db.estate
    assert int(est.comp.rem_rows) == 0
    before = [x.copy() for _, x in leaves(est.tier)]
    tier, fl, drained, k = compaction.drain_quantum(est.tier, est.comp,
                                                    1 << 20)
    assert int(k) == 0 and all(int(d) == 0 for d in drained)
    for a, (p, b) in zip(before, leaves(tier)):
        assert_bit_equal(a, b, p)
    assert_trees_equal(est.comp, fl)


def test_host_reads_per_step_do_not_grow_with_the_quantum():
    """A YCSB-C-like get segment behind a backlog: the drain runs on every
    step without a host read, so q = 64 reads as often as q = 0."""
    rng = np.random.default_rng(5)
    pre = [rng.integers(0, CFG_KW["key_space"], BATCH).astype(np.int32)
           for _ in range(24)]
    gets = [rng.integers(0, CFG_KW["key_space"], BATCH).astype(np.int32)
            for _ in range(16)]
    per_step, found = {}, {}
    for q in (0, 64):
        db = _port(q)
        for k in pre:
            db.put(k)
        if q:
            assert int(db.estate.comp.rem_rows) > 0       # drains pending
        counts, hits = [], []
        for k in gets:
            before = engine.HOST_READS.n
            hits.append(db.get(k))
            counts.append(engine.HOST_READS.n - before)
        per_step[q], found[q] = counts, hits
    assert per_step[64] == per_step[0]
    for a, b in zip(found[0], found[64]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
