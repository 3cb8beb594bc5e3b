"""The port's N-tier storage plane against the JAX package on the CPU.

At two tiers a listed config (``tier_slots=(fast, slow)`` with an
explicit cost vector) is bit-identical to the legacy pair, on both
backends at quantum 0 and 3.  Three tiers (the CFG3 / COST3 of
tests/test_tier_list.py) and four tiers (deep merges that land in a
middle tier, the recursion of ``_deep_tick``) run through both packages
on the JAX test's random ``run_ops`` stream and on a preloaded
``run_workload``: every state leaf -- pools, indexes, tombstone rows,
run directories, Bloom filters, counters with ``comp_by_boundary``, the
obs event rings -- and every per-op result bit-equal, except three
float32 leaves held to rtol 1e-6: the MSC score in ``obs.ev_score`` and in the
in-flight carry's ``comp.score`` (as tests/test_torch_engine.py and
chip_smoke.py hold them) and ``obs.hist_sum``, each step's modeled cost summed per
bucket, which XLA's CPU compiler computes with fused multiply-adds that
round once where torch rounds twice (COST3's 0.2 us tier-0 price is not
a dyadic float; ROADMAP Queue 3, D5).  Each JAX trajectory is computed
once, inside the one test that compares against it, under its own jit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import workloads as JW
from repro.core import PrismDB as JDB
from repro.core import TierConfig as JTierConfig
from repro.core import compaction as jcompaction
from repro.core import tiers as jtiers
from repro.core import tracker as jtracker
from repro.core.engine import OpBatch as JOp
from repro.kernels.tier_compact import ops as jtc_ops
from repro.obs import cost as jcost
from repro.obs.state import ObsConfig as JObsConfig
from repro_torch import workloads as W
from repro_torch.core import compaction, engine, prng, tiers
from repro_torch.core.db import PrismDB
from repro_torch.core.tiers import TierConfig
from repro_torch.kernels.tier_compact import ops as tc_ops
from repro_torch.obs import cost as tcost
from repro_torch.obs.state import ObsConfig
from torch_parity import assert_bit_equal, assert_trees_equal, t

CFG2_KW = dict(key_space=1 << 12, fast_slots=256, slow_slots=1 << 11,
               value_width=2, max_runs=64, run_size=128,
               bloom_bits_per_run=1 << 12, tracker_slots=1 << 10,
               n_buckets=32, pin_threshold=0.1)
CFG3_KW = dict(key_space=1 << 11, fast_slots=128, slow_slots=1 << 10,
               value_width=2, max_runs=32, run_size=64,
               bloom_bits_per_run=1 << 12, tracker_slots=1 << 9,
               n_buckets=32, pin_threshold=0.1,
               tier_slots=(128, 256, 1 << 10))
CFG4_KW = dict(CFG3_KW, tier_slots=(128, 192, 384, 1 << 10))
COST3 = ((0.2, 0.2, 0.2, 0.2), (6.0, 10.0, 0.5, 1.0),
         (391.0, 391.0, 0.5, 1.0))
COST4 = ((0.25, 0.25, 0.25, 0.25), (6.0, 10.0, 0.5, 1.0),
         (80.0, 80.0, 0.5, 1.0), (391.0, 391.0, 0.5, 1.0))
FLOAT_TOL = {".obs.ev_score": 1e-6, ".comp.score": 1e-6,
             ".obs.hist_sum": 1e-6}
BACKENDS = ("reference", "cuda")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for this module: its tensors are small, and the
    test workers run side by side (eight threads each would contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_db(kw, cost, quantum=0) -> JDB:
    return JDB(JTierConfig(**kw), seed=3, compaction_quantum=quantum,
               obs=JObsConfig(cost=jcost.CostModel(
                   tiers=tuple(jcost.TierCost(*c) for c in cost))))


def _port_db(kw, cost, backend, quantum=0) -> PrismDB:
    return PrismDB(TierConfig(**kw), seed=3, backend=backend,
                   compaction_quantum=quantum, device="cpu",
                   obs=ObsConfig(cost=tcost.CostModel(
                       tiers=tuple(tcost.TierCost(*c) for c in cost))))


def _stream(seed: int, key_space: int, n_batches: int = 24,
            batch: int = 48):
    """The mixed random stream of tests/test_tier_list.py's ``_stream``
    (first batch a put; put, put, get, delete, scan drawn after), as
    numpy (kind, keys, vals, valid, aux)."""
    rng = np.random.default_rng(seed)
    kinds = [0, 0, 1, 2, 3]
    kind, keys, aux = [], [], []
    for i in range(n_batches):
        kind.append(0 if i == 0 else kinds[int(rng.integers(5))])
        keys.append(rng.integers(0, key_space, batch).astype(np.int32))
        aux.append(rng.integers(1, 16, batch).astype(np.int32))
    keys = np.asarray(keys)
    vals = np.broadcast_to(keys[..., None].astype(np.float32),
                           keys.shape + (2,)).copy()
    return (np.asarray(kind, np.int32), keys, vals,
            np.ones(keys.shape, bool), np.asarray(aux))


def _preload(key_space: int, n: int = 8):
    rng = np.random.default_rng(0)
    return [rng.integers(0, key_space, 100).astype(np.int32)
            for _ in range(n)]


def _check_conservation(db: PrismDB, kw):
    """Every compaction event lands on a boundary: per-boundary jobs equal
    the per-boundary commit counters; every boundary compacted; no tier
    holds more rows than its slots."""
    snap = db.obs_snapshot()
    c = db.counters
    cbb = c["comp_by_boundary"]
    assert snap["ev_jobs_b"].tolist() == cbb, (snap["ev_jobs_b"], cbb)
    assert snap["ev_jobs"] == c["compactions"] == sum(cbb), \
        (snap["ev_jobs"], c["compactions"], cbb)
    assert min(cbb) > 0, cbb
    for tier, cap in enumerate(kw["tier_slots"]):
        used = int((db.state.keys[tier] >= 0).sum())
        assert 0 < used <= cap, (tier, used, cap)
        occ = float(tiers.tier_occupancy(db.state, tier))
        assert occ == np.float32(used) / np.float32(cap), (tier, occ, used)


def _assert_steps_equal(jst, st):
    """Every ``StepStats`` field bit-equal to JAX's, step by step: a
    mismatch names the field and the first step that differs."""
    for f in W.StepStats._fields:
        a, b = np.asarray(getattr(jst, f)), getattr(st, f).numpy()
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (f, a.dtype,
                                                          b.dtype)
        for i in range(a.shape[0]):
            assert_bit_equal(a[i], b[i], f"StepStats.{f} at step {i}")


def _assert_final_equal(jdb: JDB, db: PrismDB, jstate, n_steps: int):
    """The engine state after the last step, every leaf (named in the
    message) bit-equal but FLOAT_TOL's, then the counters (the ones that
    differ named)."""
    try:
        assert_trees_equal(jstate, engine.state_to_numpy(db.estate),
                           FLOAT_TOL)
    except AssertionError as e:
        raise AssertionError(f"state after step {n_steps - 1}: {e}") \
            from None
    jc, c = jdb.counters, db.counters
    assert c == jc, {k: (jc[k], c.get(k)) for k in jc if c.get(k) != jc[k]}


# ------------------------------------------------------------- two tiers

@pytest.mark.parametrize("quantum", [0, 3])
@pytest.mark.parametrize("backend", BACKENDS)
def test_n2_tier_list_bit_identical_to_legacy(backend, quantum):
    """tier_slots=(fast, slow) with the cost vector resolved from the
    legacy scalars equals the legacy pair config: results, state, obs."""
    ops = engine.OpBatch(*[t(x) for x in _stream(0, CFG2_KW["key_space"],
                                                 n_batches=12)])
    base = tcost.CostModel()
    legacy = PrismDB(TierConfig(**CFG2_KW), seed=3, backend=backend,
                     compaction_quantum=quantum, device="cpu")
    listed = PrismDB(
        TierConfig(**CFG2_KW, tier_slots=(CFG2_KW["fast_slots"],
                                          CFG2_KW["slow_slots"])),
        seed=3, backend=backend, compaction_quantum=quantum, device="cpu",
        obs=ObsConfig(cost=tcost.CostModel(tiers=base.resolve(2))))
    ra, rb = legacy.run_ops(ops), listed.run_ops(ops)
    for a, b in zip(ra, rb):
        assert torch.equal(a, b)
    assert legacy.counters["compactions"] > 0
    assert_trees_equal(engine.state_to_numpy(legacy.estate),
                       engine.state_to_numpy(listed.estate))
    assert legacy.host_reads == listed.host_reads


# ----------------------------------------------------- three and four tiers

@pytest.mark.parametrize("quantum", [0, 3])
def test_three_tiers_match_jax_on_run_ops(quantum):
    s = _stream(0, CFG3_KW["key_space"])
    jdb = _jax_db(CFG3_KW, COST3, quantum)
    jres = jax.device_get(jdb.run_ops(JOp(*map(jnp.asarray, s))))
    jstate = jax.device_get(jdb.estate)
    assert min(jdb.counters["comp_by_boundary"]) > 0
    ops = engine.OpBatch(*[t(x) for x in s])
    for backend in BACKENDS:
        db = _port_db(CFG3_KW, COST3, backend, quantum)
        res = db.run_ops(ops)
        for a, b in zip(jres, res):
            assert_bit_equal(np.asarray(a), b.numpy())
        assert_trees_equal(jstate, engine.state_to_numpy(db.estate),
                           FLOAT_TOL)
        assert db.counters == jdb.counters


@pytest.mark.parametrize("kw,cost,quantum,backend", [
    (CFG3_KW, COST3, 0, "reference"), (CFG3_KW, COST3, 4, "cuda"),
    (CFG4_KW, COST4, 0, "cuda")],
    ids=["3-tiers-q0-reference", "3-tiers-q4-cuda", "4-tiers-q0-cuda"])
def test_tiers_match_jax_on_a_preloaded_workload(kw, cost, quantum, backend):
    """Preload, then ``run_workload(ycsb("A"), 16, 64)``; every boundary
    compacts, per-boundary events equal per-boundary commits.  One port
    backend a case (the run_ops cases run both)."""
    jdb = _jax_db(kw, cost, quantum)
    for k in _preload(kw["key_space"], len(kw["tier_slots"]) * 4):
        jdb.put(k)
    jdb.reset_workload(seed=1)
    jst = jax.device_get(jdb.run_workload(JW.ycsb("A"), 16, 64))
    jstate = jax.device_get(jdb.estate)
    db = _port_db(kw, cost, backend, quantum)
    for k in _preload(kw["key_space"], len(kw["tier_slots"]) * 4):
        db.put(k)
    db.reset_workload(seed=1)
    st = db.run_workload(W.ycsb("A"), 16, 64)
    _assert_steps_equal(jst, st)
    _assert_final_equal(jdb, db, jstate, 16)
    _check_conservation(db, kw)


@pytest.mark.parametrize("backend", BACKENDS)
def test_three_tier_dict_oracle_through_deep_compactions(backend):
    """Point ops against a 3-tier store match a host dict after rows
    migrate through the middle tier: updates supersede, deletes'
    tombstones reach the last tier, misses stay misses, and a scan
    returns live keys only, in order."""
    db = _port_db(CFG3_KW, COST3, backend)
    ks = CFG3_KW["key_space"]
    oracle = {}
    rng = np.random.default_rng(7)
    for r in range(6):
        keys = rng.integers(0, ks, 100).astype(np.int32)
        vals = np.repeat((keys + r * 10_000).astype(np.float32)[:, None],
                         2, axis=1)
        db.put(keys, vals)
        for k, v in zip(keys, vals):
            oracle[int(k)] = v
    dels = rng.choice(np.asarray(sorted(oracle), np.int32), 40,
                      replace=False).astype(np.int32)
    db.delete(dels)
    for k in dels:
        oracle.pop(int(k))
    more = rng.integers(0, ks, 100).astype(np.int32)
    db.put(more)
    for k in more:
        oracle[int(k)] = np.full((2,), float(k), np.float32)
    assert db.counters["comp_by_boundary"][1] > 0
    for lo in range(0, ks, 128):
        probe = np.arange(lo, lo + 128, dtype=np.int32)
        vals, found, _ = db.get(probe)
        want = [oracle.get(int(k)) for k in probe]
        assert found.tolist() == [w is not None for w in want]
        for j, w in enumerate(want):
            if w is not None:
                np.testing.assert_array_equal(vals[j].numpy(), w)
    keys, ok = db.scan(0, 256)
    live = keys[ok].tolist()
    assert live and live == sorted(live) and set(live) <= set(oracle)


# ------------------------------------------- deep merges, one call at a time

def _three_tier_states():
    """A 3-tier tier state with runs in both lower tiers and tombstone
    rows in tier 1, after the JAX test's stream through the port (whose
    run is bit-equal to JAX's, test_three_tiers_match_jax_on_run_ops):
    as JAX arrays, and a function giving a fresh port copy."""
    db = _port_db(CFG3_KW, COST3, "reference")
    db.run_ops(engine.OpBatch(*[t(x) for x in _stream(
        0, CFG3_KW["key_space"])]))
    host = engine.state_to_numpy(db.estate.tier)
    cls = {"TierState": jtiers.TierState, "Counters": jtiers.Counters,
           "TrackerState": jtracker.TrackerState}

    def to_jax(x):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return cls[type(x).__name__](*map(to_jax, x))
        if isinstance(x, tuple):
            return tuple(map(to_jax, x))
        return jnp.asarray(x)

    cfg = engine.EngineConfig(tier=TierConfig(**CFG3_KW))
    return to_jax(host), lambda: engine.state_from_numpy(host, cfg,
                                                         device="cpu")


def _pools(seed: int, width: int = 3):
    r = np.random.default_rng(seed)
    return [r.standard_normal((n, width)).astype(np.float32)
            for n in CFG3_KW["tier_slots"]]


def test_deep_merge_and_movement_replay_match_jax():
    """``compact_boundary`` at boundary 1 and ``compact_once`` at 0 on one
    3-tier state: states, stats and Movements bit-equal; their replays
    through ``apply_movement_boundary`` on per-tier pools bit-equal to
    JAX's.  JAX's replay reads a row from the boundary's upper pool only
    where ``m_src_tier == 0``, while ``compact_boundary`` labels rows with
    their tier index (ROADMAP Queue 3, F4): JAX's is fed the
    boundary-relative labels, and on the labels it is given it reads the
    run's rows from the lower pool, which the port does not."""
    jt, port_tier = _three_tier_states()
    jcfg, cfg = JTierConfig(**CFG3_KW), TierConfig(**CFG3_KW)
    jcm = jcost.CostModel(tiers=tuple(jcost.TierCost(*c) for c in COST3))
    tcm = tcost.CostModel(tiers=tuple(tcost.TierCost(*c) for c in COST3))
    jout = jax.device_get(jax.jit(lambda s: jcompaction.compact_boundary(
        s, jcfg, 1, cost=jcm, with_movement=True))(jt))
    out = compaction.compact_boundary(port_tier(), cfg, 1, cost=tcm,
                                      with_movement=True)
    assert int(jout[1].n_merged) > 0 and int(jout[1].n_run_read) > 0
    assert_trees_equal(jout, engine.state_to_numpy(out))
    mv = out[2]
    pools = _pools(1)
    got = tc_ops.apply_movement_boundary([t(p) for p in pools], mv, 1)
    rel = jout[2]._replace(m_src_tier=jout[2].m_src_tier - 1)
    want = jtc_ops.apply_movement_boundary(
        [jnp.asarray(p) for p in pools], jax.tree.map(jnp.asarray, rel), 1)
    for a, b in zip(want, got):
        assert_bit_equal(np.asarray(a), b.numpy())
    assert not np.array_equal(pools[2], got[2].numpy())
    raw = jtc_ops.apply_movement_boundary(
        [jnp.asarray(p) for p in pools],
        jax.tree.map(jnp.asarray, jout[2]), 1)
    assert not np.array_equal(np.asarray(raw[2]), got[2].numpy())

    jout0 = jax.device_get(jax.jit(lambda s: jcompaction.compact_once(
        s, jcfg, jax.random.PRNGKey(5), with_movement=True))(jt))
    out0 = compaction.compact_once(port_tier(), cfg, prng.PRNGKey(5),
                                   with_movement=True)
    assert int(jout0[1].n_merged) > 0
    assert_trees_equal(jout0, engine.state_to_numpy(out0),
                       {"[1].score": 1e-6})
    pools = _pools(2)
    got = tc_ops.apply_movement_boundary([t(p) for p in pools], out0[2], 0)
    want = jtc_ops.apply_movement_boundary(
        [jnp.asarray(p) for p in pools],
        jax.tree.map(jnp.asarray, jout0[2]), 0)
    for a, b in zip(want, got):
        assert_bit_equal(np.asarray(a), b.numpy())


def test_point_ops_scan_and_occupancy_match_jax():
    """On a 3-tier state with tier-1 tombstone rows: ``delete_batch``
    (with more tombstones than free tier-0 slots: ROADMAP Queue 3, F5),
    ``get_batch`` (the tier walk), ``scan`` (tombstoned rows hidden),
    ``tier_occupancy`` and ``tier_over_watermark`` / ``tier_below_low``
    bit-equal to JAX's."""
    jt, port_tier = _three_tier_states()
    jcfg, cfg = JTierConfig(**CFG3_KW), TierConfig(**CFG3_KW)
    assert int(np.asarray(jt.tombs[0]).sum()) > 0
    keys = np.random.default_rng(3).integers(
        0, CFG3_KW["key_space"], 96).astype(np.int32)
    valid = np.arange(96) % 7 != 0
    for tier in range(3):
        assert float(jtiers.tier_occupancy(jt, tier)) == float(
            tiers.tier_occupancy(port_tier(), tier))
        for fn in ("tier_over_watermark", "tier_below_low"):
            assert bool(getattr(jcompaction, fn)(jt, jcfg, tier)) == bool(
                getattr(compaction, fn)(port_tier(), cfg, tier))
    want = jax.device_get(jtiers.get_batch(jt, jcfg, jnp.asarray(keys),
                                           jnp.asarray(valid)))
    got = tiers.get_batch(port_tier(), cfg, t(keys), t(valid))
    assert_trees_equal(want, engine.state_to_numpy(got))
    assert int(np.asarray(want[3] == 2).sum()) > 0     # tier-2 hits
    # deletes of keys that live below tier 0, more than its free slots
    k0, k2 = np.asarray(jt.keys[0]), np.asarray(jt.keys[2])
    dkeys = np.setdiff1d(k2[k2 >= 0], k0)[:96].astype(np.int32)
    dvalid = np.ones(dkeys.shape, bool)
    assert dkeys.size > int((k0 < 0).sum())
    jdel = jtiers.delete_batch(jt, jcfg, jnp.asarray(dkeys),
                               jnp.asarray(dvalid))
    got = tiers.delete_batch(port_tier(), cfg, t(dkeys), t(dvalid))
    assert_trees_equal(jax.device_get(jdel), engine.state_to_numpy(got))
    # F5: tombstones that find no free tier-0 slot are dropped, and those
    # keys stay readable, in both packages alike
    want = jax.device_get(jtiers.get_batch(jdel, jcfg, jnp.asarray(dkeys),
                                           jnp.asarray(dvalid)))
    after = tiers.get_batch(got, cfg, t(dkeys), t(dvalid))
    assert_trees_equal(want, engine.state_to_numpy(after))
    assert 0 < int(after[2].sum()) < dkeys.size
    for lo in (0, 300, 1500):
        want = jax.device_get(jtiers.scan(jt, jnp.int32(lo), 64))
        got = tiers.scan(port_tier(), lo, 64)
        for a, b in zip(want, got):
            assert_bit_equal(np.asarray(a), b.numpy())


def test_cost_vectors_boundary_io_and_resolve():
    """``boundary_io_us`` and ``compaction_io_us`` at every boundary of a
    4-tier cost vector bit-equal to JAX's; ``resolve`` expands the legacy
    scalars and refuses a vector of the wrong length, as JAX's does."""
    r = np.random.default_rng(0)
    jcm = jcost.CostModel(tiers=tuple(jcost.TierCost(*c) for c in COST4))
    tcm = tcost.CostModel(tiers=tuple(tcost.TierCost(*c) for c in COST4))
    ints = [r.integers(0, 5000, 16).astype(np.int32) for _ in range(3)]
    for b in range(3):
        want = jcost.boundary_io_us(*map(jnp.asarray, ints), jcm, b)
        got = tcost.boundary_io_us(*[t(x) for x in ints], tcm, b)
        assert_bit_equal(np.asarray(want), got.numpy(), f"boundary {b}")
    assert tcm.resolve(4) == tuple(tcost.TierCost(*c) for c in COST4)
    assert tcost.CostModel().resolve(3) == tuple(
        tcost.TierCost(*c) for c in jcost.CostModel().resolve(3))
    for bad in (3, 5):
        with pytest.raises(ValueError, match="4 entries"):
            tcm.resolve(bad)
        with pytest.raises(ValueError, match="4 entries"):
            jcm.resolve(bad)


def test_three_tier_host_reads_per_step_do_not_grow_with_the_quantum():
    """The deep boundaries take their host reads in the maintenance loop
    alone: a quantized 3-tier run reads the host as often as run to
    completion, step for step."""
    ops = engine.OpBatch(*[t(x) for x in _stream(1, CFG3_KW["key_space"])])
    per = {}
    for q in (0, 5):
        db = _port_db(CFG3_KW, COST3, "cuda", q)
        per[q] = []
        for i in range(ops.kind.shape[0]):
            h0 = engine.HOST_READS.n
            db.run_ops(engine.OpBatch(*[x[i:i + 1] for x in ops]))
            per[q].append(engine.HOST_READS.n - h0)
        assert min(db.counters["comp_by_boundary"]) > 0
    assert per[0] == per[5]
