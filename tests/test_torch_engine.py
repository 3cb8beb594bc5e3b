"""The port's main path end to end against the JAX package on the CPU.

Seeded YCSB-A-like and YCSB-E-like op streams (numpy-made, stacked
``OpBatch``) run through JAX ``PrismDB.run_ops`` and the port's
``PrismDB(device="cpu").run_ops`` with both port backends.  Every leaf of
the engine state -- pools, indexes, run directory, blooms, tracker,
buckets, counters, policy, obs histograms and rings, rng -- and every
per-op result must be bit-equal, except ``obs.ev_score`` (each
compaction's MSC score), a float32 sum over buckets whose reduction order
differs between XLA and torch: it is held to rtol 1e-6 (1-2 ULP).  The
chosen ranges, hence all integer state, must not differ at all.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PrismDB as JDB
from repro.core import TierConfig as JTierConfig
from repro.core import policy as jpolicy
from repro.core.engine import OpBatch as JOp
from repro_torch.core import engine
from repro_torch.core import policy as tpolicy
from repro_torch.core.db import PrismDB
from repro_torch.core.tiers import TierConfig
from torch_parity import assert_bit_equal, assert_trees_equal, t

# the _parity_db configuration of tests/test_kernels.py:150-163
CFG_KW = dict(key_space=1 << 12, fast_slots=256, slow_slots=1 << 12,
              value_width=2, max_runs=32, run_size=128,
              bloom_bits_per_run=1 << 10, tracker_slots=409, n_buckets=16,
              pin_threshold=0.3)
POL_KW = dict(epoch_ops=256, cooldown_ops=1024, read_heavy_frac=0.5,
              slow_tracked_frac=0.2, detect_ops=256)
BATCH, SEG = 128, 12
SCORE_TOL = {".obs.ev_score": 1e-6}


def _stream(kind: str, seed: int):
    """SEG batches: YCSB-A = 50/50 get/put batches, YCSB-E = 90% scan
    batches (lengths 1..63) + 10% put batches; zipf(0.99) keys."""
    r = np.random.default_rng(seed)
    ks = CFG_KW["key_space"]
    p = 1.0 / np.arange(1, ks + 1) ** 0.99
    p /= p.sum()
    perm = r.permutation(ks)
    kinds, keys, aux = [], [], []
    for _ in range(SEG):
        if kind == "A":
            kinds.append(int(r.integers(0, 2)))          # PUT / GET
        else:
            kinds.append(3 if r.random() < 0.9 else 0)   # SCAN / PUT
        keys.append(perm[r.choice(ks, size=BATCH, p=p)])
        aux.append(r.integers(1, 64, BATCH))
    keys = np.asarray(keys, np.int32)
    vals = np.broadcast_to(keys[..., None].astype(np.float32),
                           keys.shape + (CFG_KW["value_width"],)).copy()
    valid = r.random(keys.shape) > 0.02
    return (np.asarray(kinds, np.int32), keys, vals, valid,
            np.asarray(aux, np.int32))


def _preload():
    r = np.random.default_rng(7)
    return [r.integers(0, CFG_KW["key_space"], BATCH).astype(np.int32)
            for _ in range(4)]


_JAX_RUNS: dict = {}


def jax_run(kind: str):
    """JAX reference run (cached per stream kind): preload, segment 1,
    the state after it, segment 2, the final state; results of both."""
    if kind not in _JAX_RUNS:
        db = JDB(JTierConfig(**CFG_KW), seed=0,
                 pol_cfg=jpolicy.PolicyConfig(**POL_KW))
        for k in _preload():
            db.put(k)
        s1, s2 = _stream(kind, 3), _stream(kind, 4)
        r1 = jax.device_get(db.run_ops(JOp(*map(jnp.asarray, s1))))
        mid = jax.device_get(db.estate)
        r2 = jax.device_get(db.run_ops(JOp(*map(jnp.asarray, s2))))
        _JAX_RUNS[kind] = dict(s1=s1, s2=s2, r1=r1, r2=r2, mid=mid,
                               end=jax.device_get(db.estate),
                               compactions=db.counters["compactions"],
                               counters=db.counters)
    return _JAX_RUNS[kind]


def _port(backend: str) -> PrismDB:
    return PrismDB(TierConfig(**CFG_KW), seed=0, backend=backend,
                   pol_cfg=tpolicy.PolicyConfig(**POL_KW), device="cpu")


def _ops(s):
    return engine.OpBatch(*[t(x) for x in s])


def _assert_results(want, got):
    for a, b in zip(want, got):
        assert_bit_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("kind", ["A", "E"])
def test_main_path_matches_jax(kind, backend):
    ref = jax_run(kind)
    assert ref["compactions"] > 0
    db = _port(backend)
    for k in _preload():
        db.put(k)
    r1 = db.run_ops(_ops(ref["s1"]))
    _assert_results(ref["r1"], r1)
    assert_trees_equal(ref["mid"], engine.state_to_numpy(db.estate),
                       SCORE_TOL)
    r2 = db.run_ops(_ops(ref["s2"]))
    _assert_results(ref["r2"], r2)
    assert_trees_equal(ref["end"], engine.state_to_numpy(db.estate),
                       SCORE_TOL)
    assert db.counters == ref["counters"]
    assert db.counters["compactions"] > 0
    # one host read per maintenance entry + one per compaction round
    assert db.host_reads == db.dispatches + db.counters["compactions"]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("kind", ["A", "E"])
def test_carried_state_continues_like_jax(kind, backend):
    """Start the port from the JAX engine's state mid-stream
    (``state_from_numpy``); the second segment must end bit-equal."""
    ref = jax_run(kind)
    db = _port(backend)
    db.estate = engine.state_from_numpy(ref["mid"], db.ecfg, device="cpu")
    assert_trees_equal(ref["mid"], engine.state_to_numpy(db.estate))
    r2 = db.run_ops(_ops(ref["s2"]))
    _assert_results(ref["r2"], r2)
    assert_trees_equal(ref["end"], engine.state_to_numpy(db.estate),
                       SCORE_TOL)
    assert int(db.estate.tier.ctr.compactions) > int(
        np.asarray(ref["mid"].tier.ctr.compactions))


def test_facade_point_ops_and_scan():
    """put/get/delete/scan through the facade: values read back, deletes
    hide keys, scans return sorted live keys."""
    db = _port("cuda")
    r = np.random.default_rng(1)
    keys = r.permutation(CFG_KW["key_space"])[:1024].astype(np.int32)
    for i in range(0, 1024, BATCH):
        db.put(keys[i:i + BATCH])
    assert db.counters["compactions"] > 0
    vals, found, src = db.get(keys[:BATCH])
    assert bool(found.all())
    assert torch.equal(vals[:, 0], t(keys[:BATCH]).to(torch.float32))
    db.delete(keys[:16])
    _, found, _ = db.get(keys[:16])
    assert not bool(found.any())
    live = np.sort(keys[16:])
    got, ok = db.scan(int(live[10]), 8)
    assert got[ok].tolist() == live[10:18].tolist()
    n = db.scan_ops(keys[16:16 + BATCH], np.full(BATCH, 5, np.int32))
    assert bool((n > 0).all())


@pytest.mark.parametrize("knobs", [
    dict(precise=True),
    dict(selection="min_overlap", pin_mode="none"),
    dict(pin_mode="file", promote=False)])
def test_selection_and_pin_variants_match_jax(knobs):
    """The baseline knobs of compact_once (precise MSC, RocksDB-style
    min-overlap selection, no pinning, file-granularity pinning, no
    promotion) through one YCSB-A segment: state and results bit-equal
    (every leaf, ev_score included at rtol 1e-6)."""
    jdb = JDB(JTierConfig(**CFG_KW), seed=0,
              pol_cfg=jpolicy.PolicyConfig(**POL_KW), **knobs)
    tdb = PrismDB(TierConfig(**CFG_KW), seed=0, backend="cuda",
                  pol_cfg=tpolicy.PolicyConfig(**POL_KW), device="cpu",
                  **knobs)
    for k in _preload():
        jdb.put(k)
        tdb.put(k)
    s = _stream("A", 5)
    want = jax.device_get(jdb.run_ops(JOp(*map(jnp.asarray, s))))
    got = tdb.run_ops(_ops(s))
    _assert_results(want, got)
    assert_trees_equal(jax.device_get(jdb.estate),
                       engine.state_to_numpy(tdb.estate), SCORE_TOL)
    assert tdb.counters["compactions"] > 0


def test_run_directory_overflow_matches_jax():
    """When the run directory is full, compact_once writes merged rows with
    run id ``max_runs`` (no directory entry): gets can no longer reach
    them.  This is the JAX package's behaviour (logged in ROADMAP Queue
    3); the port reproduces it bit for bit, lost keys included."""
    kw = dict(CFG_KW, max_runs=8)
    jdb = JDB(JTierConfig(**kw), seed=0,
              pol_cfg=jpolicy.PolicyConfig(**POL_KW))
    tdb = PrismDB(TierConfig(**kw), seed=0, backend="cuda",
                  pol_cfg=tpolicy.PolicyConfig(**POL_KW), device="cpu")
    keys = np.random.default_rng(2).permutation(kw["key_space"])[:1536]
    keys = keys.astype(np.int32)
    for i in range(0, keys.size, BATCH):
        jdb.put(keys[i:i + BATCH])
        tdb.put(keys[i:i + BATCH])
    lost = 0
    for i in range(0, keys.size, BATCH):
        jv, jf, js = jdb.get(keys[i:i + BATCH])
        tv, tf, ts = tdb.get(keys[i:i + BATCH])
        _assert_results((jv, jf, js), (tv, tf, ts))
        lost += int((~tf).sum())
    st = tdb.estate.tier
    orphans = int(((st.runs[0] >= kw["max_runs"]) & (st.keys[1] >= 0)).sum())
    assert lost > 0 and orphans > 0
    assert_trees_equal(jax.device_get(jdb.estate),
                       engine.state_to_numpy(tdb.estate), SCORE_TOL)
