"""The port's core modules against the JAX package on the CPU: utils,
bloom, tracker, mapper, msc, obs -- bit-exact on seeded random inputs --
plus the port's structure (no JAX import, the card as default device)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bloom as jbloom
from repro.core import mapper as jmapper
from repro.core import tracker as jtracker
from repro.core import utils as ju
from repro.obs import cost as jcost
from repro.obs import state as jobs
from repro_torch.core import bloom, mapper, tracker
from repro_torch.core import utils as tu
from repro_torch.obs import cost as tcost
from repro_torch.obs import state as tobs
from torch_parity import assert_bit_equal, t

RNG = np.random.default_rng(0)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ------------------------------------------------------------------ utils

@pytest.mark.parametrize("salt", range(5))
def test_hashes(salt):
    keys = RNG.integers(-2**31, 2**31 - 1, 4096).astype(np.int32)
    assert_bit_equal(np.asarray(ju.hash_u32(jnp.asarray(keys), salt))
                     .astype(np.int64), tu.hash_u32(t(keys), salt).numpy())
    assert_bit_equal(np.asarray(ju.hash_mod(jnp.asarray(keys), 10066329,
                                            salt)).astype(np.int64),
                     tu.hash_mod(t(keys), 10066329, salt).numpy())
    assert_bit_equal(np.asarray(ju.mix32(jnp.asarray(keys), salt))
                     .astype(np.int64), tu.mix32(t(keys), salt).numpy())


def _random_index(n, nlive):
    pool = np.full(n, -1, np.int32)
    slots = RNG.choice(n, nlive, replace=False)
    pool[slots] = RNG.choice(4000, nlive, replace=False).astype(np.int32)
    return pool, slots


def test_build_sorted_index_and_lookup():
    pool, _ = _random_index(300, 170)
    jk, js = ju.build_sorted_index(jnp.asarray(pool))
    tk, ts = tu.build_sorted_index(t(pool))
    assert_bit_equal(np.asarray(jk), tk.numpy())
    assert_bit_equal(np.asarray(js), ts.numpy())
    q = RNG.integers(-3, 4100, 500).astype(np.int32)
    jv, jf = ju.sorted_lookup(jk, js, jnp.asarray(q))
    tv, tf = tu.sorted_lookup(tk, ts, t(q))
    assert_bit_equal(np.asarray(jv), tv.numpy())
    assert_bit_equal(np.asarray(jf), tf.numpy())


def test_merge_index_update_vs_jax_and_oracle():
    """The seeded sweep of tests/test_index_merge.py: drops + inserts +
    pad lanes, bit-exact against JAX (pad-entry slots included)."""
    n, b = 48, 8
    for _ in range(50):
        nlive = int(RNG.integers(0, n))
        pool, slots = _random_index(n, nlive)
        ik, isl = ju.build_sorted_index(jnp.asarray(pool))
        ndrop = int(RNG.integers(0, nlive + 1))
        dsl = RNG.choice(slots, ndrop, replace=False) if ndrop else []
        drop = np.zeros(n, bool)
        drop[list(dsl)] = True
        new_pool = pool.copy()
        new_pool[list(dsl)] = -1
        free = np.flatnonzero(new_pool < 0)
        nins = int(RNG.integers(0, min(b, len(free)) + 1))
        ins_s = RNG.choice(free, nins, replace=False)
        ins_k = RNG.choice(np.arange(5000, 9000), nins,
                           replace=False).astype(np.int32)
        lk, ls, lv = (np.zeros(b, np.int32), np.zeros(b, np.int32),
                      np.zeros(b, bool))
        lk[:nins], ls[:nins], lv[:nins] = ins_k, ins_s, True
        perm = RNG.permutation(b)
        args = (drop, lk[perm], ls[perm], lv[perm])
        jo = ju.merge_index_update(ik, isl, *map(jnp.asarray, args))
        to = tu.merge_index_update(t(np.asarray(ik)), t(np.asarray(isl)),
                                   *map(t, args))
        for a, c in zip(jo, to):
            assert_bit_equal(np.asarray(a), c.numpy())


def test_alloc_slots_and_nonzero():
    for _ in range(20):
        pool = np.where(RNG.random(200) < 0.3, -1, 5).astype(np.int32)
        want = RNG.random(64) < 0.5
        assert_bit_equal(np.asarray(ju.alloc_slots(jnp.asarray(pool),
                                                   jnp.asarray(want))),
                         tu.alloc_slots(t(pool), t(want)).numpy())
        m = RNG.random(100) < 0.2
        ref = np.asarray(jnp.nonzero(jnp.asarray(m), size=30,
                                     fill_value=100)[0])
        assert_bit_equal(ref.astype(np.int64),
                         tu.nonzero_fixed(t(m), 30, 100).numpy())


def test_dedupe_and_segment():
    keys = RNG.integers(0, 50, 256).astype(np.int32)
    valid = RNG.random(256) > 0.2
    assert_bit_equal(np.asarray(ju.dedupe_keep_last(jnp.asarray(keys),
                                                    jnp.asarray(valid))),
                     tu.dedupe_keep_last(t(keys), t(valid)).numpy())
    sk = np.sort(RNG.integers(0, 1000, 128)).astype(np.int32)
    for lo, hi in [(0, 10), (100, 400), (999, 5000), (50, 50)]:
        jp, jm = ju.segment_in_range(jnp.asarray(sk), jnp.int32(lo),
                                     jnp.int32(hi), 16)
        tp, tm = tu.segment_in_range(t(sk), torch.tensor(lo), torch.tensor(hi),
                                     16)
        assert_bit_equal(np.asarray(jp).astype(np.int64), tp.numpy())
        assert_bit_equal(np.asarray(jm), tm.numpy())


def test_set_where_drops_masked_and_out_of_range():
    dst = torch.arange(10, dtype=torch.int32)
    idx = torch.tensor([3, 10, 5, -1, 7])
    mask = torch.tensor([True, True, False, True, True])
    tu.set_where(dst, mask, idx, torch.tensor([30, 99, 50, 99, 70],
                                              dtype=torch.int32))
    assert dst.tolist() == [0, 1, 2, 30, 4, 5, 6, 70, 8, 9]
    tu.set_where(dst, torch.zeros(5, dtype=torch.bool), idx, -5)
    assert dst.tolist() == [0, 1, 2, 30, 4, 5, 6, 70, 8, 9]


@pytest.mark.parametrize("dtype", ["int8", "int32", "bool"])
def test_set_where_scalar_repeats_a_target(dtype):
    """A scalar value may repeat a target (``set_where``'s rule): every
    hit slot gets the value once, as JAX's ``.at[].set(mode="drop")``
    gives, also where inactive or out-of-range lanes point at slot 0 or
    at a repeated target; on 2-d rows too."""
    rng = np.random.default_rng(11)
    for rows in ((40,), (40, 3)):
        dst = (rng.integers(0, 2, rows) if dtype == "bool"
               else rng.integers(-50, 50, rows)).astype(dtype)
        idx = np.array([3, 3, 3, 5, 0, 0, 40, -1, 7, 7, 39, 3], np.int32)
        mask = np.array([1, 1, 1, 1, 0, 0, 1, 1, 1, 0, 1, 0], bool)
        val = True if dtype == "bool" else 9
        want = np.asarray(jnp.asarray(dst).at[
            jnp.where(jnp.asarray(mask), jnp.asarray(idx), 40)].set(
                val, mode="drop"))
        got = tu.set_where(t(dst), t(mask), t(idx), val)
        assert_bit_equal(want, got.numpy())


# ------------------------------------------------------------------ bloom

@pytest.mark.parametrize("n_words", [32, 1024])
def test_bloom(n_words):
    ks = RNG.integers(0, 1 << 20, 300).astype(np.int32)
    v = RNG.random(300) > 0.3
    row = np.asarray(jbloom.make_row(jnp.asarray(ks), jnp.asarray(v),
                                     n_words))
    assert_bit_equal(row.view(np.int32),
                     bloom.make_row(t(ks), t(v), n_words).numpy())
    filt = np.asarray(jbloom.set_run(jbloom.init(4, 32 * n_words), 2,
                                     jnp.asarray(ks), jnp.asarray(v)))
    q = np.concatenate([ks[:100], RNG.integers(0, 1 << 20, 400)]
                       ).astype(np.int32)
    rid = RNG.integers(-1, 4, 500).astype(np.int32)
    rid[:100] = 2
    want = np.asarray(jbloom.query_per_key(jnp.asarray(filt),
                                           jnp.asarray(rid), jnp.asarray(q)))
    got = bloom.query_per_key(t(filt.view(np.int32)), t(rid), t(q)).numpy()
    assert_bit_equal(want, got)
    assert want[:100][v[:100]].all()


# ---------------------------------------------------------------- tracker

@pytest.mark.parametrize("cap,batch", [(1024, 256), (512, 128), (1021, 256),
                                       (331, 64), (409, 700)])
def test_tracker_access_batched(cap, batch):
    """Each case draws from its own generator, so its inputs do not
    depend on which worker runs it or in what order."""
    rng = np.random.default_rng(cap * 10_000 + batch)
    js, ts = jtracker.init(cap), tracker.init(cap, "cpu")
    for _ in range(5):
        keys = rng.integers(0, 4 * cap, batch).astype(np.int32)
        locs = rng.integers(0, 2, batch).astype(np.int8)
        valid = rng.random(batch) > 0.1
        js = jtracker.access_batched(js, *map(jnp.asarray,
                                              (keys, locs, valid)))
        ts = tracker.access_batched(ts, t(keys), t(locs), t(valid))
        for a, b in zip(js, ts):
            assert_bit_equal(np.asarray(a), b.numpy())
    q = rng.integers(0, 4 * cap, 300).astype(np.int32)
    for a, b in zip(jtracker.lookup_clock(js, jnp.asarray(q)),
                    tracker.lookup_clock(ts, t(q))):
        assert_bit_equal(np.asarray(a), b.numpy())
    assert_bit_equal(np.asarray(jtracker.clock_histogram(js)),
                     tracker.clock_histogram(ts).numpy())
    assert_bit_equal(np.asarray(jtracker.fast_fraction_of_tracked(js)),
                     tracker.fast_fraction_of_tracked(ts).numpy())
    m = rng.random(300) > 0.5
    want = jtracker.set_location(js, jnp.asarray(q), jnp.int8(1),
                                 jnp.asarray(m))
    got = tracker.set_location(ts, t(q), 1, t(m))
    assert_bit_equal(np.asarray(want.loc), got.loc.numpy())


def test_set_location_repeated_keys():
    """``set_location`` with a tracked key repeated in ``keys``: JAX's
    ``.at[].set`` gives loc 1 in every hit slot; a per-lane difference
    add would give key 3's slot 0 + 3 * (1 - 0) = 3."""
    keys = np.arange(10, dtype=np.int32)
    js, ts = jtracker.init(64), tracker.init(64, "cpu")
    js = jtracker.access_batched(js, jnp.asarray(keys),
                                 jnp.zeros(10, jnp.int8), jnp.ones(10, bool))
    ts = tracker.access_batched(ts, t(keys), torch.zeros(10, dtype=torch.int8),
                                torch.ones(10, dtype=torch.bool))
    assert_bit_equal(np.asarray(js.keys), ts.keys.numpy())
    rep = np.array([3, 3, 3, 5], np.int32)
    want = jtracker.set_location(js, jnp.asarray(rep), jnp.int8(1),
                                 jnp.ones(4, bool))
    got = tracker.set_location(ts, t(rep), 1, torch.ones(4, dtype=torch.bool))
    assert_bit_equal(np.asarray(want.loc), got.loc.numpy())
    hit = np.isin(np.asarray(want.keys), [3, 5])
    assert hit.sum() == 2 and np.all(got.loc.numpy()[hit] == 1)


# ----------------------------------------------------------------- mapper

@pytest.mark.parametrize("thr", [0.7, 0.3, 0.05, 1.0])
def test_pin_probabilities_and_decisions(thr):
    for _ in range(10):
        h = RNG.integers(0, 500, 4).astype(np.int32)
        h[RNG.integers(0, 4)] = 0
        want = jmapper.pin_probabilities(jnp.asarray(h), jnp.float32(thr))
        got = mapper.pin_probabilities(t(h), thr)
        assert_bit_equal(np.asarray(want), got.numpy())
    clock = RNG.integers(0, 4, 512).astype(np.int8)
    tracked = RNG.random(512) > 0.2
    key = jax.random.PRNGKey(4)
    from repro_torch.core import prng
    assert_bit_equal(
        np.asarray(jmapper.pin_decisions(jnp.asarray(clock),
                                         jnp.asarray(tracked), want, key)),
        mapper.pin_decisions(t(clock), t(tracked), got,
                             prng.PRNGKey(4)).numpy())


# -------------------------------------------------------------------- obs

def test_bucket_of_us():
    us = np.concatenate([np.exp2(np.arange(-3, 33, 0.5)),
                         RNG.random(1000) * 1e5, [0.0, 1e-9, 1.0, 2.0]]
                        ).astype(np.float32)
    assert_bit_equal(np.asarray(jobs.bucket_of_us(jnp.asarray(us), 32)),
                     tobs.bucket_of_us(t(us), 32).numpy())


def test_step_and_compaction_cost():
    """Modeled costs of random counter deltas: float32 bits equal."""
    from repro.core.compaction import CompactionStats as JStats
    from repro.core.tiers import Counters as JCtr
    from repro_torch.core.compaction import CompactionStats as TStats
    from repro_torch.core.tiers import Counters as TCtr
    for _ in range(50):
        vals = {f: RNG.integers(0, 5000, np.shape(getattr(JCtr.zeros(2), f)))
                .astype(np.int32) for f in JCtr._fields}
        jd = JCtr(**{k: jnp.asarray(v) for k, v in vals.items()})
        td = TCtr(**{k: t(v) for k, v in vals.items()})
        amp = float(RNG.choice([1.0, 3.0]))
        assert_bit_equal(np.asarray(jcost.step_io_us(jd, jcost.CostModel(),
                                                     amp)),
                         tcost.step_io_us(td, tcost.CostModel(), amp).numpy())
        s = RNG.integers(0, 9000, 9).astype(np.int32)
        js = JStats(*[jnp.asarray(x) for x in s])
        ts = TStats(*[t(x) for x in s])
        assert_bit_equal(np.asarray(jcost.compaction_io_us(
            js, jcost.CostModel(), amp)),
            tcost.compaction_io_us(ts, tcost.CostModel(), amp).numpy())


# -------------------------------------------------------------- structure

def test_port_imports_no_jax_and_no_reference_package():
    """Import every module of repro_torch with jax blocked; no module of
    the JAX package may be loaded either."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k, v in sys.modules.items() if v is not None "
        "and (k == 'repro' or k.startswith('repro.') or k == 'jax' or "
        "k.startswith('jax.')))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules "
        "if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_default_device_is_the_card():
    from repro_torch.configs.prismdb_kv import paper_tier_config
    from repro_torch.core.db import PrismDB
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        PrismDB(paper_tier_config(1))


def _inits():
    from repro_torch.configs.prismdb_kv import paper_tier_config
    from repro_torch.core import (bloom, compaction, embedding_store,
                                  engine, policy, prng, tiers, tracker)
    from repro_torch.obs import state as tobs_state
    cfg = paper_tier_config(1)
    ecfg = embedding_store.EmbedStoreConfig(vocab=2048, dim=8, fast_rows=128)
    return {
        "compaction.init_inflight": lambda: compaction.init_inflight(cfg),
        "embedding_store.init": lambda: embedding_store.init(
            ecfg, prng.PRNGKey(0)),
        "embedding_store.engine_init": lambda: embedding_store.engine_init(
            ecfg, prng.PRNGKey(0)),
        "engine.init": lambda: engine.init(engine.EngineConfig(tier=cfg),
                                           prng.PRNGKey(0)),
        "engine.make_op": lambda: engine.make_op(engine.PUT, np.arange(4),
                                                 value_width=4),
        "tiers.init": lambda: tiers.init(cfg),
        "tiers.Counters.zeros": lambda: tiers.Counters.zeros(2),
        "tracker.init": lambda: tracker.init(64),
        "bloom.init": lambda: bloom.init(4, 64),
        "policy.init": lambda: policy.init(),
        "obs.state.init": lambda: tobs_state.init(tobs_state.ObsConfig()),
    }


@pytest.mark.parametrize("name", sorted(_inits()))
def test_every_init_defaults_to_the_card(name):
    """Every public constructor of state resolves ``device=None`` to the
    card, as PrismDB does: without one it raises, it never builds on the
    CPU unasked (a host key from ``prng.PRNGKey`` does not pick the
    device either)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        _inits()[name]()


def test_unsupported_backend_raises():
    from repro_torch.core.db import PrismDB
    from repro_torch.core.tiers import TierConfig
    cfg = TierConfig(key_space=1 << 10, fast_slots=64, slow_slots=256,
                     value_width=1, max_runs=8, run_size=32,
                     bloom_bits_per_run=256, tracker_slots=128, n_buckets=8)
    with pytest.raises(ValueError):
        PrismDB(cfg, backend="pallas", device="cpu")
    # the quantized engine and payload mirrors run
    from repro_torch.core import engine
    db = PrismDB(cfg, compaction_quantum=4, device="cpu")
    op = engine.make_op(engine.PUT, np.arange(4), value_width=1,
                        device="cpu")
    engine.engine_step(db.estate, op, db.ecfg, mirror=lambda p, m: p)


def test_obs_snapshot_is_a_copy():
    """A snapshot keeps its values while the engine goes on updating the
    obs tensors in place (on the CPU, ``.numpy()`` alone shares them), so
    a delta of two snapshots counts the steps between them."""
    from repro_torch.configs.prismdb_kv import paper_tier_config
    from repro_torch.core.db import PrismDB
    from repro_torch.obs import export
    db = PrismDB(paper_tier_config(1), device="cpu")
    s0 = db.obs_snapshot()
    for i in range(4):
        db.put(np.arange(i * 512, (i + 1) * 512))
    s1 = db.obs_snapshot()
    assert int(export.hist_delta(s1, s0).sum()) == 4 * 512
    assert int(s0["hist"].sum()) == 0
