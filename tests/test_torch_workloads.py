"""The port's workload driver (``repro_torch.workloads`` and
``PrismDB.run_workload``) against the JAX package's on the CPU.

UNIFORM and SEQ streams, op kinds, scan lengths, the insert pointer and
the scramble are bit-equal to JAX's.  ZIPF and LATEST ranks go through
float32 ``pow``, which torch and XLA can round one ulp apart (ROADMAP
Queue 3, D3): they are held as tests/test_workloads.py holds XLA against
numpy, every rank within 1 and under 1% of ranks differing.  Engine runs
are held leaf for leaf as tests/test_torch_engine.py holds them (the MSC
score ``obs.ev_score`` to rtol 1e-6): on uniform mixes through
``run_workload`` itself, on a skewed mix through ``run_ops`` fed the one
stream JAX's ``sample_ops`` drew.  Each JAX trajectory is computed once,
inside the one test that compares against it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import workloads as JW
from repro.core import PrismDB as JDB
from repro.core import TierConfig as JTierConfig
from repro.core.engine import OpBatch as JOp
from repro.workloads import sampler as jsampler
from repro_torch import workloads as W
from repro_torch.core import engine, prng
from repro_torch.core.db import PrismDB
from repro_torch.core.tiers import TierConfig
from repro_torch.workloads import reference as R
from repro_torch.workloads import sampler
from repro_torch.workloads.spec import LATEST, SEQ, UNIFORM, ZIPF
from torch_parity import assert_bit_equal, assert_trees_equal

# the CFG of tests/test_workloads.py
CFG_KW = dict(key_space=1 << 12, fast_slots=256, slow_slots=1 << 12,
              value_width=2, max_runs=64, run_size=128,
              bloom_bits_per_run=1 << 12, tracker_slots=1 << 10,
              n_buckets=32, pin_threshold=0.1)
KS, VW = CFG_KW["key_space"], CFG_KW["value_width"]
BATCH, SEG = 64, 12
SCORE_TOL = {".obs.ev_score": 1e-6}
M = 200_000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for this module: its tensors are small, and the
    test workers run side by side (eight threads each would contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(name: str, **kw):
    """The same spec built by both packages."""
    return getattr(JW, name)(**kw), getattr(W, name)(**kw)


# uniform keys on every kind (scan lengths included), and SEQ writes
SPECS = {
    "uniform": dict(read=0.4, delete=0.1, scan=0.2, dist="uniform",
                    scan_len=40),
    "seq": dict(read=0.2, scan=0.3, dist="uniform", wdist="seq",
                scan_len=24),
}


def _jax_ops(seed, jspec, n=24, gst=None, t0=0):
    ops, g = JW.sample_ops(jax.random.PRNGKey(seed), jspec, n, BATCH,
                           key_space=KS, value_width=VW, gst=gst, t0=t0)
    return jax.device_get(ops), int(g.ptr)


def _port_ops(seed, tspec, n=24, gst=None, t0=0):
    ops, g = W.sample_ops(prng.PRNGKey(seed), tspec, n, BATCH, key_space=KS,
                          value_width=VW, gst=gst, t0=t0, device="cpu")
    return ops, g.ptr


def _assert_ops_equal(jops, tops):
    for f in engine.OpBatch._fields:
        assert_bit_equal(np.asarray(getattr(jops, f)),
                         getattr(tops, f).numpy(), f)


# ------------------------------------------------------------- sampling

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_sample_ops_bit_equal(name, seed):
    jspec, tspec = _both("spec", **SPECS[name])
    jops, jptr = _jax_ops(seed, jspec)
    tops, tptr = _port_ops(seed, tspec)
    _assert_ops_equal(jops, tops)
    assert jptr == tptr
    kinds = set(tops.kind.tolist())
    assert kinds >= {engine.GET, engine.PUT, engine.SCAN}, kinds
    if name == "seq":
        n_put = sum(k == engine.PUT for k in tops.kind.tolist())
        assert tptr == KS // 2 + n_put * BATCH


@pytest.mark.parametrize("dist", [UNIFORM, SEQ])
@pytest.mark.parametrize("ptr", [5, KS - 7, 2**31 - 40])
def test_sample_batch_and_keys_bit_equal(dist, ptr):
    """One batch at a time, with the insert pointer near the key space's
    end (SEQ keys wrap) and near int32's (the pointer wraps)."""
    name = "uniform" if dist == UNIFORM else "seq"
    jspec, tspec = _both("spec", read=0.0, dist=name)
    key = prng.PRNGKey(ptr % 1000)
    jg, jop = jsampler.sample_batch(jax.random.PRNGKey(ptr % 1000), jspec,
                                    JW.GenState(ptr=jnp.int32(ptr)),
                                    batch=BATCH, key_space=KS,
                                    value_width=VW)
    tg, top = sampler.sample_batch(key, tspec, W.GenState(ptr=ptr),
                                   batch=BATCH, key_space=KS, value_width=VW,
                                   device="cpu")
    _assert_ops_equal(jax.device_get(jop), top)
    assert int(jg.ptr) == tg.ptr
    jk, jp = jsampler.sample_keys(jax.random.PRNGKey(9), jnp.int32(dist),
                                  jnp.float32(0.99), jnp.int32(0),
                                  jnp.int32(ptr), BATCH, KS)
    tk, tp = sampler.sample_keys(prng.PRNGKey(9), dist, 0.99, 0, ptr, BATCH,
                                 KS)
    assert_bit_equal(np.asarray(jk), tk.numpy(), "keys")
    assert int(jp) == tp


@pytest.mark.parametrize("theta", [0.5, 0.99, 1.2])
def test_zipf_ranks_within_one_rank(theta):
    """Same uniforms (``jax.random``'s, drawn by both) at the smoke's key
    space: every rank within 1 of XLA's, under 1% differing.  The numpy
    reference (whose exponent is rounded from float64) is held so at the
    key space tests/test_workloads.py holds it at."""
    ju = jax.random.uniform(jax.random.PRNGKey(3), (100_000,))
    tu = prng.uniform(prng.PRNGKey(3), (100_000,))
    assert_bit_equal(np.asarray(ju), tu.numpy(), "uniforms")
    for ks in (786_432, 1 << 10):
        jr = np.asarray(jsampler.zipf_ranks(ju, ks, jnp.float32(theta)))
        tr = sampler.zipf_ranks(tu, ks, theta).numpy()
        assert np.abs(jr.astype(np.int64) - tr).max() <= 1
        assert (jr != tr).mean() < 0.01
    host = R.ranks_from_uniforms_host(tu.numpy(), ks, theta)
    assert np.abs(host.astype(np.int64) - tr).max() <= 1
    assert (host != tr).mean() < 0.01


@pytest.mark.parametrize("kind", ["A", "D"])
def test_skewed_streams_within_one_rank(kind):
    """ZIPF (YCSB-A) and LATEST (YCSB-D) streams: kinds, pointer and scan
    lengths bit-equal; each key's rank within 1 of JAX's (the scramble
    is a bijection on a power-of-two key space, so ranks are recovered
    from keys), under 1% of keys differing."""
    jspec, tspec = _both("ycsb", kind=kind)
    jops, jptr = _jax_ops(4, jspec, n=32)
    tops, tptr = _port_ops(4, tspec, n=32)
    assert jptr == tptr
    for f in ("kind", "aux", "valid"):
        assert_bit_equal(np.asarray(getattr(jops, f)),
                         getattr(tops, f).numpy(), f)
    jk, tk = np.asarray(jops.keys), tops.keys.numpy()
    if kind == "A":
        inv = np.empty(KS, np.int64)
        inv[R.scramble_host(np.arange(KS), 0, KS)] = np.arange(KS)
        jr, tr = inv[jk], inv[tk]
    else:                                    # LATEST: rank = ptr - 1 - key
        ptrs = KS // 2 + BATCH * np.cumsum(
            np.concatenate([[0], np.asarray(jops.kind)[:-1] == 0]))
        jr = (ptrs[:, None] - 1 - jk) % KS
        tr = (ptrs[:, None] - 1 - tk) % KS
    assert np.abs(jr - tr).max() <= 1
    assert (jk != tk).mean() < 0.01


@pytest.mark.parametrize("offset", [0, 37, 1 << 30, 2**31 - 1])
@pytest.mark.parametrize("ks", [786_432, 1 << 20, 1000])
def test_scramble_over_the_int32_wrap(offset, ks):
    """Ranks + offset past int32's top: the uint32 wraparound of
    JAX's scramble, in the port's int64 arithmetic."""
    ranks = np.concatenate([np.arange(64), [2**31 - 1, 2**31 - 2,
                                            2**31 - 100, ks - 1]]
                           ).astype(np.int32)
    want = np.asarray(jsampler.scramble(jnp.asarray(ranks),
                                        jnp.int32(offset), ks))
    got = sampler.scramble(torch.from_numpy(ranks), offset, ks).numpy()
    assert_bit_equal(want, got, "scramble")
    assert_bit_equal(R.scramble_host(ranks, offset, ks), got, "host")


def test_port_zipf_matches_analytic_pmf():
    """The port's sampler and reference against the analytic pmfs (the
    distribution checks of tests/test_workloads.py)."""
    ks = 1 << 10
    u = prng.uniform(prng.PRNGKey(0), (M,))
    ranks = sampler.zipf_ranks(u, ks, 0.99).numpy()
    freq = np.bincount(ranks, minlength=ks) / M
    assert 0.5 * np.abs(freq - R.zipf_rank_pmf(ks, 0.99)).sum() < 0.03
    keys = R.zipf_keys_host(np.random.default_rng(1), 1.2, M, ks)
    freq = np.bincount(keys, minlength=ks) / M
    assert 0.5 * np.abs(freq - R.zipf_key_pmf(ks, 1.2)).sum() < 0.03
    latest = R.latest_keys_host(np.random.default_rng(2), 0.99, M, ks, 100)
    assert ((latest < 100) & (latest >= 90)).mean() > 0.3


# ---------------------------------------------------- specs and schedules

def _assert_spec_equal(js, ts, label):
    for f in js._fields:
        a = np.asarray(getattr(js, f))
        b = torch.as_tensor(getattr(ts, f), dtype=torch.float32 if
                            a.dtype == np.float32 else torch.int32).numpy()
        assert_bit_equal(a, b, f"{label}.{f}")


@pytest.mark.parametrize("name", [f"ycsb-{k}" for k in W.YCSB_KINDS]
                         + [f"twitter-{c}" for c in W.TWITTER_CLUSTERS])
def test_canned_specs_field_equal(name):
    fam, arg = name.split("-", 1)
    js, ts = _both(fam, **({"kind": arg} if fam == "ycsb" else
                           {"cluster": arg}))
    _assert_spec_equal(js, ts, name)


@pytest.mark.parametrize("name", W.SCENARIOS)
def test_scenarios_and_spec_at_every_boundary(name):
    """Every scenario's stacked fields and bounds, and the spec of every
    step up to two past the end (the last phase holds), field-equal."""
    n = 37
    js, ts = JW.scenario(name, KS, n), W.scenario(name, KS, n)
    assert_bit_equal(np.asarray(js.bounds), ts.bounds.numpy(), "bounds")
    _assert_spec_equal(js.specs, ts.specs, name)
    assert W.total_batches(ts) == JW.total_batches(js) == n
    assert W.n_phases(ts) == JW.n_phases(js)
    for t in range(n + 3):
        _assert_spec_equal(JW.spec_at(js, jnp.int32(t)), W.spec_at(ts, t),
                           f"{name}@{t}")


def test_spec_defaults():
    """``put`` takes the rest of the mass, theta 0 is uniform, latest
    reads bring seq writes, and too much mass raises."""
    s = W.spec(read=0.3, delete=0.2, scan=0.1, theta=0.0)
    assert (s.dist, s.wdist) == (UNIFORM, UNIFORM)
    assert np.float32(s.p_put) == np.float32(0.4)
    s = W.spec(read=0.95, dist="latest")
    assert (s.dist, s.wdist) == (LATEST, SEQ)
    assert W.spec(read=1.0, wtheta=0.0).wdist == UNIFORM
    assert W.spec(read=1.0).dist == ZIPF
    with pytest.raises(ValueError):
        W.spec(read=0.8, scan=0.3)


def test_trace_round_trip_and_oversized_record():
    rng = np.random.default_rng(0)
    trace = [("put", rng.integers(0, KS, 40)), ("get", rng.integers(0, KS, 64)),
             ("delete", rng.integers(0, KS, 3)),
             ("scan", rng.integers(0, KS, 10), rng.integers(1, 9, 10))]
    ops = W.pack_trace(trace, batch=64, value_width=VW)
    jops = JW.pack_trace(trace, batch=64, value_width=VW)
    _assert_ops_equal(jax.device_get(jops), ops)
    back = W.unpack_trace(ops)
    assert [r[0] for r in back] == [r[0] for r in trace]
    for a, b in zip(back, trace):
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, np.asarray(y, np.int32))
    with pytest.raises(ValueError, match="exceeds batch"):
        W.pack_trace([("put", np.arange(65))], batch=64, value_width=VW)


# ------------------------------------------------------------ engine runs

def _preload():
    r = np.random.default_rng(7)
    return [r.integers(0, KS, 128).astype(np.int32) for _ in range(4)]


def _port(backend: str, seed: int = 0) -> PrismDB:
    db = PrismDB(TierConfig(**CFG_KW), seed=seed, backend=backend,
                 device="cpu")
    for k in _preload():
        db.put(k)
    return db


def _assert_stats(js, ts):
    for f in W.StepStats._fields:
        assert_bit_equal(np.asarray(getattr(js, f)),
                         getattr(ts, f).cpu().numpy(), f)


@pytest.mark.parametrize("work", ["ycsb-A-uniform", "twitter-cluster39"])
def test_run_workload_matches_jax(work):
    """Two segments of one uniform mix through both facades'
    ``run_workload``, the second continuing the first's stream: StepStats,
    tier state, counters, policy, obs and rng bit-equal after each
    (``ev_score`` to rtol 1e-6), on both port backends."""
    mk = {"ycsb-A-uniform": lambda w: w.ycsb("A", theta=0.0),
          "twitter-cluster39": lambda w: w.twitter("cluster39")}[work]
    jdb = JDB(JTierConfig(**CFG_KW), seed=0)
    for k in _preload():
        jdb.put(k)
    jdb.reset_workload(seed=2)
    want = []
    for _ in range(2):
        st = jax.device_get(jdb.run_workload(mk(JW), SEG, BATCH))
        want.append((st, jax.device_get(jdb.estate)))
    assert jdb.counters["compactions"] > 0
    for backend in ("reference", "cuda"):
        db = _port(backend)
        db.reset_workload(seed=2)
        for js, jstate in want:
            _assert_stats(js, db.run_workload(mk(W), SEG, BATCH))
            assert_trees_equal(jstate, engine.state_to_numpy(db.estate),
                               SCORE_TOL)
        assert db.counters == jdb.counters
        assert db.dispatches == len(_preload()) + 2 * SEG


def test_skewed_mix_on_a_jax_drawn_stream():
    """YCSB-B (zipf 0.99 reads and writes): JAX's ``sample_ops`` draws the
    stream once and both engines run it through ``run_ops``."""
    jops, _ = JW.sample_ops(jax.random.PRNGKey(11), JW.ycsb("B"), 2 * SEG,
                            BATCH, key_space=KS, value_width=VW)
    jops = jax.device_get(jops)
    jdb = JDB(JTierConfig(**CFG_KW), seed=0)
    for k in _preload():
        jdb.put(k)
    jres = jax.device_get(jdb.run_ops(JOp(*map(jnp.asarray, jops))))
    jstate = jax.device_get(jdb.estate)
    assert jdb.counters["compactions"] > 0
    ops = engine.OpBatch(*[torch.from_numpy(np.array(x)) for x in jops])
    for backend in ("reference", "cuda"):
        db = _port(backend)
        res = db.run_ops(ops)
        for a, b in zip(jres, res):
            assert_bit_equal(np.asarray(a), b.numpy())
        assert_trees_equal(jstate, engine.state_to_numpy(db.estate),
                           SCORE_TOL)


def _equal_runs(a: PrismDB, b: PrismDB):
    assert_trees_equal(engine.state_to_numpy(a.estate),
                       engine.state_to_numpy(b.estate))


@pytest.mark.parametrize("quantum", [0, 5])
def test_run_workload_equals_sample_ops_then_run_ops(quantum):
    """The port's fused segment on a skewed phased mix equals its own
    ``sample_ops`` followed by ``run_ops``, bit for bit, and takes no more
    host reads: generation adds none."""
    sched = W.scenario("flash-crowd", KS, 2 * SEG)
    a, b = (PrismDB(TierConfig(**CFG_KW), seed=0,
                    compaction_quantum=quantum, device="cpu")
            for _ in range(2))
    for k in _preload():
        a.put(k)
        b.put(k)
    a.reset_workload(seed=5)
    h0 = engine.HOST_READS.n
    st = a.run_workload(sched, 2 * SEG, BATCH)
    h_fused = engine.HOST_READS.n - h0
    ops, g = W.sample_ops(prng.PRNGKey(5), sched, 2 * SEG, BATCH,
                          key_space=KS, value_width=VW, device="cpu")
    h0 = engine.HOST_READS.n
    res = b.run_ops(ops)
    assert engine.HOST_READS.n - h0 == h_fused
    assert a._gen.ptr == g.ptr
    assert_bit_equal(ops.kind.numpy(), st.kind.numpy(), "kind")
    get = (ops.kind == engine.GET)[:, None]
    assert_bit_equal(res.found.sum(1, dtype=torch.int32).numpy(),
                     st.found.numpy(), "found")
    assert_bit_equal(((res.src == 0) & get).sum(1, dtype=torch.int32)
                     .numpy(), st.fast.numpy(), "fast")
    _equal_runs(a, b)


def test_two_segments_equal_one_across_a_phase_boundary():
    """7 + 17 batches of a three-phase schedule (the first phase ends at
    9) equal one segment of 24: stream, phase timeline and state."""
    sched = W.scenario("hotset-shift", KS, 2 * SEG)
    a, b = _port("reference"), _port("reference")
    a.reset_workload(seed=3)
    b.reset_workload(seed=3)
    whole = a.run_workload(sched, 2 * SEG, BATCH)
    parts = [b.run_workload(sched, 7, BATCH),
             b.run_workload(sched, 2 * SEG - 7, BATCH)]
    for f in W.StepStats._fields:
        assert torch.equal(getattr(whole, f),
                           torch.cat([getattr(p, f) for p in parts]))
    assert b._wt == a._wt == 2 * SEG
    _equal_runs(a, b)


def test_reset_workload_is_reproducible():
    a, b = _port("reference"), _port("reference")
    a.reset_workload(seed=9)
    a.run_workload(W.ycsb("C"), 4, BATCH)
    a.reset_workload(seed=9)
    assert (a._gen, a._wt) == (W.init_gen(KS), 0)
    assert torch.equal(a._wrng, prng.PRNGKey(9))
    b.reset_workload(seed=9)
    sa = a.run_workload(W.ycsb("E"), 6, BATCH)
    sb = b.run_workload(W.ycsb("E"), 6, BATCH)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)
    assert int(sa.returned.sum()) > 0          # YCSB-E returns scan keys
    assert a.pol.phase.shape == () and a.promote and not a.precise
