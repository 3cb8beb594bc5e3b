"""The port's partitioned store (``repro_torch.core.db.PartitionedDB``,
``route_batch``, ``utils.part_of_key`` / ``pack_buckets``, the
multi-tenant ``run_workload`` and the process-group exchange of
``repro_torch.distributed.collectives``) against the JAX package's
``PartitionedDB(mesh=None)`` on the CPU.

Each JAX trajectory runs once, inside the one test that compares with it
(``drive``: the routed segment of tests/test_partitioned_mesh.py, then a
SEQ write segment through every tenant so that every partition compacts,
then a routed get).  Counters, drops, every leaf of the stacked engine
state, the routed get results, the StepStats and the obs snapshot and its
tables are bit-equal, but for the MSC score of each compaction
(``obs.ev_score``, and the tables' ``msc_score``), a float32 sum held to
rtol 1e-6 (ROADMAP Queue 3, D2).  ZIPF keys go through float32 ``pow``
and are held as tests/test_torch_workloads.py holds them (D3: ranks
within 1); UNIFORM and SEQ tenants are bit-equal.

The gloo cases spawn D ranks on 127.0.0.1 that import only
``repro_torch``: JAX is imported inside the ``jx`` fixture, never at
module level, because each child imports this module to find its entry
point.
"""
from __future__ import annotations

import datetime
import pickle
import socket
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import workloads as W
from repro_torch.core import engine, utils
from repro_torch.core.db import PartitionedDB, route_batch
from repro_torch.core.tiers import TierConfig
from repro_torch.distributed import collectives
from repro_torch.obs import export
from repro_torch.workloads import reference as R
from torch_parity import assert_bit_equal, assert_trees_equal

# the CFG of tests/test_partitioned_mesh.py
CFG_KW = dict(key_space=1 << 12, fast_slots=256, slow_slots=1 << 12,
              value_width=1, max_runs=32, run_size=128,
              bloom_bits_per_run=1 << 11, tracker_slots=512,
              n_buckets=16, pin_threshold=0.1)
# the CFG of tests/test_workloads.py (the multi-tenant cases)
CFG_W_KW = dict(CFG_KW, value_width=2, max_runs=64,
                bloom_bits_per_run=1 << 12, tracker_slots=1 << 10,
                n_buckets=32)
KS = CFG_KW["key_space"]
SCORE_TOL = {".obs.ev_score": 1e-6}
FLOAT_FIELDS = ("msc_score", "io_us")
SPAWN_TIMEOUT_S = 120


@pytest.fixture
def jx():
    """The JAX package's modules (imported here, not at module level)."""
    import jax
    from repro import workloads as JW
    from repro.core import TierConfig as JTierConfig
    from repro.core import db as jdb
    from repro.core import utils as jutils
    from repro.obs import export as jexport
    jax.config.update("jax_platform_name", "cpu")
    return types.SimpleNamespace(jax=jax, W=JW, TierConfig=JTierConfig,
                                 db=jdb, utils=jutils, export=jexport)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for this module: its tensors are small, and the
    test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seq_writes(w):
    """Write-only SEQ keys: every tenant fills its partition past its
    fast tier."""
    return w.spec(read=0.0, dist="uniform", wdist="seq")


def drive(db, w, seed: int = 0, batch: int = 64) -> dict:
    """tests/test_partitioned_mesh.py's ``drive`` (three rounds of a
    routed put and get, then ``run_workload(ycsb("A"), 6, batch)``), then
    a SEQ write segment of the same shape and a routed get.  Works on
    either package's facade (``w`` is its ``workloads``)."""
    rng = np.random.default_rng(seed)
    gets = []
    for _ in range(3):
        db.put(rng.integers(0, KS, batch).astype(np.int32))
        gets.append(db.get(rng.integers(0, KS, batch).astype(np.int32)))
    db.reset_workload(seed=seed)
    stats = [db.run_workload(w.ycsb("A"), 6, batch),
             db.run_workload(seq_writes(w), 6, batch)]
    gets.append(db.get(rng.integers(0, KS, batch).astype(np.int32)))
    return {"gets": gets, "stats": stats}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_snapshots_equal(want: dict, got: dict) -> None:
    """Two obs snapshots: the same keys, every leaf bit-equal but
    ``ev_score`` (rtol 1e-6, D2)."""
    assert sorted(want) == sorted(got)
    for k in want:
        if isinstance(want[k], int):
            assert type(got[k]) is int and got[k] == want[k], k
        elif k == "ev_score":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)
        else:
            assert_bit_equal(np.asarray(want[k]), got[k], k)


def assert_rows_equal(want: list, got: list) -> None:
    """Two tables (lists of dicts) row for row: equal fields, the floats
    of ``FLOAT_FIELDS`` at rtol 1e-6 (the MSC score, D2; the modeled
    I/O, D5)."""
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert list(a) == list(b), i
        for k in a:
            if k in FLOAT_FIELDS:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=0,
                                           err_msg=f"row {i} {k}")
            else:
                assert type(a[k]) is type(b[k]) and a[k] == b[k], (i, k)


def assert_tables_equal(jexport, jsnap: dict, tsnap: dict) -> None:
    assert_rows_equal(jexport.events_table(jsnap), export.events_table(tsnap))
    assert_rows_equal(jexport.timeline_table(jsnap),
                      export.timeline_table(tsnap))
    assert_rows_equal(list(jexport.to_records(jsnap, {"run": "t"})),
                      list(export.to_records(tsnap, {"run": "t"})))


# ------------------------------------------------ routing and buckets

@pytest.mark.parametrize("n,cap", [(1, 8), (4, 8), (4, 40), (7, 5)])
def test_route_and_pack_bit_equal(jx, n, cap):
    """``part_of_key``, ``route_batch`` and ``pack_buckets`` (with invalid
    lanes, skewed keys that overflow a bucket, and keys past int32's
    sign bit's half) bit-equal to JAX's."""
    jnp = jx.jax.numpy
    rng = np.random.default_rng(n * 100 + cap)
    keys = np.concatenate([rng.integers(0, 2**31 - 1, 96),
                           np.full(24, 12345), np.arange(16)]
                          ).astype(np.int32)
    valid = rng.random(keys.shape[0]) > 0.2
    tk, tv = torch.from_numpy(keys), torch.from_numpy(valid)
    part = utils.part_of_key(tk, n)
    assert_bit_equal(np.asarray(jx.utils.part_of_key(jnp.asarray(keys), n)),
                     part.numpy(), "part")
    for want, got in [
            (jx.db.route_batch(jnp.asarray(keys), n, cap),
             route_batch(tk, n, cap)),
            (jx.utils.pack_buckets(jnp.asarray(keys), jnp.asarray(
                part.numpy()), n, cap, valid=jnp.asarray(valid)),
             utils.pack_buckets(tk, part, n, cap, valid=tv))]:
        for name, a, b in zip(("buckets", "valid", "dropped"), want, got):
            assert_bit_equal(np.asarray(a), b.numpy(), name)
    _, bvalid, dropped = got
    assert int(bvalid.sum()) + int(dropped.sum()) == int(valid.sum())


def test_identical_keys_drop_exactly_half():
    """tests/test_engine.py's drop case: 64 identical keys land on one
    partition, whose pad is 2 * 64 / 4 = 32; a balanced batch drops
    none."""
    db = PartitionedDB(TierConfig(**CFG_KW), 4, seed=0, device="cpu")
    db.put(np.full(64, 5, np.int32))
    assert db.dropped == 32
    assert sum(db.dropped_per_partition) == 32
    assert max(db.dropped_per_partition) == 32
    db.put(np.arange(64, dtype=np.int32))
    assert db.dropped == 32


def test_partitioned_put_get_round_trips():
    """tests/test_engine.py's round trip: every key put is found by the
    routed get, in the row ``route_batch`` gives it."""
    db = PartitionedDB(TierConfig(**CFG_KW), 4, seed=0, device="cpu")
    keys = np.arange(128, dtype=np.int32)
    db.put(keys)
    vals, found, src = db.get(keys)
    routed, valid, _ = route_batch(torch.from_numpy(keys), 4, 64)
    assert set(routed[valid & found].tolist()) == set(range(128))
    hit = valid & found
    assert torch.equal(vals[hit][:, 0], routed[hit].to(torch.float32))
    assert bool((src[hit] == 0).all())
    assert db.dispatches == 2


def test_group_and_device_rules():
    """A process group needs more than one rank dividing the partitions,
    and carries only tensors on its backend's device; ``device=None``
    means the card and raises without one."""
    cfg = TierConfig(**CFG_KW)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PartitionedDB(cfg, 2)
    port = _free_port()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="more than one rank"):
            PartitionedDB(cfg, 2, group=dist.group.WORLD, device="cpu")
        # gloo carries CPU tensors only
        with pytest.raises(RuntimeError, match="does not carry"):
            collectives.exchange_keys(torch.zeros(8, dtype=torch.int32,
                                                  device="meta"), 2, 8,
                                      dist.group.WORLD, local_parts=2)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ against JAX, one process

@pytest.mark.parametrize("p,quantum", [(1, 0), (4, 0), (2, 8)],
                         ids=["p1", "p4", "p2-q8"])
def test_partitioned_matches_jax(jx, p, quantum):
    """``drive`` through both packages: counters, drops, every leaf of
    the stacked engine state (pools, indexes, tracker, policy, obs, rng,
    the in-flight carry), the routed get results, StepStats, and the obs
    snapshot (exactly JAX's keys) with its tables, on both port
    backends."""
    jdb = jx.db.PartitionedDB(jx.TierConfig(**CFG_KW), n_partitions=p,
                              seed=0, compaction_quantum=quantum, mesh=None)
    want = jx.jax.device_get(drive(jdb, jx.W))
    jstate = jx.jax.device_get(jdb.estate)
    jsnap = jdb.obs_snapshot()
    assert min(jdb.counters["compactions"]) > 0
    if p > 1:   # a shared schedule diverges per tenant (split keys)
        kinds = np.asarray(want["stats"][0].kind)
        assert (kinds != kinds[:1]).any()
    for backend in ("cuda", "reference"):
        db = PartitionedDB(TierConfig(**CFG_KW), p, seed=0, backend=backend,
                           compaction_quantum=quantum, device="cpu")
        h0 = engine.HOST_READS.n
        got = drive(db, W)
        assert db.host_reads == engine.HOST_READS.n - h0 > 0
        assert db.counters == jdb.counters
        assert db.dropped_per_partition == jdb.dropped_per_partition
        assert_trees_equal(jstate, engine.state_to_numpy(db.stacked()),
                           SCORE_TOL)
        assert_trees_equal(jstate.tier, engine.state_to_numpy(db.state),
                           {".obs.ev_score": 1e-6})
        assert_trees_equal(jstate.pol, engine.state_to_numpy(db.pol))
        for a, b in zip(want["gets"], got["gets"]):
            for x, y in zip(a, b):
                assert_bit_equal(np.asarray(x), y.numpy(), "get")
        for a, b in zip(want["stats"], got["stats"]):
            for f in W.StepStats._fields:
                assert_bit_equal(np.asarray(getattr(a, f)),
                                 getattr(b, f).numpy(), f)
        tsnap = db.obs_snapshot()
        assert_snapshots_equal(jsnap, tsnap)
        assert_tables_equal(jx.export, jsnap, tsnap)
        # a client batch is one dispatch in both; a workload segment is
        # one in JAX and n_batches here
        assert db.dispatches == jdb.dispatches - 2 + 2 * 6


def test_multitenant_run_workload_matches_jax(jx, monkeypatch):
    """tests/test_workloads.py's four tenants (YCSB-A, YCSB-C, Twitter
    cluster39, write-only uniform), one per partition: kinds bit-equal
    for every tenant; the UNIFORM tenants' StepStats and partitions
    bit-equal; the ZIPF tenants' drawn keys within one rank of the keys
    JAX draws from the same split key (D3)."""
    n_batches, batch = 16, 64
    mk = lambda w: [w.ycsb("A"), w.ycsb("C"), w.twitter("cluster39"),
                    w.spec(read=0.0, dist="uniform")]
    jdb = jx.db.PartitionedDB(jx.TierConfig(**CFG_W_KW), n_partitions=4,
                              seed=0, mesh=None)
    jdb.reset_workload(seed=0)
    jst = jx.jax.device_get(jdb.run_workload(mk(jx.W), n_batches, batch))
    jstate = jx.jax.device_get(jdb.estate)
    jctr = jdb.counters
    assert jdb.dispatches == 1
    assert (np.asarray(jst.kind)[1] == engine.GET).all()
    assert (np.asarray(jst.kind)[3] == engine.PUT).all()
    assert jctr["compactions"][2] > 0 and jctr["compactions"][3] > 0

    drawn = []
    sample = W.runner.sample_batch

    def record(*a, **kw):
        out = sample(*a, **kw)
        drawn.append(out[1])
        return out

    monkeypatch.setattr(W.runner, "sample_batch", record)
    db = PartitionedDB(TierConfig(**CFG_W_KW), 4, seed=0, device="cpu")
    db.reset_workload(seed=0)
    st = db.run_workload(mk(W), n_batches, batch)
    assert db.dispatches == n_batches
    assert st.kind.shape == (4, n_batches)
    assert_bit_equal(np.asarray(jst.kind), st.kind.numpy(), "kind")
    ctr = db.counters
    for i in (2, 3):                             # UNIFORM tenants
        for f in W.StepStats._fields:
            assert_bit_equal(np.asarray(getattr(jst, f))[i],
                             getattr(st, f)[i].numpy(), f)
        assert_trees_equal(
            jx.jax.tree.map(lambda x, i=i: np.asarray(x)[i], jstate),
            engine.state_to_numpy(db.estates[i]), SCORE_TOL)
        assert {k: v[i] for k, v in ctr.items()} == \
            {k: v[i] for k, v in jctr.items()}
    jkeys = jx.jax.random.split(jx.jax.random.PRNGKey(0), 4)
    inv = np.empty(KS, np.int64)
    inv[R.scramble_host(np.arange(KS), 0, KS)] = np.arange(KS)
    for i in (0, 1):                             # ZIPF tenants (D3)
        ops, _ = jx.W.sample_ops(jkeys[i], mk(jx.W)[i], n_batches, batch,
                                 key_space=KS,
                                 value_width=CFG_W_KW["value_width"])
        mine = drawn[i * n_batches:(i + 1) * n_batches]
        for f in ("kind", "aux", "valid"):
            assert_bit_equal(np.asarray(getattr(ops, f)),
                             torch.stack([getattr(o, f) for o in mine])
                             .numpy(), f)
        jk = np.asarray(ops.keys)
        tk = torch.stack([o.keys for o in mine]).numpy()
        assert np.abs(inv[jk] - inv[tk]).max() <= 1
        assert (jk != tk).mean() < 0.01


# ------------------------------------------------ process groups (gloo)

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _result(db, got: dict) -> dict:
    """What a run leaves, in numpy: the (gathered) stacked state,
    counters, drops, snapshot, and this process's get rows with their
    masks."""
    return {"state": engine.state_to_numpy(db.stacked()),
            "counters": db.counters, "dropped": db.dropped_per_partition,
            "snap": db.obs_snapshot(), "dispatches": db.dispatches,
            "gets": [[_np(x) for x in g] for g in got["gets"]]}


def _ragged_matches_exchange(rank: int, p: int, world: int) -> bool:
    """``ragged_all_to_all`` of packed buckets and their masks gives the
    rows and masks of ``exchange_keys`` on the same keys."""
    keys = torch.from_numpy(np.random.default_rng(rank).integers(
        0, KS, 40).astype(np.int32))
    valid = torch.arange(40) % 5 != 0
    lp, cap = p // world, 12
    buckets, bvalid, _ = utils.pack_buckets(
        keys, utils.part_of_key(keys, p), p, cap, valid=valid)
    got = collectives.ragged_all_to_all(buckets, bvalid,
                                        dist.group.WORLD, lp)
    want = collectives.exchange_keys(keys, p, cap, dist.group.WORLD,
                                     local_parts=lp, valid=valid)
    return all(torch.equal(a, b) for a, b in zip(got, want[:2]))


def _gloo_rank(rank: int, world: int, p: int, port: int, out: str) -> None:
    """One rank of the gloo run: ``drive`` on this rank's partitions, the
    result written to ``out.<rank>``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        db = PartitionedDB(TierConfig(**CFG_KW), p, seed=0, device="cpu",
                           group=dist.group.WORLD)
        res = _result(db, drive(db, W))
        res["jax_modules"] = sorted(m for m in sys.modules if m == "jax"
                                    or m.startswith(("jax.", "repro.")))
        res["ragged_equal"] = _ragged_matches_exchange(rank, p, world)
        with open(f"{out}.{rank}", "wb") as fh:
            pickle.dump(res, fh)
    finally:
        dist.destroy_process_group()


def _spawn(world: int, p: int, out: str) -> None:
    """Run ``world`` gloo ranks; kill them all and fail if any is still
    running after SPAWN_TIMEOUT_S or exits with an error."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_gloo_rank, args=(r, world, p, port, out))
             for r in range(world)]
    for pr in procs:
        pr.start()
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=SPAWN_TIMEOUT_S)
    try:
        for pr in procs:
            left = (deadline - datetime.datetime.now()).total_seconds()
            pr.join(max(left, 0.0))
        hung = [i for i, pr in enumerate(procs) if pr.is_alive()]
        assert not hung, f"gloo ranks {hung} still running after " \
            f"{SPAWN_TIMEOUT_S} s"
        codes = [pr.exitcode for pr in procs]
        assert codes == [0] * world, f"gloo ranks exited with {codes}"
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()


@pytest.mark.parametrize("world,p", [(2, 4), (4, 8)])
def test_gloo_group_matches_one_process(tmp_path, world, p):
    """``PartitionedDB(group=...)`` over ``world`` gloo ranks (p / world
    partitions each) runs ``drive`` to the one-process port's result bit
    for bit: the gathered state, counters, drops and snapshot on every
    rank, and each rank's routed get results on its own partitions (the
    exchange's rows hold each source's bucket in rank order, so the
    valid lanes come in the one-process order)."""
    out = str(tmp_path / "rank")
    _spawn(world, p, out)
    one = PartitionedDB(TierConfig(**CFG_KW), p, seed=0, device="cpu")
    want = _result(one, drive(one, W))
    assert min(want["counters"]["compactions"]) > 0
    lp = p // world
    for r in range(world):
        with open(f"{out}.{r}", "rb") as fh:
            got = pickle.load(fh)
        assert got["jax_modules"] == []
        assert got["ragged_equal"]
        assert got["counters"] == want["counters"]
        assert got["dropped"] == want["dropped"]
        assert got["dispatches"] == want["dispatches"]
        assert_trees_equal(want["state"], got["state"])
        assert_snapshots_equal(want["snap"], got["snap"])
        for (wv, wf, ws), (gv, gf, gs) in zip(want["gets"], got["gets"]):
            assert gf.shape[0] == lp
            for j in range(lp):
                # the found lanes' values (the keys) and sources, in order
                k = r * lp + j
                assert_bit_equal(wv[k][wf[k]], gv[j][gf[j]], "vals")
                assert_bit_equal(ws[k][wf[k]], gs[j][gf[j]], "src")
