"""The port's obs export plane (``repro_torch.obs``: ``snapshot``,
``bucket_of_us_np``, ``events_table``, ``timeline_table``,
``to_records``, ``write_jsonl``, ``maybe_trace``) against the JAX
package's on the CPU: the cases of tests/test_obs.py:140-253 and the
quantized event kinds of tests/test_compaction_incremental.py:152-164.

Snapshots of the same op stream hold exactly JAX's keys, every leaf
bit-equal but ``ev_score`` (rtol 1e-6, ROADMAP Queue 3, D2); every table
is equal to JAX's row for row, ``msc_score`` and ``io_us`` at rtol 1e-6
(D2, D5).  Each JAX trajectory runs once, inside the one test that
compares with it.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PrismDB as JDB
from repro.core import TierConfig as JTierConfig
from repro.core import compaction as jcompaction
from repro.core import engine as jengine
from repro.core import tiers as jtiers
from repro.obs import export as jexport
from repro.obs import state as jstate
from repro_torch import obs
from repro_torch.core import compaction, engine, tiers
from repro_torch.core.db import PartitionedDB, PrismDB
from repro_torch.core.tiers import TierConfig
from repro_torch.obs import export
from repro_torch.obs import state as obs_state
from test_torch_partitioned import (assert_rows_equal,
                                    assert_snapshots_equal,
                                    assert_tables_equal)
from torch_parity import assert_bit_equal

# the CFG of tests/test_obs.py
CFG_KW = dict(key_space=512, fast_slots=64, slow_slots=1024,
              value_width=1, max_runs=32, run_size=32,
              bloom_bits_per_run=1 << 10, tracker_slots=256,
              n_buckets=16, pin_threshold=0.1)
# the CFG of tests/test_compaction_incremental.py
CFG_Q_KW = dict(CFG_KW, value_width=2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for this module: its tensors are small, and the
    test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32)


# ----------------------------------------------------- bucket function

def test_bucket_of_us_np_bit_equal_on_every_exponent():
    """Every float32 exponent (subnormals, zero, inf and NaN included),
    both signs, five mantissas: the port's numpy mirror equals JAX's and
    both packages' device functions."""
    e = np.arange(256, dtype=np.int64)
    m = np.array([0, 1, 12345, 0x400000, 0x7FFFFF], np.int64)
    s = np.array([0, 1], np.int64)
    bits = (s[:, None, None] << 31) | (e[None, :, None] << 23) | \
        m[None, None, :]
    us = bits.reshape(-1).astype(np.uint32).view(np.float32)
    for nb in (16, 32):
        got = export.bucket_of_us_np(us, nb)
        assert_bit_equal(jexport.bucket_of_us_np(us, nb), got, "numpy")
        assert_bit_equal(np.asarray(jstate.bucket_of_us(jnp.asarray(us),
                                                        nb)), got, "jax")
        assert_bit_equal(obs_state.bucket_of_us(torch.from_numpy(us),
                                                nb).numpy(), got, "port")
        assert set(got.tolist()) == set(range(nb))


# ------------------------------------------- snapshot, tables, JSON lines

def _ops():
    """6 random put batches, then keys 0..95 put and 0..63 read, 32 a
    batch (one batch shape: one JAX compile)."""
    rng = np.random.default_rng(1)
    out = [(jengine.PUT, rng.integers(0, CFG_KW["key_space"], 32))
           for _ in range(6)]
    out += [(jengine.PUT, np.arange(i, i + 32)) for i in (0, 32, 64)]
    out += [(jengine.GET, np.arange(i, i + 32)) for i in (0, 32)]
    return [(k, keys.astype(np.int32)) for k, keys in out]


def _drive(db, ops) -> None:
    for kind, keys in ops:
        (db.put if kind == jengine.PUT else db.get)(keys)


def test_snapshot_tables_and_jsonl_match_jax(tmp_path):
    """The snapshot of one engine has exactly JAX's keys (the per-partition
    ring positions included) and leaves; the timeline rows sum to the
    counters; events, timeline and records equal JAX's; the JSON lines
    round-trip and equal JAX's file line for line."""
    ops = _ops()
    jdb = JDB(JTierConfig(**CFG_KW), seed=0)
    _drive(jdb, ops)
    jsnap = jdb.obs_snapshot()
    assert jdb.counters["compactions"] > 0
    db = PrismDB(TierConfig(**CFG_KW), seed=0, device="cpu")
    _drive(db, ops)
    snap = db.obs_snapshot()
    assert_snapshots_equal(jsnap, snap)
    assert_bit_equal(np.asarray([len(ops)], np.int32),
                     snap["t_pos_per_part"], "t_pos_per_part")
    assert_tables_equal(jexport, jsnap, snap)

    rows = export.timeline_table(snap)
    assert len(rows) == len(ops)
    ctr = db.counters
    for f in ("puts", "gets", "slow_writes", "compactions", "fast_writes"):
        assert sum(r[f] for r in rows) == ctr[f], f
    assert len(export.events_table(snap)) == ctr["compactions"]

    paths = [tmp_path / "jax.jsonl", tmp_path / "port.jsonl"]
    n = [jexport.write_jsonl(paths[0], jsnap, meta={"run": "unit"}),
         obs.write_jsonl(paths[1], snap, meta={"run": "unit"})]
    lines = [[json.loads(x) for x in p.read_text().splitlines()]
             for p in paths]
    assert n[0] == n[1] == len(lines[1])
    assert_rows_equal(*lines)
    meta = lines[1][0]
    assert meta["record"] == "meta" and meta["run"] == "unit"
    assert {x["record"] for x in lines[1]} == {"meta", "hist", "step",
                                               "compaction"}
    tot = [x for x in lines[1] if x["record"] == "hist"
           and x["kind"] == "total"][0]
    assert sum(tot["counts"]) == 32 * len(ops)


def test_event_ring_wraps_monotonically():
    """Seven events through rings of four: ``ev_count`` counts them all,
    the table keeps the last four oldest first, as JAX's does."""
    jcfg, cfg = jstate.ObsConfig(event_len=4), obs_state.ObsConfig(
        event_len=4)
    jo, to = jstate.init(jcfg), obs_state.init(cfg, device="cpu")
    z, jz = _i(0), jnp.zeros((), jnp.int32)
    for i in range(7):
        jst = jcompaction.CompactionStats(
            selected_lo=jz, selected_hi=jz, score=jnp.float32(i),
            n_demoted=jz, n_promoted=jz, n_merged=jnp.int32(i),
            n_superseded=jz, n_run_read=jz, n_run_written=jz)
        jo = jstate.record_compaction(jo, jcfg, step=jnp.int32(i),
                                      trigger=jz, stats=jst)
        st = compaction.CompactionStats(
            selected_lo=z, selected_hi=z,
            score=torch.tensor(float(i), dtype=torch.float32),
            n_demoted=z, n_promoted=z, n_merged=_i(i), n_superseded=z,
            n_run_read=z, n_run_written=z)
        to = obs_state.record_compaction(to, cfg, step=_i(i), trigger=0,
                                         stats=st)
    snap = export.snapshot(to)
    assert snap["ev_count"] == 7
    rows = export.events_table(snap)
    assert [r["step"] for r in rows] == [3, 4, 5, 6]
    assert [r["moved"] for r in rows] == [3, 4, 5, 6]
    jsnap = jexport.snapshot(jo)
    assert_snapshots_equal(jsnap, snap)
    assert_rows_equal(jexport.events_table(jsnap), rows)


def test_timeline_ring_wraps():
    """Six steps through a timeline of four: the last four rows, oldest
    first; histograms never wrap."""
    jcfg, cfg = jstate.ObsConfig(timeline_len=4), obs_state.ObsConfig(
        timeline_len=4)
    jo, to = jstate.init(jcfg), obs_state.init(cfg, device="cpu")
    for i in range(6):
        jo = jstate.record_step(
            jo, jcfg, kind=jnp.int32(0), n_ops=jnp.int32(8),
            delta=jtiers.Counters.zeros()._replace(puts=jnp.int32(i)))
        to = obs_state.record_step(
            to, cfg, kind=0, n_ops=_i(8),
            delta=tiers.Counters.zeros(device="cpu")._replace(puts=_i(i)))
    snap = export.snapshot(to)
    rows = export.timeline_table(snap)
    assert [r["puts"] for r in rows] == [2, 3, 4, 5]
    assert int(snap["hist"].sum()) == 6 * 8
    jsnap = jexport.snapshot(jo)
    assert_snapshots_equal(jsnap, snap)
    assert_rows_equal(jexport.timeline_table(jsnap), rows)


def test_stacked_states_merge_by_summation():
    """Three stacked ObsStates: histograms, ring positions and event
    counts summed, the rings kept per partition; equal to JAX's merge of
    the same steps."""
    jcfg, cfg = jstate.ObsConfig(), obs_state.ObsConfig()
    jparts, parts = [], []
    for seed in range(3):
        jo, to = jstate.init(jcfg), obs_state.init(cfg, device="cpu")
        rng = np.random.default_rng(seed)
        for _ in range(3):
            reads = [int(rng.integers(1, 50)), int(rng.integers(0, 20))]
            jo = jstate.record_step(
                jo, jcfg, kind=jnp.int32(1), n_ops=jnp.int32(16),
                delta=jtiers.Counters.zeros()._replace(
                    reads=jnp.asarray(reads, jnp.int32)))
            to = obs_state.record_step(
                to, cfg, kind=1, n_ops=_i(16),
                delta=tiers.Counters.zeros(device="cpu")._replace(
                    reads=_i(reads)))
        jparts.append(jo)
        parts.append(to)
    stacked = obs_state.ObsState(*[torch.stack(x) for x in zip(*parts)])
    snap = export.snapshot(stacked)
    assert snap["n_partitions"] == 3
    want = np.sum([p.hist.numpy() for p in parts], axis=0)
    assert_bit_equal(want, snap["hist"], "hist")
    assert snap["t_pos"] == 9 and int(snap["hist"].sum()) == 9 * 16
    assert len(export.timeline_table(snap)) == 9
    jsnap = jexport.snapshot(jax.tree.map(lambda *xs: jnp.stack(xs),
                                          *jparts))
    assert_snapshots_equal(jsnap, snap)
    assert_tables_equal(jexport, jsnap, snap)


def test_partitioned_db_merged_snapshot():
    """Every routed valid lane is in some partition's histogram, the
    events are the compactions, and the merged snapshot has the keys of
    one engine's."""
    db = PartitionedDB(TierConfig(**CFG_KW), 2, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(4):
        db.put(rng.integers(0, CFG_KW["key_space"], 64).astype(np.int32))
    snap = db.obs_snapshot()
    assert int(snap["hist"].sum()) == 4 * 64 - db.dropped
    assert snap["ev_count"] == sum(db.counters["compactions"])
    assert snap["n_partitions"] == 2
    one = PrismDB(TierConfig(**CFG_KW), seed=0, device="cpu")
    assert sorted(one.obs_snapshot()) == sorted(snap)
    assert len(export.timeline_table(snap)) == 2 * 4


# ------------------------------------------------ quantized event kinds

def _op_stream(n_batches: int, batch: int, seed: int):
    """tests/test_compaction_incremental.py's stream: PUT, GET, PUT,
    DELETE batches of seeded keys, as numpy (kinds, keys)."""
    rng = np.random.default_rng(seed)
    kinds = [(jengine.PUT, jengine.GET, jengine.PUT, jengine.DELETE)[t % 4]
             for t in range(n_batches)]
    keys = [rng.integers(0, CFG_Q_KW["key_space"], size=batch)
            .astype(np.int32) for _ in range(n_batches)]
    return np.asarray(kinds, np.int32), np.stack(keys)


def _port_events(quantum: int, kinds, keys) -> dict:
    db = PrismDB(TierConfig(**CFG_Q_KW), seed=0, compaction_quantum=quantum,
                 backend="reference", device="cpu")
    ops = [engine.make_op(int(k), x, value_width=CFG_Q_KW["value_width"],
                          device="cpu") for k, x in zip(kinds, keys)]
    db.run_ops(engine.OpBatch(*[torch.stack(x) for x in zip(*ops)]))
    return db.obs_snapshot()


def test_quantized_event_ring_kinds():
    """A small quantum shows starts and resumes; an "infinite" one pairs
    every start with a commit; run to completion is all commits.  The
    small quantum's snapshot and tables equal JAX's."""
    names = obs.EVENT_KIND_NAMES
    kinds, keys = _op_stream(96, 32, seed=3)
    snap = _port_events(8, kinds, keys)
    ev = {e["kind"] for e in export.events_table(snap)}
    assert {names[obs.EV_START], names[obs.EV_RESUME]} <= ev
    ev = {e["kind"] for e in export.events_table(
        _port_events(1 << 20, kinds, keys))}
    assert {names[obs.EV_START], names[obs.EV_COMMIT]} <= ev
    assert names[obs.EV_RESUME] not in ev
    ev = {e["kind"] for e in export.events_table(
        _port_events(0, kinds, keys))}
    assert ev == {names[obs.EV_COMMIT]}

    jops = [jengine.make_op(int(k), x, value_width=CFG_Q_KW["value_width"])
            for k, x in zip(kinds, keys)]
    jdb = JDB(JTierConfig(**CFG_Q_KW), seed=0, compaction_quantum=8,
              backend="reference")
    jdb.run_ops(jax.tree.map(lambda *xs: jnp.stack(xs), *jops))
    jsnap = jdb.obs_snapshot()
    assert_snapshots_equal(jsnap, snap)
    assert_tables_equal(jexport, jsnap, snap)


def test_maybe_trace_writes_a_chrome_trace(tmp_path, capsys):
    """``maybe_trace(None)`` traces nothing; a directory gets one Chrome
    trace holding the block's operators."""
    with obs.maybe_trace(None) as where:
        assert where is None
    with obs.maybe_trace(str(tmp_path / "tr")) as where:
        torch.arange(8).sum()
    assert where == str(tmp_path / "tr")
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())
             ["traceEvents"]}
    assert "aten::sum" in names
    assert "[obs]" not in capsys.readouterr().err
