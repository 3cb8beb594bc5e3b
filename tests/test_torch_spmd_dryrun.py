"""The dry run's SPMD half (``roofline/comm_cost``, ``roofline/
buffer_cost``, ``launch/mesh.fake_device_mesh``, ``sharding.
distribute_tree``): a function run on DTensors as rank 0 of a mesh over
a fake process group, its local work, its collectives and its buffers
counted.

* exact against a hand count: a column- then row-parallel MLP (one
  all-reduce of its output), and a Shard -> Shard redistribution, which
  the CPU mesh carries out as an all-gather and a chunk and the count
  records as the one all-to-all NCCL would run; on a 1x1 mesh, the
  MLP's output and temp bytes and an in-place update's alias bytes;
* a 1x1 mesh communicates nothing;
* the multi-pod train cells of gemma3-1b and stablelm-12b at published
  width move bytes, some over a group that spans "pod" (JAX's
  ``test_multi_pod_cells_have_pod_collectives``);
* against JAX on 4 forced host devices (a 2 x 2 ("data", "model") mesh),
  in a subprocess (``JAX_SIDE``), run once a session: the collectives
  of XLA's compiled program of one reduced phi4-mini block and of the
  whole reduced prefill equal the port's, kind by kind, under
  ``hlo_cost.analyze``'s parse; the reduced qwen3-moe prefill's differ,
  and the test states by how much (ROADMAP Queue 3, D-items); JAX's
  ``dryrun.collective_bytes`` counts each all-reduce twice (its pattern
  also matches the op's name where a later line reads it);
* against the buffer sizes of XLA's ``memory_analysis`` of the same
  compiled programs and of a reduced phi4-mini train step: argument and
  output bytes equal, alias bytes equal on the train step compiled with
  its state donated (but for the step count, which the port makes anew),
  and the temp bytes in a pinned ratio (ROADMAP Queue 3, D9).
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
from fractions import Fraction
from pathlib import Path

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ShapeConfig, get_arch, reduced
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape, fake_device_mesh
from repro_torch.models import model, moe
from repro_torch.roofline.comm_cost import KINDS, spmd_cost

ROOT = Path(__file__).resolve().parents[1]
MESH = MeshShape(("data", "model"), (2, 2))
BATCH, SEQ = 4, 16
DENSE, MOE = "phi4-mini-3.8b", "qwen3-moe-235b-a22b"
JAX_TIMEOUT_S = 300

# The JAX side, in a process of its own with four forced host devices: for
# each reduced config, the collectives of XLA's compiled program of one
# block (layer 0, x [BATCH, SEQ, D] sharded as ("batch", "seq", "embed"),
# the output held to x's sharding), of the whole forward, and for the moe
# config of layer 0's expert-parallel MoE FFN (``moe_ffn_ep_local``, the
# opt variant's ``shard_map``; its output and aux loss), under
# ``hlo_cost.analyze`` and
# ``dryrun.collective_bytes``; pickled to argv[1].
JAX_SIDE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["DRYRUN_DEVICES"] = "4"
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import get_arch, reduced
    from repro.distributed import sharding as S
    from repro.configs.base import ShapeConfig
    from repro.launch.dryrun import (_sds, abstract_state, batch_specs_tree,
                                     collective_bytes)
    from repro.launch.specs import input_specs
    from repro.models import model as M
    from repro.models.moe import moe_ffn_ep_local
    from repro.roofline import hlo_cost
    from repro.train import trainer as T
    jax.config.update("jax_platform_name", "cpu")
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    B, SEQ = {batch}, {seq}
    is_spec = lambda s: isinstance(s, tuple)

    def abstract(tree, specs):
        ms = S.spec_tree(specs, tree, mesh)
        return jax.tree.map(lambda a, sp: jax.ShapeDtypeStruct(
            a.shape, a.dtype, sharding=NamedSharding(mesh, sp)), tree, ms,
            is_leaf=lambda s: isinstance(s, P))

    def sharded(shape, dtype, logical):
        return jax.ShapeDtypeStruct(shape, dtype, sharding=NamedSharding(
            mesh, S.logical_to_spec(logical, mesh, shape=shape)))

    def counts(lowered):
        compiled = lowered.compile()
        hlo, ma = compiled.as_text(), compiled.memory_analysis()
        return {{"hlo_cost": hlo_cost.analyze(hlo)["collectives"],
                 "collective_bytes": collective_bytes(hlo),
                 "results": len(jax.tree.leaves(lowered.out_info)),
                 "memory": {{k: int(getattr(ma, k + "_size_in_bytes"))
                            for k in ("argument", "output", "temp",
                                      "alias")}}}}

    out = {{}}
    with jax.set_mesh(mesh):
        for name in {names!r}:
            cfg = reduced(get_arch(name))
            p, specs = M.init_params(cfg, jax.random.PRNGKey(0))
            blk = jax.tree.map(lambda a: a[0], p["blocks"])
            bspec = jax.tree.map(lambda s: tuple(s[1:]), specs["blocks"],
                                 is_leaf=is_spec)
            x = sharded((B, SEQ, cfg.d_model), jnp.float32,
                        ("batch", "seq", "embed"))

            def block(b, x):
                pos = jnp.broadcast_to(jnp.arange(SEQ)[None], (B, SEQ))
                return M._block_apply(cfg, b, x, pos, jnp.int32(-1), "attn",
                                      cfg.moe, "reference")[0]

            out[name, "block"] = counts(jax.jit(
                block, out_shardings=x.sharding).lower(abstract(blk, bspec),
                                                       x))
            toks = sharded((B, SEQ), jnp.int32, ("batch", "seq"))
            out[name, "prefill"] = counts(jax.jit(
                lambda p, t: M.forward(cfg, p, {{"tokens": t}},
                                       remat=False)[0]).lower(
                abstract(p, specs), toks))
            if not cfg.moe:
                tcfg = T.TrainConfig()
                shape = ShapeConfig("t", SEQ, B, "train")
                st_shapes, st_specs = abstract_state(cfg, tcfg)
                args = (_sds(st_shapes, st_specs, mesh),
                        _sds(input_specs(cfg, shape),
                             batch_specs_tree(cfg, shape), mesh))
                step = T.make_train_step(cfg, tcfg)
                out[name, "train"] = counts(jax.jit(step).lower(*args))
                out[name, "train_donated"] = counts(jax.jit(
                    step, donate_argnums=0).lower(*args))
            if cfg.moe:
                ep = cfg.replace(moe_dispatch="ep_local")
                out[name, "ep_local"] = counts(jax.jit(
                    lambda f, x: (lambda o, e: (o, e["aux_loss"]))(
                        *moe_ffn_ep_local(f, ep, x))).lower(
                    abstract(blk["ffn"], bspec["ffn"]), x))
    with open(sys.argv[1], "wb") as fh:
        pickle.dump(out, fh)
""").format(batch=BATCH, seq=SEQ, names=(DENSE, MOE))


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    """The JAX side (``JAX_SIDE``), run once a session: the test workers
    share its file, the first to come runs it under a lock."""
    from filelock import FileLock
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent                  # shared by the session's workers
    out = root / "jax_spmd_collectives.pkl"
    with FileLock(str(root / "jax_spmd_collectives.lock")):
        if not out.exists():
            proc = subprocess.run(
                [sys.executable, "-c", JAX_SIDE, str(out)], cwd=ROOT,
                env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                     "JAX_PLATFORMS": "cpu"},
                capture_output=True, text=True, timeout=JAX_TIMEOUT_S)
            assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as fh:
        return pickle.load(fh)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _port(name: str, what: str) -> dict:
    """``comm_cost.spmd_cost``'s count of ``JAX_SIDE``'s block, prefill,
    expert-parallel FFN or train step, on DTensors on a 2 x 2 fake mesh,
    the cell's arguments passed to it (the train step is the dry run's
    cell: bfloat16 state, as JAX's ``abstract_state``)."""
    cfg = reduced(get_arch(name))
    sharding.register_strategies()
    if what == "train":
        cell = dryrun.build_cell(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                                 sharding.DEFAULT_RULES, False)
        with fake_device_mesh(MESH) as mesh:
            return dryrun.spmd_count(cell, mesh)
    with fake_device_mesh(MESH) as mesh:
        p = model.init_params(cfg, None, torch.float32, "meta")
        specs = model.param_specs(cfg)
        x = sharding.distribute_tree(("batch", "seq", "embed"),
                                     _meta(BATCH, SEQ, cfg.d_model), mesh)
        if what == "block":
            args = (sharding.distribute_tree(specs["blocks"][0],
                                             p["blocks"][0], mesh), x)
            fn = lambda blk, x: model._block_apply(
                cfg, blk, x, model._positions_of(x), -1, "attn", cfg.moe,
                "reference")[0]
        elif what == "prefill":
            args = (sharding.distribute_tree(specs, p, mesh),
                    sharding.distribute_tree(
                        ("batch", "seq"),
                        _meta(BATCH, SEQ, dtype=torch.int32), mesh))
            fn = lambda params, toks: model.forward(
                cfg, params, {"tokens": toks}, remat=False)[0]
        else:                               # the expert-parallel FFN
            args = (sharding.distribute_tree(specs["blocks"][0]["ffn"],
                                             p["blocks"][0]["ffn"], mesh), x)
            ep = cfg.replace(moe_dispatch="ep_local")
            fn = lambda ffn, x: (lambda o, e: (o, e["aux_loss"]))(
                *moe.moe_ffn_ep_local(ffn, ep, x))
        with sharding.use_mesh(mesh), implicit_replication(), \
                torch.no_grad():
            return spmd_cost(fn, *args)[1]


def _as_ints(coll: dict) -> dict:
    return {k: int(v) for k, v in coll.items()}


# ----------------------------------------------------- against a hand count

def test_parallel_mlp_counts_one_all_reduce():
    """x [8, 16, 32] sharded over "data", w_up [32, 64] over "model" on
    its columns, w_down [64, 32] on its rows: no collective until the
    output is asked for whole over "model", then one all-reduce of rank
    0's [4, 16, 32] float32 block.  The FLOPs are rank 0's two local
    matmuls, 2 x 64 x 32 x 32 each."""
    b, s, d, f = 8, 16, 32, 64
    with fake_device_mesh(MESH) as mesh:
        x = sharding.from_global(_meta(b, s, d), mesh, [Shard(0),
                                                        Replicate()])
        w_up = sharding.from_global(_meta(d, f), mesh, [Replicate(),
                                                        Shard(1)])
        w_down = sharding.from_global(_meta(f, d), mesh, [Replicate(),
                                                          Shard(0)])

        def mlp():
            y = torch.relu(x @ w_up) @ w_down
            return y.redistribute(mesh, [Shard(0), Replicate()])

        y, cost = spmd_cost(mlp)
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert cost["collectives"] == {"all-reduce": (b // 2) * s * d * 4,
                                   "count_all-reduce": 1}
    assert cost["collective_bytes"] == (b // 2) * s * d * 4
    assert cost["flops"] == 2 * (2 * (b // 2) * s * d * (f // 2))


def test_shard_to_shard_counts_one_all_to_all():
    """Shard(0) -> Shard(1) over "data" is one all-to-all of rank 0's
    result, [8, 8, 4] float32, though the CPU mesh runs it as an
    all-gather and a chunk; no all-gather is counted."""
    with fake_device_mesh(MESH) as mesh:
        x = sharding.from_global(_meta(8, 16, 4), mesh,
                                 [Shard(0), Replicate()])
        y, cost = spmd_cost(lambda: x.redistribute(
            mesh, [Shard(1), Replicate()]))
    assert tuple(y.placements) == (Shard(1), Replicate())
    assert tuple(y.to_local().shape) == (8, 8, 4)
    assert cost["collectives"] == {"all-to-all": 8 * 8 * 4 * 4,
                                   "count_all-to-all": 1}


@pytest.mark.parametrize("arch,kind", [("gemma3-1b", "train"),
                                       ("qwen3-moe-235b-a22b", "prefill"),
                                       ("rwkv6-7b", "decode")])
def test_one_by_one_mesh_moves_nothing(arch, kind):
    """A reduced cell on a 1x1 mesh: every leaf whole on rank 0, no
    collective, and rank 0's FLOPs are the global count's."""
    cfg = reduced(get_arch(arch))
    shape = ShapeConfig("t", SEQ, BATCH, kind)
    one = MeshShape(("data", "model"), (1, 1))
    cell = dryrun.build_cell(cfg, shape, sharding.DEFAULT_RULES, False)
    with fake_device_mesh(one) as mesh:
        got = dryrun.spmd_count(cell, mesh)
    cell = dryrun.build_cell(cfg, shape, sharding.DEFAULT_RULES, False)
    with sharding.use_mesh(one), dryrun._scans_by_trip_count():
        from repro_torch.roofline.op_cost import op_cost
        _, whole = op_cost(cell["fn"], *cell["args"])
    assert got["collectives"] == {} and got["collective_bytes"] == 0
    assert got["flops"] == whole["flops"] > 0


def test_parallel_mlp_buffers_on_one_by_one_mesh():
    """relu(x @ w_up) @ w_down on a 1x1 mesh, its arguments x [8, 16, 32],
    w_up [32, 64], w_down [64, 32] float32 (32,768 bytes): the peak is
    reached while relu writes its [8, 16, 64] result beside its input
    (2 x 32,768 bytes); the output is y [8, 16, 32] (16,384), so temp is
    65,536 - 16,384 and arguments + output + temp is the peak."""
    b, s, d, f = 8, 16, 32, 64
    with fake_device_mesh(MeshShape(("data", "model"), (1, 1))) as mesh:
        rep = [Replicate(), Replicate()]
        args = [sharding.from_global(_meta(*shape), mesh, rep)
                for shape in ((b, s, d), (d, f), (f, d))]
        y, cost = spmd_cost(lambda x, w_up, w_down:
                            torch.relu(x @ w_up) @ w_down, *args)
    buf = cost["buffers"]
    assert tuple(y.to_local().shape) == (b, s, d)
    assert buf["arguments"] == (b * s * d + 2 * d * f) * 4
    assert buf["output"] == b * s * d * 4 and buf["alias"] == 0
    assert buf["peak"] == buf["arguments"] + 2 * b * s * f * 4
    assert buf["temp"] == 2 * b * s * f * 4 - b * s * d * 4
    assert buf["unseen"] == [] and cost["collectives"] == {}


def test_in_place_update_on_one_by_one_mesh_aliases_its_parameter():
    """p.sub_(g * 0.1) with p, g [64, 32] float32: the result is p's own
    storage, so alias bytes equal the parameter's (8,192), and the one
    temporary is g * 0.1."""
    with fake_device_mesh(MeshShape(("data", "model"), (1, 1))) as mesh:
        rep = [Replicate(), Replicate()]
        p, g = (sharding.from_global(_meta(64, 32), mesh, rep)
                for _ in range(2))
        out, cost = spmd_cost(lambda p, g: p.sub_(g * 0.1), p, g)
    buf = cost["buffers"]
    assert out is p
    assert buf["output"] == buf["alias"] == 64 * 32 * 4
    assert buf["arguments"] == 2 * 64 * 32 * 4
    assert buf["temp"] == 64 * 32 * 4
    assert buf["peak"] == buf["arguments"] + buf["output"] + buf["temp"] \
        - buf["alias"]


# ------------------------------------------------------ the production mesh

@pytest.mark.parametrize("arch", ["gemma3-1b", "stablelm-12b"])
def test_multi_pod_train_cells_move_pod_collectives(arch, tmp_path):
    """The 512-chip train cells at published width move collective
    bytes, and some over a group spanning "pod"; the record keeps JAX's
    keys: ``collectives`` by kind with their counts, ``hlo_cost`` with
    their sum; rank 0's FLOPs are at least the even split's."""
    rec = dryrun.run_cell(arch, "train_4k", True, str(tmp_path))
    assert rec["ok"], rec.get("error")
    coll = rec["collectives"]
    assert set(coll) <= set(KINDS) | {"count_" + k for k in KINDS}
    assert rec["hlo_cost"]["collective_bytes"] == sum(
        v for k, v in coll.items() if not k.startswith("count_")) > 0
    assert any("pod" in axes.split("+") and n > 0
               for axes, n in rec["collective_axes"].items())
    assert rec["hlo_cost"]["flops"] >= rec["cost_analysis"]["flops"]


# --------------------------------------------------------- against JAX (XLA)

def test_block_collectives_equal_jax(jx):
    """One reduced phi4-mini block on the 2 x 2 mesh: the same
    collectives, kind by kind, as XLA's compiled program (two
    all-reduces of rank 0's [2, 16, 64] float32 activations: after the
    attention's and the MLP's row-parallel projections)."""
    got = _port(DENSE, "block")["collectives"]
    print("port", got, "jax", jx[DENSE, "block"]["hlo_cost"])
    assert got == _as_ints(jx[DENSE, "block"]["hlo_cost"])
    assert got == {"all-reduce": 2 * 2 * SEQ * 64 * 4, "count_all-reduce": 2}


def test_dense_prefill_collectives_equal_jax(jx):
    """The whole reduced phi4-mini prefill (2 layers, the embedding over
    a vocab-sharded table, the tied head): the same collectives as XLA's,
    kind by kind."""
    got = _port(DENSE, "prefill")["collectives"]
    print("port", got, "jax", jx[DENSE, "prefill"]["hlo_cost"])
    assert got == _as_ints(jx[DENSE, "prefill"]["hlo_cost"])


def test_moe_prefill_collectives_differ_from_jax(jx):
    """The reduced qwen3-moe prefill (global dispatch) parts from XLA's
    choices (D-item, ROADMAP Queue 3): DTensor gathers every token to
    each rank for the dispatch's sort and sums each rank's experts'
    combine once, XLA all-reduces more, smaller pieces.  Port / JAX, by
    kind: all-reduce bytes 41,088 / 91,648 (9 / 13 ops), all-gather bytes
    37,888 / 7,168 (8 / 6 ops)."""
    got = _port(MOE, "prefill")["collectives"]
    want = _as_ints(jx[MOE, "prefill"]["hlo_cost"])
    print("port", got, "jax", want)
    ratio = {k: Fraction(got[k], want[k]) for k in want}
    assert set(got) == set(want)
    assert ratio == {"all-reduce": Fraction(41088, 91648),
                     "count_all-reduce": Fraction(9, 13),
                     "all-gather": Fraction(37888, 7168),
                     "count_all-gather": Fraction(8, 6)}


def test_ep_local_collectives_against_jax(jx):
    """The opt variant's expert-parallel MoE FFN of one reduced qwen3-moe
    layer on the 2 x 2 mesh, JAX's ``shard_map`` against the port's
    ``on_local_shards`` (JAX's program returns the aux loss too: XLA
    drops a collective whose result nothing reads).  The same all-gather
    (the router, sharded over its experts, gathered whole: [64, 8]
    float32).  The sums over "model" of the parts' outputs ([2 x 16, 64]
    float32) and of the aux loss move the same 8,196 bytes, in two
    all-reduces on the port and in one on XLA, which combines them into
    one tuple-shaped all-reduce (D8); ``hlo_cost.analyze`` reads that
    tuple as 0 bytes (F10)."""
    got = _port(MOE, "ep_local")["collectives"]
    want = _as_ints(jx[MOE, "ep_local"]["hlo_cost"])
    print("port", got, "jax", want)
    assert got["all-gather"] == want["all-gather"] == 64 * 8 * 4
    assert got["count_all-gather"] == want["count_all-gather"] == 1
    assert got["all-reduce"] == 2 * 16 * 64 * 4 + 4
    assert (got["count_all-reduce"], want["count_all-reduce"]) == (2, 1)
    assert want["all-reduce"] == 0


def test_jax_collective_bytes_counts_each_all_reduce_twice(jx):
    """Reference fault: JAX's ``dryrun.collective_bytes`` matches
    "all-reduce" wherever a line names the op, also as the operand of the
    next op, so on the reduced phi4-mini block it reports twice what
    XLA's program runs (``hlo_cost.analyze``'s parse, which reads op
    calls only, and the port's count)."""
    cb = jx[DENSE, "block"]["collective_bytes"]
    hc = _as_ints(jx[DENSE, "block"]["hlo_cost"])
    assert {k: Fraction(cb[k], hc[k]) for k in hc} == {
        "all-reduce": 2, "count_all-reduce": 2}


# ---------------------------------------- buffer sizes against XLA's (D9)

CELLS = [(DENSE, "block"), (DENSE, "prefill"), (MOE, "prefill"),
         (MOE, "ep_local"), (DENSE, "train")]
# the port's temp bytes over XLA's on the 2 x 2 mesh, measured once (the
# train step against JAX's dry-run program, which donates nothing)
D9 = {(DENSE, "block"): Fraction(33024, 24576),
      (DENSE, "prefill"): Fraction(8452, 80816),
      (MOE, "prefill"): Fraction(175004, 479856),
      (MOE, "ep_local"): Fraction(33003, 419472),
      (DENSE, "train"): Fraction(262156, 140288)}


@pytest.mark.parametrize("name,what", CELLS)
def test_buffer_sizes_against_jax(jx, name, what):
    """Rank 0's argument and output bytes equal XLA's on each reduced
    cell (DTensor lays every result out as XLA does here), once XLA's
    table of its result tuple's buffer pointers, 8 bytes a result where
    a program returns more than one (37 for the train step, whose layers
    JAX stacks), is added to the port's; no cell
    aliases in either program (JAX's dry run donates nothing) but the
    port's train step, which updates its state in place: its alias
    bytes are those of XLA's program with the state donated, less the
    step count's 4 (``optimizer.apply`` makes ``step + 1`` anew).  The
    temp bytes part from XLA's (eager frees against XLA's buffer reuse)
    by the ratio measured once (D9)."""
    got = _port(name, what)["buffers"]
    want = jx[name, what]["memory"]
    print("port", got, "jax", want)
    results = jx[name, what]["results"]
    table = 8 * results if results > 1 else 0
    assert got["arguments"] == want["argument"]
    assert got["output"] + table == want["output"]
    if what == "train":
        donated = jx[name, "train_donated"]["memory"]
        assert got["alias"] == donated["alias"] - 4 > 0
        assert (want["alias"], donated["output"]) == (0, want["output"])
    else:
        assert got["alias"] == want["alias"] == 0
    assert Fraction(got["temp"], want["temp"]) == D9[name, what]
