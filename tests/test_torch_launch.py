"""The port's launch plane against the JAX package on the CPU: the cells
(``configs/base.ShapeConfig``, ``SHAPES``, ``applicable_shapes``), their
inputs (``launch/specs``), the logical-axis specs of parameters, caches
and the training state (``model.param_specs``, ``model.cache_specs``,
``optimizer.moment_specs``, ``trainer.state_specs``), the sharding rules
(``distributed/sharding``) on the two production meshes, the dry run's
argument bytes and refusals (``launch/dryrun``), the local mesh
(``launch/mesh``) and the serving launcher (``launch/serve``).

Everything here is integers, names and shapes, held equal; the serving
launcher's tokens and counters are held equal as tests/test_torch_serve.py
holds ``ServeEngine``'s.  JAX's production meshes need 256 or 512
devices, so both packages' ``logical_to_spec`` read a stand-in mesh with
the same ``axis_names`` and ``axis_sizes``.  The JAX package's
``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported, so its
``abstract_params`` is rebuilt here (``jax.eval_shape`` of
``init_params``).
"""
import dataclasses
import functools
import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import base as jbase
from repro.distributed import sharding as jsharding
from repro.launch import serve as jlaunch_serve
from repro.launch import specs as jspecs_mod
from repro.models import model as JM
from repro.train import optimizer as jopt
from repro.train import trainer as JT
from repro_torch.configs import base
from repro_torch.core.tree import is_spec, map_tree
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, mesh as mesh_mod
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import specs as specs_mod
from repro_torch.models import model
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer as T

ARCHS = sorted(jbase.all_archs())
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
DECODE_OPT_RULES = {**jsharding.DEFAULT_RULES,
                    "batch": ("pod", "data", "model"),
                    "cache_head_dim": None}
# the opt variant's cells that run the expert-parallel MoE dispatch
# ("ep_local"): every cell of the moe archs
EP_LOCAL_CELLS = [(a, s.name) for a in ("granite-moe-3b-a800m",
                                        "jamba-v0.1-52b",
                                        "qwen3-moe-235b-a22b")
                  for s in base.applicable_shapes(base.get_arch(a))]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the tensors are small, and the test workers run
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stand_in(name):
    names, sizes = MESHES[name]
    return types.SimpleNamespace(axis_names=names, axis_sizes=sizes)


def _plain(x):
    """Specs of either package as nested dicts of tuples."""
    if isinstance(x, PartitionSpec):
        return tuple(x)
    if hasattr(x, "_fields"):
        return {k: _plain(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _is_spec(x):
    return isinstance(x, (tuple, PartitionSpec)) and all(
        isinstance(e, (str, type(None), tuple)) for e in x)


def _stacked_specs(cfg):
    """``model.param_specs`` restacked into JAX's layout: ``blocks`` (and
    ``enc_blocks``) one dict with "layers" first, or for the hybrid family
    one per pattern position, ``blocks["pos{i}"]``.  Every layer stacked
    into one leaf has the same specs."""
    tree = model.param_specs(cfg)
    period = len(cfg.pattern) if cfg.family == "hybrid" else 1

    def stack(blocks):
        assert all(b == blocks[0] for b in blocks)
        return map_tree(lambda s: ("layers", *s), blocks[0], is_leaf=is_spec)

    out = {k: v for k, v in tree.items() if k not in ("blocks", "enc_blocks")}
    if cfg.family == "hybrid":
        out["blocks"] = {f"pos{i}": stack(tree["blocks"][i::period])
                         for i in range(period)}
    else:
        out["blocks"] = stack(tree["blocks"])
    if cfg.family == "audio":
        out["enc_blocks"] = stack(tree["enc_blocks"])
    return out


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch, reduced=False):
    """JAX's parameter shapes and specs (as ``abstract_params``), its train
    state's shapes, and its cache's shapes and specs, at published width
    (or reduced)."""
    cfg = jbase.get_arch(arch)
    if reduced:
        cfg = jbase.reduced(cfg)
    cap = {}

    def params(rng):
        p, cap["params"] = JM.init_params(cfg, rng, jnp.bfloat16)
        return p

    def state(rng):
        st, _ = JT.init_state(cfg, JT.TrainConfig(compress_grads=True), rng,
                              jnp.bfloat16)
        return st

    def cache():
        c, cap["cache"] = JM.init_cache(cfg, 128, 32768, jnp.bfloat16)
        return c

    key = jax.random.PRNGKey(0)
    return types.SimpleNamespace(
        cfg=cfg, params=jax.eval_shape(params, key), pspecs=cap["params"],
        state=jax.eval_shape(state, key), cache=jax.eval_shape(cache),
        cspecs=cap["cache"])


# ------------------------------------------------------------ the cells

def test_shapes_and_applicable_shapes_equal_jax():
    assert [dataclasses.astuple(s) for s in base.SHAPES.values()] == \
        [dataclasses.astuple(s) for s in jbase.SHAPES.values()]
    assert list(base.SHAPES) == list(jbase.SHAPES)
    assert [f.name for f in dataclasses.fields(base.ShapeConfig)] == \
        [f.name for f in dataclasses.fields(jbase.ShapeConfig)]
    for arch in ARCHS:
        assert [s.name for s in base.applicable_shapes(base.get_arch(arch))] \
            == [s.name for s in jbase.applicable_shapes(
                jbase.get_arch(arch))], arch


_DTYPES = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.int32): torch.int32}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_decode_specs_equal_jax(arch):
    cfg, jcfg = base.get_arch(arch), jbase.get_arch(arch)
    for s in base.applicable_shapes(cfg):
        js = jbase.SHAPES[s.name]
        for got, want in ((specs_mod.input_specs(cfg, s),
                           jspecs_mod.input_specs(jcfg, js)),
                          (specs_mod.decode_specs(cfg, s),
                           jspecs_mod.decode_specs(jcfg, js))):
            assert list(got) == list(want), (arch, s.name)
            for k, v in got.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == want[k].shape, (arch, s.name, k)
                assert v.dtype == _DTYPES[jnp.dtype(want[k].dtype)]


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "whisper-small", "gemma3-1b"])
def test_concrete_batch(arch):
    """A concrete batch has the input specs' keys and shapes (its floats in
    float32, as JAX's), and one generator seed gives one batch."""
    cfg = base.reduced(base.get_arch(arch))
    b = specs_mod.concrete_batch(cfg, "train", 2, 6,
                                 torch.Generator().manual_seed(0))
    want = specs_mod.input_specs(cfg, base.ShapeConfig("x", 6, 2, "train"))
    assert list(b) == list(want)
    for k, v in b.items():
        assert v.shape == want[k].shape
        assert v.dtype == (torch.float32 if want[k].dtype.is_floating_point
                           else torch.int64)
    again = specs_mod.concrete_batch(cfg, "train", 2, 6,
                                     torch.Generator().manual_seed(0))
    assert all(torch.equal(b[k], again[k]) for k in b)
    if cfg.m_rope:
        assert b["positions"][0, :, 1].tolist() == [0, 1, 2, 3, 4, 5]


# ------------------------------------------------------------ spec trees

@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_jax(arch):
    """``param_specs`` (restacked into JAX's layout) and ``cache_specs``
    equal JAX's trees at published width and reduced; ``param_specs`` has
    the tree of ``init_params`` and one name per tensor dimension."""
    for red in (False, True):
        j = _jax_abstract(arch, red)
        cfg = base.get_arch(arch)
        cfg = base.reduced(cfg) if red else cfg
        assert _stacked_specs(cfg) == j.pspecs, (arch, red)
        assert model.cache_specs(cfg) == j.cspecs, (arch, red)
    p = model.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    shapes = []
    map_tree(lambda s, t: shapes.append((len(s), t.dim())),
             model.param_specs(cfg), p, is_leaf=is_spec)
    assert shapes and all(a == b for a, b in shapes)
    assert len(shapes) == len(list(model.leaves(p)))


# ----------------------------------------------------------- the rules

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_specs_equal_jax(arch, mesh):
    """``spec_tree`` of the params, the cache and the train state (with
    and without error feedback) equals JAX's, leaf for leaf, under the
    default rules and under the opt variant's decode rules; the port's
    per-layer layout gives each stacked leaf's spec without its
    "layers" entry."""
    j = _jax_abstract(arch)
    cfg = base.get_arch(arch)
    m = _stand_in(mesh)
    for rules in (jsharding.DEFAULT_RULES, DECODE_OPT_RULES):
        with jsharding.axis_rules(rules), sharding.axis_rules(rules):
            for specs, jspecs, shapes in (
                    (_stacked_specs(cfg), j.pspecs, j.params),
                    (model.cache_specs(cfg), j.cspecs, j.cache)):
                assert _plain(sharding.spec_tree(specs, shapes, m)) == \
                    _plain(jsharding.spec_tree(jspecs, shapes, m)), arch
            for compress in (False, True):
                tcfg = T.TrainConfig(compress_grads=compress)
                jtcfg = JT.TrainConfig(compress_grads=compress)
                st = T.state_specs(_stacked_specs(cfg), tcfg)
                jst = JT.state_specs(j.pspecs, jtcfg)
                assert _plain(st) == _plain(jst)
                shapes = j.state if compress else j.state._replace(ef=None)
                assert _plain(sharding.spec_tree(st, shapes, m)) == _plain(
                    jsharding.spec_tree(jst, shapes, m))
    meta = model.init_params(cfg, None, torch.bfloat16, "meta")
    flat = sharding.spec_tree(model.param_specs(cfg), meta, m)
    stacked = jsharding.spec_tree(j.pspecs, j.params, m)
    if cfg.family == "hybrid":
        blk0 = {k: v for k, v in stacked["blocks"].items()}
        for i in range(len(cfg.pattern)):
            want = jax.tree.map(lambda s: tuple(s)[1:], blk0[f"pos{i}"],
                                is_leaf=_is_spec)
            assert _plain(flat["blocks"][i]) == _plain(want)
    else:
        want = jax.tree.map(lambda s: tuple(s)[1:], stacked["blocks"],
                            is_leaf=_is_spec)
        assert all(_plain(b) == _plain(want) for b in flat["blocks"])


@pytest.mark.parametrize("arch", ARCHS)
def test_moment_specs_equal_jax(arch):
    j = _jax_abstract(arch)
    assert opt.moment_specs(_stacked_specs(base.get_arch(arch))) == \
        jopt.moment_specs(j.pspecs)


def test_logical_to_spec_rules():
    """Size-aware, no mesh axis used twice, ``allowed`` honoured, missing
    axes dropped: the port's ``logical_to_spec`` equals JAX's on
    hand-picked cases."""
    cases = [(("batch", "seq", "embed"), (256, 8, 4)),
             (("batch", "kv_heads", "cache_head_dim"), (64, 4, 128)),
             (("batch", "kv_heads", "cache_head_dim"), (64, 16, 128)),
             (("mlp", "mlp"), (32, 32)), (("expert", None, "mlp"), (8, 4, 4)),
             (("vocab", "embed"), (262144, 1152)), ((), ())]
    for mesh in MESHES:
        m = _stand_in(mesh)
        for logical, shape in cases:
            for allowed in (None, {"data"}, {"model", "pod"}):
                got = sharding.logical_to_spec(logical, m, shape, allowed)
                want = jsharding.logical_to_spec(logical, m, shape, allowed)
                assert got == tuple(want), (logical, shape, allowed)
            assert sharding.logical_to_spec(logical, m) == tuple(
                jsharding.logical_to_spec(logical, m))
    assert sharding.current_rules() is sharding.DEFAULT_RULES
    assert sharding.DEFAULT_RULES == jsharding.DEFAULT_RULES


def test_placements_and_the_production_meshes():
    from torch.distributed.tensor import Replicate, Shard
    for name, multi in (("16x16", False), ("2x16x16", True)):
        m = mesh_mod.make_production_mesh(multi_pod=multi)
        assert (m.axis_names, m.axis_sizes) == MESHES[name]
        assert m.size == np.prod(MESHES[name][1])
    m = mesh_mod.make_production_mesh(multi_pod=True)
    assert sharding.placements((("pod", "data"), None, "model"), m) == \
        [Shard(0), Shard(0), Shard(2)]
    assert sharding.placements((None, None), m) == [Replicate()] * 3
    assert sharding.shard_count((("pod", "data"), None, "model"), m) == 512
    with pytest.raises(ValueError, match="order"):
        sharding.placements((("data", "pod"),), m)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_local_mesh_distributes_a_tensor():
    """``make_local_mesh`` over a one-rank gloo group: a 1x1 DeviceMesh
    that the rules read, and a DTensor laid out by ``placements``."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_local_mesh()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        m = mesh_mod.make_local_mesh(4, 2)
        assert sharding.mesh_axes(m) == {"data": 1, "model": 1}
        x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
        spec = sharding.logical_to_spec(("embed", "heads", "head_dim"), m,
                                        x.shape)
        assert spec == (None, "model", None)
        pl = sharding.placements(spec, m)
        assert pl == [Replicate(), Shard(1)]
        d = distribute_tensor(x, m, pl)
        assert torch.equal(d.full_tensor(), x)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------- the dry run

def _jax_arg_bytes(arch, kind, multi):
    """The arguments' bytes a device holds, from JAX's shapes and specs
    (bf16 params and state, as JAX's dry run takes them)."""
    j = _jax_abstract(arch)
    m = _stand_in("2x16x16" if multi else "16x16")
    sname = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[kind]
    shape = jbase.SHAPES[sname]
    b_specs = {k: ("batch", "seq")
               for k in jspecs_mod.input_specs(j.cfg, shape)}
    if kind == "train":
        tcfg = JT.TrainConfig(compress_grads=multi)
        shapes = j.state if multi else j.state._replace(ef=None)
        trees = [(JT.state_specs(j.pspecs, tcfg), shapes),
                 (b_specs, jspecs_mod.input_specs(j.cfg, shape))]
    elif kind == "prefill":
        trees = [(j.pspecs, j.params),
                 (b_specs, jspecs_mod.input_specs(j.cfg, shape))]
    else:
        trees = [(j.pspecs, j.params), (j.cspecs, j.cache),
                 ({"t": ("batch",), "p": ("batch",)},
                  {"t": jax.ShapeDtypeStruct((128,), jnp.int32),
                   "p": jax.ShapeDtypeStruct((128,), jnp.int32)})]
    sizes = dict(zip(m.axis_names, m.axis_sizes))
    total = 0
    for specs, shapes in trees:
        mesh_specs = jax.tree.leaves(jsharding.spec_tree(specs, shapes, m),
                                     is_leaf=lambda s: isinstance(
                                         s, PartitionSpec))
        for sp, sh in zip(mesh_specs, jax.tree.leaves(shapes)):
            n = int(np.prod([sizes[a] for e in sp if e is not None
                             for a in (e if isinstance(e, tuple) else (e,))]))
            total += sh.size * jnp.dtype(sh.dtype).itemsize // n
    return total


@pytest.mark.parametrize("kind,multi", [("train", True), ("prefill", False),
                                        ("prefill", True), ("decode", False),
                                        ("decode", True)])
def test_dryrun_argument_bytes_equal_jax(kind, multi, tmp_path):
    """gemma3-1b at published width: the dry run's per-device argument
    bytes equal the sum over JAX's shapes and specs; the fields with no
    counterpart are null with a reason; FLOPs split evenly."""
    sname = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[kind]
    rec = dryrun.run_cell("gemma3-1b", sname, multi, str(tmp_path))
    assert rec["ok"], rec.get("error")
    ma = rec["memory_analysis"]
    assert ma["argument_size_in_bytes"] == _jax_arg_bytes("gemma3-1b", kind,
                                                          multi)
    assert ma["temp_size_in_bytes"] is None and ma["why_null"]
    assert rec["hlo_cost"] is None and rec["collectives"] is None
    assert rec["devices"] == (512 if multi else 256)
    assert rec["cost_analysis"]["flops"] == rec["op_cost"]["flops"] / \
        rec["devices"]


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("multi", [False, True])
def test_dryrun_argument_bytes_equal_dtensor_shards(arch, kind, multi):
    """The dry run's per-device argument bytes equal the bytes of the
    local shards DTensor lays out on rank 0 of the production mesh (a
    ``DeviceMesh`` of 256 or 512 ranks over a fake process group, which
    moves no data), each leaf placed by ``sharding.placements``; the
    ``DeviceMesh`` and the stand-in mesh give the same bytes."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    sname = {"train": "train_4k", "prefill": "prefill_32k",
             "decode": "decode_32k"}[kind]
    cell = dryrun.lower_cell(arch, sname, multi)
    stand_in = cell["mesh"]
    sizes = tuple(stand_in.axis_sizes)
    torch.distributed.init_process_group(
        "fake", store=FakeStore(), rank=0, world_size=int(np.prod(sizes)))
    try:
        mesh = init_device_mesh("cpu", sizes,
                                mesh_dim_names=tuple(stand_in.axis_names))

        def local_bytes(spec, t):
            mspec = sharding.logical_to_spec(spec, stand_in, shape=t.shape)
            shape, _ = compute_local_shape_and_global_offset(
                t.shape, mesh, sharding.placements(mspec, mesh))
            return int(np.prod(shape)) * t.element_size()

        with sharding.axis_rules(cell["rules"]):
            want = sum(model.leaves(map_tree(
                local_bytes, cell["specs"], cell["args"], is_leaf=is_spec)))
            got = dryrun.per_device_bytes(cell["specs"], cell["args"],
                                          stand_in)
            on_mesh = dryrun.per_device_bytes(cell["specs"], cell["args"],
                                              mesh)
    finally:
        torch.distributed.destroy_process_group()
    whole = sum(t.numel() * t.element_size()
                for t in model.leaves(cell["args"]))
    assert got == want == on_mesh, (arch, kind, multi)
    assert got < whole


@pytest.mark.parametrize("arch,shape", EP_LOCAL_CELLS)
def test_dryrun_opt_moe_cells_need_ep_local(arch, shape, tmp_path):
    """The opt variant's moe cells run the expert-parallel dispatch under
    the cell's mesh and are ok.  For qwen3-moe's prefill cell, op_cost's
    FLOPs equal the baseline cell's with each layer's global dispatch
    (the router over all tokens, E experts over capacity C) replaced by
    the analytic ep_local work (the router once per (data shard, model
    rank) part, and per data shard E experts over ``cap_l``), within
    1%."""
    rec = dryrun.run_cell(arch, shape, False, str(tmp_path), variant="opt")
    assert rec["ok"], rec.get("error")
    cfg = base.get_arch(arch)
    assert cfg.moe
    if (arch, shape) != ("qwen3-moe-235b-a22b", "prefill_32k"):
        return
    base_rec = dryrun.run_cell(arch, shape, False, str(tmp_path))
    sh = base.SHAPES[shape]
    b, s, d = sh.global_batch, sh.seq_len, cfg.d_model
    e, k, f, cf = cfg.n_experts_padded, cfg.top_k, cfg.d_ff, \
        cfg.capacity_factor
    n_data, ep = MESHES["16x16"][1]
    c = int(cf * b * s * k / e) + 1
    bl = b // n_data
    cap = min(max(int(cf * bl * s * k / e) + 1, 1), bl * s)
    global_moe = 2 * b * s * d * e + 3 * 2 * e * c * d * f
    ep_moe = n_data * ep * 2 * bl * s * d * e \
        + n_data * e * 3 * 2 * cap * d * f
    want = base_rec["op_cost"]["flops"] + cfg.n_layers * (ep_moe - global_moe)
    assert rec["op_cost"]["flops"] == pytest.approx(want, rel=0.01)
    assert rec["op_cost"]["flops"] != base_rec["op_cost"]["flops"]


def test_dryrun_cli_writes_every_cell(tmp_path, capsys):
    """``main`` writes one record a cell under JAX's file names; the opt
    variant of a mixed-window arch runs banded and is ok, and so is a moe
    arch's, on the expert-parallel dispatch; the moe archs are the only
    ones with ep_local cells."""
    assert dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "gemma3-1b", "--shape", "prefill_32k",
                        "--mesh", "single", "--variant", "opt",
                        "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "granite-moe-3b-a800m", "--shape",
                        "decode_32k", "--mesh", "multi", "--variant", "opt",
                        "--out", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "gemma3-1b_decode_32k_multi.json", "gemma3-1b_decode_32k_single.json",
        "gemma3-1b_prefill_32k_single.opt.json",
        "granite-moe-3b-a800m_decode_32k_multi.opt.json"]
    assert capsys.readouterr().out.count("1/1 cells passed") == 2
    assert {a for a, _ in EP_LOCAL_CELLS} == {
        a for a in ARCHS if base.get_arch(a).moe}


# ------------------------------------------------------ serving launcher

SERVE_ARGV = ["--requests", "3", "--prompt-len", "20", "--max-new", "4",
              "--fast-pages", "6", "--max-seqs", "2", "--seed", "3"]


def test_serve_launcher_matches_jax(monkeypatch, capsys):
    """``launch.serve.main`` on the CPU, the JAX launcher's parameters
    carried across: the same tokens for every request, the same engine
    stats and counters, and the same lines printed but the timing."""
    seen = {"jax": [], "port": []}

    def recording(cls, key):
        def make(**kw):
            seen[key].append(cls(**kw))
            return seen[key][-1]
        return make

    monkeypatch.setattr(jlaunch_serve, "Request",
                        recording(jlaunch_serve.Request, "jax"))
    monkeypatch.setattr(launch_serve, "Request",
                        recording(launch_serve.Request, "port"))
    jeng = jlaunch_serve.main(SERVE_ARGV)
    jout = capsys.readouterr().out.splitlines()
    jcfg = jbase.reduced(jbase.get_arch("phi4-mini-3.8b"))
    jp, _ = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jp)
    monkeypatch.setattr(model, "init_params",
                        lambda cfg, gen, dtype=None, device=None:
                        model.params_from_numpy(cfg, tree, device))
    eng = launch_serve.main(SERVE_ARGV + ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [r.out for r in seen["port"]] == [r.out for r in seen["jax"]]
    assert all(len(r.out) == 4 for r in seen["port"])
    assert eng.counters == jeng.counters
    assert eng.stats == jeng.stats
    assert eng.counters["compactions"] > 0 and eng.counters["hits_slow"] > 0
    assert out[1:] == jout[1:]
    assert out[0].split(" (")[0] == jout[0].split(" (")[0]


def test_serve_launcher_defaults_to_the_card():
    """With no ``--device`` the launcher asks for the card, and raises
    without one: it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--requests", "1"])
