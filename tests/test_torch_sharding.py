"""The port's ambient mesh and sharding trees (``distributed/sharding``:
``use_mesh``, ``constrain``, ``named_sharding_tree``,
``leading_axis_sharding``) against the JAX package's on the CPU.

JAX's trees are taken on an ``AbstractMesh`` with the axes of the
port's stand-in (``launch/mesh.MeshShape``), and each JAX spec is held to
the port's DTensor placements through ``sharding.placements``.  Two gloo
ranks check what the placements do: ``constrain`` gives a DTensor the
spec's placements and leaves its values whole, and a stacked
``PartitionedDB`` state laid out by ``leading_axis_sharding`` gives each
rank the partitions that ``PartitionedDB(group=...)`` holds after the
same drive.

The gloo ranks import only ``repro_torch``: JAX is imported inside the
``jx`` fixture, never at module level.
"""
from __future__ import annotations

import pickle
import types

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import get_arch
from repro_torch.core import engine
from repro_torch.core.db import PartitionedDB, stack_trees
from repro_torch.core.tiers import TierConfig
from repro_torch.core.tree import map_tree
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model
from torch_parity import assert_trees_equal, jax_modules, spawn_gloo

# the CFG of tests/test_partitioned_mesh.py
CFG_KW = dict(key_space=1 << 12, fast_slots=256, slow_slots=1 << 12,
              value_width=1, max_runs=32, run_size=128,
              bloom_bits_per_run=1 << 11, tracker_slots=512,
              n_buckets=16, pin_threshold=0.1)
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
ACT = ("batch", "seq", "embed")


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (imported here, not at module level)."""
    import jax
    import jax.numpy as jnp
    from repro.distributed import sharding as jsharding
    jax.config.update("jax_platform_name", "cpu")
    return types.SimpleNamespace(jax=jax, jnp=jnp, sharding=jsharding)


def _abstract(jx, names, sizes):
    return jx.jax.sharding.AbstractMesh(tuple(sizes), tuple(names))


def _placed(jspec, mesh) -> list:
    """A JAX PartitionSpec as the port's placements on ``mesh``."""
    return sharding.placements(tuple(jspec), mesh)


def _is_placements(x) -> bool:
    return isinstance(x, list) and bool(x) and all(
        isinstance(q, (Shard, Replicate)) for q in x)


def _each_pair(got, want, check) -> int:
    """``check(port placements, JAX sharding)`` for every leaf of the
    port's tree and the matching leaf of JAX's; returns the count."""
    seen = []
    map_tree(lambda g, w: seen.append(check(g, w)), got, want,
             is_leaf=_is_placements)
    return len(seen)


def test_constrain_without_a_device_mesh_is_identity(jx):
    """No ambient mesh, a stand-in mesh, or a plain tensor: ``x`` itself,
    as JAX's ``constrain`` returns its input without a mesh."""
    x = torch.ones(4, 3, 8)
    assert sharding.current_mesh() is None
    assert sharding.constrain(x, ACT) is x
    stand_in = MeshShape(("data", "model"), (2, 1))
    with sharding.use_mesh(stand_in) as m:
        assert m is stand_in and sharding.current_mesh() is stand_in
        assert sharding.constrain(x, ACT) is x
        with sharding.use_mesh(None):
            assert sharding.current_mesh() is None
        assert sharding.current_mesh() is stand_in
    assert sharding.current_mesh() is None
    jxv = jx.jnp.ones((4, 3, 8))
    assert jx.sharding.constrain(jxv, ACT) is jxv


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-moe-235b-a22b"])
def test_named_sharding_tree_matches_jax(jx, arch, mesh):
    """Every parameter's placements on the production mesh equal JAX's
    ``NamedSharding`` spec for the same logical spec and shape."""
    cfg = get_arch(arch)
    specs = model.param_specs(cfg)
    shapes = model.init_params(cfg, None, torch.bfloat16, "meta")
    names, sizes = MESHES[mesh]
    stand_in = MeshShape(names, sizes)
    got = sharding.named_sharding_tree(specs, shapes, stand_in)
    want = jx.sharding.named_sharding_tree(specs, shapes,
                                           _abstract(jx, names, sizes))
    sharded = []

    def check(g, w):
        assert g == _placed(w.spec, stand_in)
        sharded.append(any(isinstance(q, Shard) for q in g))

    assert _each_pair(got, want, check) > 0 and any(sharded)


@pytest.mark.parametrize("p,shards", [(4, True), (3, False), (6, True)])
def test_leading_axis_sharding_matches_jax(jx, p, shards):
    """A stacked per-partition state over a "part" axis of 2: each
    leaf's leading axis sharded when 2 divides P, every leaf replicated
    when it does not (P = 3), as JAX's specs say."""
    one = PartitionedDB(TierConfig(**CFG_KW), p, seed=0, device="cpu")
    tree = one.stacked()
    stand_in = MeshShape(("part",), (2,))
    got = sharding.leading_axis_sharding(tree, stand_in)
    want = jx.sharding.leading_axis_sharding(
        jx.jax.tree.map(np.asarray, engine.state_to_numpy(tree)),
        _abstract(jx, ("part",), (2,)))

    def check(g, w):
        assert g == _placed(w.spec, stand_in)
        assert g == ([Shard(0)] if shards else [Replicate()])

    assert _each_pair(got, want, check) > 0


def _drive(db) -> None:
    """Routed puts past the fast tier (every partition compacts), then a
    routed get."""
    rng = np.random.default_rng(8)
    for _ in range(8):
        db.put(torch.from_numpy(rng.integers(
            0, CFG_KW["key_space"], 512).astype(np.int32)))
    db.get(torch.from_numpy(rng.integers(
        0, CFG_KW["key_space"], 512).astype(np.int32)))


def _sharding_rank(rank: int, world: int, out: str) -> None:
    """One rank of the gloo run: ``constrain`` on a ("data",) mesh, then a
    stacked PartitionedDB state distributed by ``leading_axis_sharding``
    on a ("part",) mesh, held against the group's own partitions."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    res = {}
    data = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    full = torch.arange(4 * 3 * 8, dtype=torch.float32).reshape(4, 3, 8)
    odd = torch.arange(3 * 3 * 8, dtype=torch.float32).reshape(3, 3, 8)
    with sharding.use_mesh(data):
        x = distribute_tensor(full, data, [Replicate()])
        y = sharding.constrain(x, ACT)
        z = sharding.constrain(distribute_tensor(odd, data, [Replicate()]),
                               ACT)
        res["constrain"] = (list(y.placements), bool(torch.equal(
            y.full_tensor(), full)), list(y.to_local().shape),
            list(z.placements), sharding.constrain(full, ACT) is full)
    part = init_device_mesh("cpu", (world,), mesh_dim_names=("part",))
    cfg = TierConfig(**CFG_KW)
    for p in (2 * world, 3):
        one = PartitionedDB(cfg, p, seed=0, device="cpu")
        _drive(one)
        tree = one.stacked()
        pl = sharding.leading_axis_sharding(tree, part)
        local = map_tree(lambda t, q: distribute_tensor(t, part, q)
                         .to_local(), tree, pl)
        if p % world == 0:
            grp = PartitionedDB(cfg, p, seed=0, device="cpu",
                                group=torch.distributed.group.WORLD)
            _drive(grp)
            want = stack_trees(grp.estates)
        else:
            want = tree
        kinds = set()
        map_tree(lambda q: kinds.update(map(repr, q)), pl,
                 is_leaf=_is_placements)
        res[p] = (engine.state_to_numpy(local), engine.state_to_numpy(want),
                  sorted(kinds))
    res["jax"] = jax_modules()
    with open(f"{out}.{rank}", "wb") as fh:
        pickle.dump(res, fh)


def test_sharding_gloo_two_ranks(jx, tmp_path):
    """Two gloo ranks.  ``constrain`` redistributes a replicated DTensor
    to the placements of JAX's spec for its shape (batch on "data"), its
    full tensor unchanged; a batch of 3 stays replicated (size-aware); a
    plain tensor passes.  A stacked P = 4 state laid out by
    ``leading_axis_sharding`` gives each rank exactly the stacked
    partitions of ``PartitionedDB(group=...)`` after the same drive, bit
    for bit; at P = 3 every leaf stays replicated, each rank holding the
    whole state."""
    names = ("data",)
    spec = jx.sharding.logical_to_spec(ACT, _abstract(jx, names, (2,)),
                                       shape=(4, 3, 8))
    want_act = _placed(spec, MeshShape(names, (2,)))
    out = str(tmp_path / "rank")
    spawn_gloo(_sharding_rank, 2, out)
    for r in range(2):
        with open(f"{out}.{r}", "rb") as fh:
            got = pickle.load(fh)
        assert got["jax"] == []
        placed, whole, shape, odd, plain = got["constrain"]
        assert placed == want_act == [Shard(0)]
        assert whole and shape == [2, 3, 8] and plain
        assert odd == [Replicate()]
        local, want, kinds = got[4]
        assert_trees_equal(want, local)
        assert kinds == ["Shard(dim=0)"]
        local, want, kinds = got[3]
        assert_trees_equal(want, local)
        assert kinds == ["Replicate()"]


def _vocab_rank(rank: int, world: int, out: str) -> None:
    """One rank of the gloo run of the vocabulary-sharded loss pieces:
    logits [2, 3, 8] float32 sharded on their vocabulary over a
    ("model",) mesh; ``vocab_logsumexp``, ``vocab_gather`` and the
    gradient of their difference, each gathered whole."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    g = torch.Generator().manual_seed(26)
    full = torch.randn(2, 3, 8, generator=g) * 4
    idx = torch.randint(0, 8, (2, 3, 1), generator=g)
    x = distribute_tensor(full, mesh, [Shard(2)]).requires_grad_()
    lse = sharding.vocab_logsumexp(x)
    gold = sharding.vocab_gather(x, distribute_tensor(idx, mesh,
                                                      [Replicate()]))
    (lse[..., None] - gold).sum().backward()
    res = {"placements": (list(lse.placements), list(gold.placements),
                          list(x.grad.placements)),
           "values": [t.full_tensor().detach() for t in (lse, gold, x.grad)],
           "inputs": (full, idx), "jax": jax_modules()}
    with open(f"{out}.{rank}", "wb") as fh:
        pickle.dump(res, fh)


def test_vocab_logsumexp_and_gather_gloo_two_ranks(tmp_path):
    """Two gloo ranks, the logits' vocabulary split between them: the
    sharded ``logsumexp`` (one max and one sum all-reduced) and gather
    (each rank's own columns, summed) give the plain ones' values and
    gradient (softmax less the gold one-hot) within float32 rounding
    (rtol 1e-6, atol 1e-6); the gradient stays on the vocabulary's
    shards."""
    out = str(tmp_path / "rank")
    spawn_gloo(_vocab_rank, 2, out)
    for r in range(2):
        with open(f"{out}.{r}", "rb") as fh:
            got = pickle.load(fh)
        assert got["jax"] == []
        assert got["placements"] == ([Replicate()], [Replicate()],
                                     [Shard(2)])
        full, idx = got["inputs"]
        x = full.clone().requires_grad_()
        lse = torch.logsumexp(x, -1)
        gold = torch.gather(x, -1, idx)
        (lse[..., None] - gold).sum().backward()
        for g, w in zip(got["values"], (lse, gold, x.grad)):
            torch.testing.assert_close(g, w.detach(), rtol=1e-6, atol=1e-6)
