"""The port's expert-parallel MoE dispatch (``models/moe.moe_ffn_ep_local``)
against the JAX package's on the CPU.

JAX's ``moe_ffn_ep_local`` runs in this process under a (1, 1)
``jax.set_mesh`` of ("data", "model"); the port's under the stand-in
``MeshShape`` of the same axes.  Held: outputs within ``MOE_TOL`` (the
tolerance of tests/test_torch_models.py's MoE tests), ``aux_loss`` atol
1e-6, each token's top-k experts equal, and the kept (token, expert)
pairs that ``moe.ep_local_kept`` derives from the port's experts equal
to JAX's own selection (its per-expert ``lax.top_k`` of position
scores, recomputed here with JAX's ops).  ``dropped`` is 0 in
both packages at a capacity where the global dispatch drops (reference
fault F8).  The data axis stays 1 here: at data > 1 JAX's ``aux_loss``
is the first data shard's (PERF.md), which the stand-in case pins on the
port alone; on a ``DeviceMesh`` of 2 gloo data ranks each rank holds its
own shard's.  The port's rank parts (a stand-in of 2 and 4 model ranks, 2
gloo ranks) are held to the one-rank result, and its meta-device count
(one part counted once per part) to the count of every part run.

The gloo ranks import only ``repro_torch``: JAX is imported inside the
``jx`` fixture, never at module level.
"""
from __future__ import annotations

import pickle
import types

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import moe
from repro_torch.roofline.op_cost import OpCost
from torch_parity import jax_modules, spawn_gloo, t

QWEN3, GRANITE = "qwen3-moe-235b-a22b", "granite-moe-3b-a800m"
MOE_TOL = 1e-5          # tests/test_torch_models.py
# (arch, config changes): qwen3-moe reduced (8 experts, top 2), at top 8
# with 16 experts (D4: a token's 8 outputs added in another order), and
# granite (40 experts padded to 48, reduced to 8)
CASES = {"qwen3": (QWEN3, {}),
         "qwen3_top8": (QWEN3, dict(n_experts=16, n_experts_padded=16,
                                    top_k=8)),
         "granite": (GRANITE, {})}
ONE = MeshShape(("data", "model"), (1, 1))


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules (imported here, not at module level)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_arch as jga, reduced as jred
    from repro.models import moe as jmoe
    jax.config.update("jax_platform_name", "cpu")
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_arch=jga,
                                 reduced=jred, moe=jmoe)


def _cfg(case, cf):
    name, kw = CASES[case]
    return reduced(get_arch(name)).replace(capacity_factor=cf, **kw)


def _tree(case, cf, seed=3):
    """The port's config and a MoE layer's parameters (numpy, from a
    generator seeded by the case)."""
    cfg = _cfg(case, cf)
    e = cfg.n_experts_padded
    rng = np.random.default_rng([seed, e, cfg.top_k])
    g = lambda *shape, s=1.0: (s * rng.normal(size=shape)).astype(
        np.float32)
    d, f = cfg.d_model, cfg.d_ff
    return cfg, {"router": g(d, e, s=0.3), "w_gate": g(e, d, f, s=0.1),
                 "w_up": g(e, d, f, s=0.1), "w_down": g(e, f, d, s=0.1)}


def _x(cfg, b=2, s=16, seed=15):
    return np.random.default_rng([seed, b, s]).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def _port(cfg, tree, x, mesh):
    with torch.no_grad(), sharding.use_mesh(mesh):
        return moe.moe_ffn_ep_local({k: t(v) for k, v in tree.items()}, cfg,
                                    t(x))


def _jax_ep(jx, case, cf, tree, x):
    """JAX's ``moe_ffn_ep_local`` under a (1, 1) mesh, and its kept
    (token, choice) pairs: per expert, ``lax.top_k`` of the position
    scores of ``local`` (its ops, recomputed), the selected tokens among
    the first ``cap_l``."""
    jax, jnp = jx.jax, jx.jnp
    name, kw = CASES[case]
    jcfg = jx.reduced(jx.get_arch(name)).replace(capacity_factor=cf, **kw)
    p = jax.tree.map(jnp.asarray, tree)
    with jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"))):
        out, ex = jax.jit(lambda p, a: jx.moe.moe_ffn_ep_local(p, jcfg, a))(
            p, jnp.asarray(x))
    b, s, d = x.shape
    e, k, n = jcfg.n_experts_padded, jcfg.top_k, b * s
    logits = (jnp.asarray(x).reshape(n, d) @ p["router"]).astype(
        jnp.float32)
    logits = jnp.where(jnp.arange(e)[None] >= jcfg.n_experts, -1e30,
                       logits)
    top_p, top_e = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    top_p = top_p / jnp.sum(top_p, -1, keepdims=True)
    cap = min(max(int(jcfg.capacity_factor * n * k / e) + 1, 1), n)
    kept = np.zeros((n, k), bool)
    for g in range(e):
        hit = top_e == g
        sel = jnp.sum(jnp.where(hit, top_p, 0.0), -1) > 0
        score = jnp.where(sel, -jnp.arange(n, dtype=jnp.float32),
                          -1e30 - jnp.arange(n, dtype=jnp.float32))
        _, idx = jax.lax.top_k(score, cap)
        mark = np.zeros(n, bool)
        mark[np.asarray(idx)] = np.asarray(sel[idx])
        kept |= np.asarray(hit) & mark[:, None]
    return {"out": np.asarray(out), "aux": float(ex["aux_loss"]),
            "dropped": float(ex["dropped"]),
            "experts": np.asarray(top_e).reshape(b, s, k),
            "kept": kept.reshape(b, s, k)}


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("case", list(CASES))
def test_ep_local_matches_jax(jx, case, cf):
    """Under a (1, 1) mesh: outputs within ``MOE_TOL``, ``aux_loss``
    within 1e-6, equal experts and kept pairs, and ``dropped`` 0 in both
    packages though the capacity drops choices (F8; at capacity factor
    0.25 always): the port's global dispatch, held to JAX's by
    tests/test_torch_models.py, keeps the same pairs and counts the
    rest."""
    cfg, tree = _tree(case, cf)
    x = _x(cfg)
    want = _jax_ep(jx, case, cf, tree, x)
    got, gx = _port(cfg, tree, x, ONE)
    np.testing.assert_allclose(got.numpy(), want["out"], atol=MOE_TOL,
                               rtol=MOE_TOL)
    np.testing.assert_allclose(float(gx["aux_loss"]), want["aux"],
                               atol=1e-6, rtol=0)
    assert np.array_equal(gx["experts"].numpy(), want["experts"])
    assert np.array_equal(moe.ep_local_kept(cfg, gx["experts"]).numpy(),
                          want["kept"])
    assert float(gx["dropped"]) == want["dropped"] == 0.0
    _, glob = moe.moe_ffn_global({k: t(v) for k, v in tree.items()}, cfg,
                                 t(x))
    assert np.array_equal(glob["kept"].numpy(), want["kept"])
    lost = want["kept"].size - int(want["kept"].sum())
    assert float(glob["dropped"]) == lost
    if cf < 1:
        assert lost > 0


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_ep_local_ranks_in_turn_equal_one_rank(case, shape):
    """On a stand-in mesh every (data shard, model rank) part runs in
    turn: with data 1 the output equals the one-rank result within
    ``MOE_TOL`` with the same kept pairs and aux; with data 2 each half
    of the batch equals its own one-rank run, and ``aux_loss`` is the
    first shard's (JAX's unchecked replicated output, PERF.md)."""
    cfg, tree = _tree(case, 0.5)
    x = _x(cfg, b=4)
    got, gx = _port(cfg, tree, x, MeshShape(("data", "model"), shape))
    halves = [_port(cfg, tree, x[i:i + 2], ONE) for i in (0, 2)] \
        if shape[0] == 2 else [_port(cfg, tree, x, ONE)]
    want = torch.cat([h[0] for h in halves])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=MOE_TOL,
                               rtol=MOE_TOL)
    assert torch.equal(gx["experts"],
                       torch.cat([h[1]["experts"] for h in halves]))
    assert torch.equal(
        moe.ep_local_kept(cfg, gx["experts"], shape[0]),
        torch.cat([moe.ep_local_kept(cfg, h[1]["experts"]) for h in halves]))
    assert float(gx["aux_loss"]) == pytest.approx(
        float(halves[0][1]["aux_loss"]), abs=1e-6)
    assert float(gx["dropped"]) == 0.0


@pytest.mark.parametrize("mesh", [None, MeshShape(("pod",), (2,))])
def test_ep_local_without_a_model_axis_is_rowwise(mesh):
    """No ambient mesh, or one without "model": the rowwise dispatch, as
    in the JAX package."""
    cfg, tree = _tree("qwen3", 1.25)
    x = t(_x(cfg))
    p = {k: t(v) for k, v in tree.items()}
    with sharding.use_mesh(mesh):
        got, gx = moe.moe_ffn_ep_local(p, cfg, x)
    want, wx = moe.moe_ffn_rowwise(p, cfg, x)
    assert torch.equal(got, want)
    assert float(gx["dropped"]) == float(wx["dropped"])


def _flops(cfg, tree, x, shape, backward: bool) -> int:
    """op_cost's FLOPs of ``moe_ffn_ep_local`` (and its backward) under a
    stand-in mesh of ``shape``."""
    p = {k: v.clone().requires_grad_(backward) for k, v in tree.items()}
    with sharding.use_mesh(MeshShape(("data", "model"), shape)), \
            OpCost() as mode:
        out, ex = moe.moe_ffn_ep_local(p, cfg, x)
        if backward:
            (out.sum() + ex["aux_loss"]).backward()
    return mode.flops


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_ep_local_meta_counts_every_part(shape, backward):
    """On meta tensors one (shard, rank) part runs and is counted once
    per part, forward and backward: op_cost's FLOPs equal those of every
    part run on the CPU, and the analytic count -- the router once per
    part and, per data shard, E experts over ``cap_l`` tokens."""
    cfg, tree = _tree("qwen3_top8", 1.25)
    x = _x(cfg, b=4)
    cpu = _flops(cfg, {k: t(v) for k, v in tree.items()}, t(x), shape,
                 backward)
    meta = _flops(cfg, {k: t(v).to("meta") for k, v in tree.items()},
                  t(x).to("meta"), shape, backward)
    assert meta == cpu
    if not backward:
        b, s, d = x.shape
        e, k, f = cfg.n_experts_padded, cfg.top_k, cfg.d_ff
        n_data, ep = shape
        bl = b // n_data
        cap = min(max(int(cfg.capacity_factor * bl * s * k / e) + 1, 1),
                  bl * s)
        assert cpu == n_data * ep * 2 * bl * s * d * e \
            + n_data * e * 3 * 2 * cap * d * f


def _ep_rank(rank: int, world: int, src: str, out: str) -> None:
    """One rank of the gloo run: ``moe_ffn_ep_local`` on a ("data",
    "model") ``DeviceMesh`` of the pickled shape, each rank handed its
    data shard of the batch, the result to ``out.<rank>``."""
    from torch.distributed.device_mesh import init_device_mesh
    with open(src, "rb") as fh:
        case, cf, tree, x, shape = pickle.load(fh)
    cfg = _cfg(case, cf)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    bl = x.shape[0] // shape[0]
    i = mesh.get_local_rank("data")
    got, gx = _port(cfg, tree, x[i * bl:(i + 1) * bl], mesh)
    with open(f"{out}.{rank}", "wb") as fh:
        pickle.dump({"out": got.numpy(), "aux": float(gx["aux_loss"]),
                     "experts": gx["experts"].numpy(),
                     "dropped": float(gx["dropped"]),
                     "jax": jax_modules()}, fh)


def _gloo(case, x, shape, tmp_path) -> list:
    """``_ep_rank`` on every rank of a gloo mesh of ``shape`` at capacity
    factor 0.5; each rank's result."""
    _, tree = _tree(case, 0.5)
    src = tmp_path / "inputs.pkl"
    with open(src, "wb") as fh:
        pickle.dump((case, 0.5, tree, x, shape), fh)
    out = str(tmp_path / "rank")
    spawn_gloo(_ep_rank, shape[0] * shape[1], str(src), out)
    got = []
    for r in range(shape[0] * shape[1]):
        with open(f"{out}.{r}", "rb") as fh:
            got.append(pickle.load(fh))
    assert all(g["jax"] == [] for g in got)
    return got


@pytest.mark.parametrize("case", ["qwen3", "qwen3_top8"])
def test_ep_local_gloo_two_model_ranks(case, tmp_path):
    """ep = 2 over two gloo ranks (4 or 8 experts each, the partial
    outputs summed by ``all_reduce`` over the "model" group, the kept
    pairs gathered): every rank holds the one-rank result within
    ``MOE_TOL``, its experts (so its kept pairs) and its aux."""
    cfg, tree = _tree(case, 0.5)
    x = _x(cfg)
    want, wx = _port(cfg, tree, x, ONE)
    for got in _gloo(case, x, (1, 2), tmp_path):
        np.testing.assert_allclose(got["out"], want.numpy(), atol=MOE_TOL,
                                   rtol=MOE_TOL)
        assert np.array_equal(got["experts"], wx["experts"].numpy())
        assert got["aux"] == pytest.approx(float(wx["aux_loss"]), abs=1e-6)
        assert got["dropped"] == 0.0


def test_ep_local_gloo_two_data_ranks_hold_their_own_aux(tmp_path):
    """data = 2 over two gloo ranks (one model rank each): each rank
    holds its own batch shard's one-rank result and ``aux_loss``, so the
    two ranks' aux differ, where the stand-in returns shard 0's on both
    (the value JAX's unchecked replicated output reads, PERF.md)."""
    cfg, tree = _tree("qwen3", 0.5)
    x = _x(cfg, b=4)
    got = _gloo("qwen3", x, (2, 1), tmp_path)
    for r, g in enumerate(got):
        want, wx = _port(cfg, tree, x[2 * r:2 * r + 2], ONE)
        np.testing.assert_allclose(g["out"], want.numpy(), atol=MOE_TOL,
                                   rtol=MOE_TOL)
        assert np.array_equal(g["experts"], wx["experts"].numpy())
        assert g["aux"] == pytest.approx(float(wx["aux_loss"]), abs=1e-6)
    assert got[0]["aux"] != got[1]["aux"]
