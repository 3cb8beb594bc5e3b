"""Training in the port (``train/data.py``, ``optimizer.py``,
``trainer.py``, ``checkpoint.py``, ``launch/train.py``, the int8
error-feedback compression of ``distributed/collectives.py`` and the
gradients of ``models/model.py``) against the JAX package on the CPU, at
reduced sizes (``reduced(get_arch("stablelm-12b"))``, 4 x 32 tokens, as
tests/test_train_infra.py).

Parameters come from the port's ``init_params`` (which draws the JAX
package's shapes and scales) and go to JAX stacked as its layers are
(``_jax_params``); the JAX side runs on backend "reference", jitted once
per case.  Tolerances, float32: data and compression bit-equal; the loss
within rtol 1e-5 and every gradient leaf within GRAD_TOL relative L2 of
``jax.value_and_grad(loss_fn)`` (measured at these seeds: 4.9e-6 at
worst, rwkv6; the loss 1.4e-7); the schedule, the global norm and one AdamW update within rtol
1e-6 (float32 ``pow`` and ``cos`` are not bit-equal across XLA and
torch, ROADMAP D3); trajectories as ``TRAJ_*`` state.

JAX is imported inside the ``jx`` fixture, never at module level: the
gloo ranks import this module to find their entry point, and the card
tests (marker ``cuda``) run where no JAX is, with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_train.py``.
"""
from __future__ import annotations

import datetime
import importlib.util
import os
import pickle
import shutil
import socket
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.tree import leaves, map_tree
from repro_torch.distributed import collectives
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import trainer as T
from torch_parity import assert_bit_equal

ARCH = "stablelm-12b"
MCFG = reduced(get_arch(ARCH))
DCFG = data_mod.DataConfig(seed=0, batch=4, seq_len=32, vocab=MCFG.vocab)
FAMILIES = {"dense": "stablelm-12b", "moe": "granite-moe-3b-a800m",
            "ssm": "rwkv6-7b", "hybrid": "jamba-v0.1-52b",
            "vlm": "qwen2-vl-2b", "audio": "whisper-small"}
GRAD_TOL = 5e-5
# A trajectory of AdamW steps from one state (lr 1e-3), port against JAX:
# the losses within TRAJ_LOSS_RTOL, the moments within MOMENT_TOL relative
# L2 per leaf (measured after 8 steps: 1.7e-6), every parameter within
# TRAJ_PARAM_ATOL and all but a TRAJ_PARTED share of them within 1e-6.
# AdamW's first steps move a parameter by about lr * sign(g), so where a
# gradient element sits near eps a float32 difference of g moves it by a
# part of lr (measured after 8 steps: 10 of 139,904 elements beyond 1e-6,
# the largest 4.4e-5, an embedding row of a rare token).
TRAJ_LOSS_RTOL, MOMENT_TOL = 1e-5, 1e-5
TRAJ_PARAM_ATOL, TRAJ_PARTED = 1e-4, 1e-3
SPAWN_TIMEOUT_S = 120
ROOT = Path(__file__).resolve().parent.parent


def tcfg_for(steps: int, **kw) -> T.TrainConfig:
    return T.TrainConfig(adamw=opt_mod.AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=steps), **kw)


def _params(cfg, seed: int = 1) -> dict:
    return M.init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")


def _jax_params(cfg, params) -> dict:
    """The port's parameters in the JAX package's layout (numpy):
    ``blocks`` stacked [L, ...] (the hybrid family's ``pos{i}`` stacked
    [L / period, ...]), ``enc_blocks`` stacked [L_enc, ...]."""
    np_ = lambda t: t.detach().numpy().copy()
    stack = lambda blocks: map_tree(
        lambda *xs: np.stack([np_(x) for x in xs]), *blocks)
    out = {k: map_tree(np_, v) for k, v in params.items()
           if k not in ("blocks", "enc_blocks")}
    if cfg.family == "hybrid":
        period = len(cfg.pattern)
        out["blocks"] = {f"pos{i}": stack(params["blocks"][i::period])
                         for i in range(period)}
    else:
        out["blocks"] = stack(params["blocks"])
    if "enc_blocks" in params:
        out["enc_blocks"] = stack(params["enc_blocks"])
    return out


def _flat(tree, path: str = "") -> dict:
    """{path: numpy array} of every leaf of a dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}/{i}").items()}
    if tree is None:
        return {}
    return {path: tree.detach().cpu().numpy() if torch.is_tensor(tree)
            else np.asarray(tree)}


def _port_tree(cfg, jax_tree) -> dict:
    """A JAX parameter-shaped tree in the port's layout, on the CPU."""
    return M.params_from_numpy(cfg, jax_tree, device="cpu")


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _assert_close_trees(got, want, *, rtol=0.0, atol=0.0, msg=""):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), msg
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                   err_msg=f"{msg}{k}")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for this module: its tensors are small, and the
    test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's training modules (imported here, not at module
    level)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_arch as j_get_arch
    from repro.configs.base import reduced as j_reduced
    from repro.distributed import collectives as jcoll
    from repro.models import model as JM
    from repro.train import data as jdata
    from repro.train import optimizer as jopt
    from repro.train import trainer as JT
    jax.config.update("jax_platform_name", "cpu")
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, cfg=lambda name: j_reduced(j_get_arch(name)),
        coll=jcoll, M=JM, data=jdata, opt=jopt, T=JT)


def _jax_tcfg(jx, steps: int, **kw):
    """``tcfg_for`` in the JAX package's own config classes."""
    return jx.T.TrainConfig(adamw=jx.opt.AdamWConfig(
        **tcfg_for(steps).adamw._asdict()), **kw)


def _jax_state(jx, params, compress: bool = False):
    jp = jx.jax.tree.map(jx.jnp.asarray, _jax_params(MCFG, params))
    ef = jx.coll.init_error_feedback(jp) if compress else None
    return jx.T.TrainState(jp, jx.opt.init(jp), ef)


def _to_numpy(jx, tree):
    return jx.jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_runs(jx):
    """The JAX side of the trajectory tests, run once: from one initial
    state (the port's ``init_params(seed 1)`` in JAX's layout), 8 steps
    (TrainConfig lr 1e-3, warmup 2, total 8) with their losses and the
    states after steps 4 and 8; one step at micro_batches=2; two steps
    with compress_grads=True.  Each state in numpy."""
    params = _params(MCFG)
    jd = jx.data.DataConfig(seed=0, batch=4, seq_len=32, vocab=MCFG.vocab)
    jcfg = jx.cfg(ARCH)
    batch = lambda s: jx.data.model_batch(jd, jcfg, s)
    out = {"init": _to_numpy(jx, _jax_state(jx, params)),
           "init_compressed": _to_numpy(jx, _jax_state(jx, params, True))}
    step = jx.jax.jit(jx.T.make_train_step(jcfg, _jax_tcfg(jx, 8)))
    state, losses = _jax_state(jx, params), []
    for s in range(8):
        state, m = step(state, batch(s))
        losses.append(float(m["loss"]))
        if s == 3:
            out["state4"] = _to_numpy(jx, state)
    out["losses"], out["state8"] = losses, _to_numpy(jx, state)
    mb2 = jx.jax.jit(jx.T.make_train_step(
        jcfg, _jax_tcfg(jx, 8, micro_batches=2)))
    state, m = mb2(_jax_state(jx, params), batch(0))
    out["mb2"] = (float(m["loss"]), _to_numpy(jx, state))
    comp = jx.jax.jit(jx.T.make_train_step(
        jcfg, _jax_tcfg(jx, 8, compress_grads=True)))
    state, out["compressed"] = _jax_state(jx, params, compress=True), []
    for s in range(2):
        state, m = comp(state, batch(s))
        out["compressed"].append((float(m["loss"]), _to_numpy(jx, state)))
    return out


def _assert_state_close(got: T.TrainState, want) -> None:
    """A port state against a JAX state in numpy (both layouts through
    ``params_from_numpy``), at the trajectory tolerances."""
    g, w = _flat(got.params), _flat(_port_tree(MCFG, want.params))
    assert sorted(g) == sorted(w)
    diff = np.concatenate([np.abs(g[k] - w[k]).ravel() for k in w])
    assert diff.max() <= TRAJ_PARAM_ATOL, diff.max()
    assert (diff > 1e-6).mean() <= TRAJ_PARTED, (diff > 1e-6).sum()
    for name in ("m", "v"):
        g = _flat(getattr(got.opt, name))
        w = _flat(_port_tree(MCFG, getattr(want.opt, name)))
        for k in w:
            assert _rel_l2(g[k], w[k]) <= MOMENT_TOL, (name, k)
    assert int(got.opt.step) == int(want.opt.step)


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("step,host,n_hosts", [
    (0, 0, 1), (7, 0, 1), (3, 0, 2), (3, 1, 2), (11, 3, 4)])
def test_batch_at_matches_jax(jx, step, host, n_hosts):
    jd = jx.data.DataConfig(seed=5, batch=4, seq_len=32, vocab=MCFG.vocab)
    td = data_mod.DataConfig(seed=5, batch=4, seq_len=32, vocab=MCFG.vocab)
    want = jx.data.batch_at(jd, step, host, n_hosts)
    got = data_mod.batch_at(td, step, host, n_hosts, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert_bit_equal(np.asarray(want[k]), got[k].numpy(), k)


@pytest.mark.parametrize("family", ["dense", "vlm", "audio"])
def test_model_batch_matches_jax(jx, family):
    """Tokens, labels, ``embeds``, ``enc_embeds`` and M-RoPE
    ``positions`` bit-equal to the JAX package's."""
    name = FAMILIES[family]
    jd = jx.data.DataConfig(seed=2, batch=4, seq_len=32, vocab=MCFG.vocab)
    td = data_mod.DataConfig(seed=2, batch=4, seq_len=32, vocab=MCFG.vocab)
    for step in (0, 9):
        want = jx.data.model_batch(jd, jx.cfg(name), step)
        got = data_mod.model_batch(td, reduced(get_arch(name)), step,
                                   device="cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            assert_bit_equal(np.asarray(want[k]), got[k].numpy(), k)


def test_data_determinism_and_seek():
    b1 = data_mod.batch_at(DCFG, 7, device="cpu")
    b2 = data_mod.batch_at(DCFG, 7, device="cpu")
    b3 = data_mod.batch_at(DCFG, 8, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])


def test_data_host_sharding_partitions_batch():
    full = data_mod.batch_at(DCFG, 3, host_id=0, n_hosts=1, device="cpu")
    h0 = data_mod.batch_at(DCFG, 3, host_id=0, n_hosts=2, device="cpu")
    h1 = data_mod.batch_at(DCFG, 3, host_id=1, n_hosts=2, device="cpu")
    assert h0["tokens"].shape[0] == full["tokens"].shape[0] // 2
    assert not torch.equal(h0["tokens"], h1["tokens"])


def test_prefetcher():
    """Host batches in step order from the thread, equal to
    ``model_batch``; ``close`` ends the thread."""
    pf = data_mod.Prefetcher(DCFG, MCFG, start_step=2, depth=2)
    it = iter(pf)
    b0, b1 = next(it), next(it)
    pf.close()
    assert not pf.t.is_alive()
    assert b0["tokens"].shape == (4, 32) and b0["tokens"].device.type == "cpu"
    assert not torch.equal(b0["tokens"], b1["tokens"])
    for got, step in ((b0, 2), (b1, 3)):
        want = data_mod.model_batch(DCFG, MCFG, step, device="cpu")
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_batch_defaults_to_the_card(monkeypatch):
    """``device=None`` means the card, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data_mod.batch_at(DCFG, 0)


# ---------------------------------------------------------- loss, grads

@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_jax(jx, family):
    """``trainer.value_and_grad`` (autograd through ``loss_fn``, remat on)
    against ``jax.value_and_grad(loss_fn)`` on the same parameters and
    batch: loss rtol 1e-5, every gradient leaf within GRAD_TOL relative
    L2; remat off gives the same gradients bit for bit."""
    name = FAMILIES[family]
    cfg, jcfg = reduced(get_arch(name)), jx.cfg(name)
    params = _params(cfg, seed=3)
    jd = jx.data.DataConfig(seed=1, batch=4, seq_len=32, vocab=cfg.vocab)
    td = data_mod.DataConfig(seed=1, batch=4, seq_len=32, vocab=cfg.vocab)
    jloss, jgrads = jx.jax.jit(jx.jax.value_and_grad(
        lambda p, b: jx.M.loss_fn(jcfg, p, b, backend="reference")))(
        _jax_params(cfg, params), jx.data.model_batch(jd, jcfg, 4))
    batch = data_mod.model_batch(td, cfg, 4, device="cpu")
    loss, grads = T.value_and_grad(cfg, T.TrainConfig(), params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got = _flat(grads)
    want = _flat(_port_tree(cfg, _to_numpy(jx, jgrads)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel_l2(got[k], want[k]) <= GRAD_TOL, (k, _rel_l2(got[k],
                                                                 want[k]))
    _, plain = T.value_and_grad(cfg, T.TrainConfig(remat=False), params,
                                batch)
    for k, v in _flat(plain).items():
        assert_bit_equal(got[k], v, k)


def test_forward_keeps_no_graph_without_grad():
    """Serving and prefill memory: parameters from ``init_params`` do not
    require grad, so ``forward`` records no graph and wraps no block;
    under training the logits carry a graph."""
    params = _params(MCFG)
    batch = data_mod.batch_at(DCFG, 0, device="cpu")
    logits, _ = M.forward(MCFG, params, batch)
    assert logits.grad_fn is None and not logits.requires_grad
    live = map_tree(lambda p: p.detach().requires_grad_(), params)
    logits, _ = M.forward(MCFG, live, batch)
    assert logits.requires_grad


# ------------------------------------------------------------- optimizer

def test_schedule_and_global_norm_match_jax(jx):
    cfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=4, total_steps=20)
    jcfg = jx.opt.AdamWConfig(lr=3e-3, warmup_steps=4, total_steps=20)
    steps = np.arange(0, 25, dtype=np.int32)
    want = np.asarray(jx.opt.schedule(jcfg, jx.jnp.asarray(steps)))
    got = opt_mod.schedule(cfg, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    rng = np.random.default_rng(11)
    g = {"a": rng.normal(size=(7, 5)).astype(np.float32),
         "b": [rng.normal(size=(13,)).astype(np.float32) * 3.0]}
    want = float(jx.opt.global_norm(jx.jax.tree.map(jx.jnp.asarray, g)))
    got = float(opt_mod.global_norm(map_tree(torch.from_numpy, g)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("clip", [1e3, 0.05])
def test_adamw_apply_matches_jax(jx, clip):
    """One update from non-zero moments at step 6, fed the same
    gradients, with (clip 0.05) and without clipping: params, m and v
    within rtol 1e-6, grad norm and lr too."""
    rng = np.random.default_rng(int(clip * 100))
    draw = lambda *s: rng.normal(size=s).astype(np.float32)
    mk = lambda: {"w": draw(9, 4), "b": draw(4), "blocks": [draw(3, 3),
                                                            draw(5)]}
    p, g, m = mk(), mk(), mk()
    v = map_tree(np.abs, mk())
    kw = dict(lr=2e-3, weight_decay=0.1, grad_clip=clip, warmup_steps=3,
              total_steps=40)
    jj = lambda tree: jx.jax.tree.map(jx.jnp.asarray, tree)
    jp, jopt_state, jm = jx.opt.apply(
        jx.opt.AdamWConfig(**kw), jj(p), jj(g),
        jx.opt.OptState(jx.jnp.asarray(6, jx.jnp.int32), jj(m), jj(v)))
    tt = lambda tree: map_tree(lambda a: torch.from_numpy(a.copy()), tree)
    tp, topt, tm = opt_mod.apply(
        opt_mod.AdamWConfig(**kw), tt(p), tt(g),
        opt_mod.OptState(torch.tensor(6, dtype=torch.int32), tt(m), tt(v)))
    if clip < 1:
        assert float(jm["grad_norm"]) > clip      # clipping engaged
    for got, want in ((tp, jp), (topt.m, jopt_state.m),
                      (topt.v, jopt_state.v)):
        _assert_close_trees(got, _to_numpy(jx, want), rtol=1e-6)
    assert int(topt.step) == int(jopt_state.step) == 7
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


# ------------------------------------------------------------ trajectory

def test_state_from_numpy_carries_the_jax_state(jax_runs):
    want = jax_runs["state4"]
    st = T.state_from_numpy(MCFG, want, device="cpu")
    _assert_close_trees(st.params, _port_tree(MCFG, want.params))
    _assert_close_trees(st.opt.m, _port_tree(MCFG, want.opt.m))
    _assert_close_trees(st.opt.v, _port_tree(MCFG, want.opt.v))
    assert st.ef is None and st.opt.step.dtype == torch.int32
    assert int(st.opt.step) == 4
    ef = T.state_from_numpy(MCFG, jax_runs["init_compressed"], "cpu").ef
    assert isinstance(ef, collectives.EFState)
    assert all(float(r.abs().max()) == 0 for r in leaves(ef.residual))


def test_trajectory_matches_jax(jax_runs):
    """From ``state_from_numpy`` of JAX's initial state, 8 steps on the
    same batches, held at the trajectory tolerances step for step (the
    losses) and after 8 steps (the state)."""
    state = T.state_from_numpy(MCFG, jax_runs["init"], device="cpu")
    step = T.make_train_step(MCFG, tcfg_for(8))
    losses = []
    for s in range(8):
        state, m = step(state, data_mod.model_batch(DCFG, MCFG, s,
                                                    device="cpu"))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jax_runs["losses"],
                               rtol=TRAJ_LOSS_RTOL)
    _assert_state_close(state, jax_runs["state8"])


def test_microbatch_matches_jax(jax_runs):
    """One step at micro_batches=2 from the same state as JAX's."""
    want_loss, want = jax_runs["mb2"]
    state = T.state_from_numpy(MCFG, jax_runs["init"], device="cpu")
    state, m = T.make_train_step(MCFG, tcfg_for(8, micro_batches=2))(
        state, data_mod.model_batch(DCFG, MCFG, 0, device="cpu"))
    np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=1e-5)
    _assert_state_close(state, want)


def test_compressed_steps_match_jax(jx, jax_runs):
    """Two steps with compress_grads=True from JAX's state (zero
    residuals).  The int8 round trip turns a float32 difference of a
    gradient into a whole int8 step where g + r lies near a half step,
    so the step is held in two parts: (1) fed the port's own gradients,
    JAX's ``compress_tree`` and ``optimizer.apply`` give the port's step
    (residuals bit-equal, params and moments rtol 1e-6, atol 1e-6 of the
    leaf's largest element), and the gradients are JAX's
    (``test_loss_and_grads_match_jax``); (2) against
    JAX's whole compressed steps, the losses agree within rtol 5e-5 (the
    first step's parameters already part by up to lr where an element
    rounded to another int8 step; measured 1.2e-5 at the second
    step)."""
    tcfg = tcfg_for(8, compress_grads=True)
    state = T.state_from_numpy(MCFG, jax_runs["init_compressed"], "cpu")
    step = T.make_train_step(MCFG, tcfg)
    jj = lambda tree: jx.jax.tree.map(
        lambda t: jx.jnp.asarray(t.numpy()), tree)
    adamw = jx.opt.AdamWConfig(**tcfg.adamw._asdict())
    # compress_tree op by op: jitted, XLA contracts x - q * scale into a
    # fused multiply-add, which rounds the residual differently (D7)
    apply = jx.jax.jit(lambda *a: jx.opt.apply(adamw, *a)[:2])
    for s, (want_loss, want) in enumerate(jax_runs["compressed"]):
        batch = data_mod.model_batch(DCFG, MCFG, s, device="cpu")
        _, grads = T.value_and_grad(MCFG, tcfg, state.params, batch)
        jdeq, jef = jx.coll.compress_tree(jj(grads), jx.coll.EFState(
            jj(state.ef.residual)))
        jparams, jopt_state = apply(
            jj(state.params), jdeq,
            jx.opt.OptState(jx.jnp.asarray(state.opt.step.numpy()),
                            jj(state.opt.m), jj(state.opt.v)))
        state, m = step(state, batch)
        got, ref = _flat(state.ef.residual), _flat(_to_numpy(jx, jef.residual))
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert_bit_equal(ref[k], got[k], k)
        for got, ref in ((state.params, jparams), (state.opt.m, jopt_state.m),
                         (state.opt.v, jopt_state.v)):
            got, ref = _flat(got), _flat(_to_numpy(jx, ref))
            for k in ref:      # a moment element may sum to near zero
                np.testing.assert_allclose(
                    got[k], ref[k], rtol=1e-6,
                    atol=1e-6 * np.abs(ref[k]).max(), err_msg=k)
        np.testing.assert_allclose(float(m["loss"]), want_loss, rtol=5e-5)


def _run(steps, tcfg=None, state=None, start=0):
    tcfg = tcfg or tcfg_for(steps)
    if state is None:
        state = T.init_state(MCFG, tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step_fn = T.make_train_step(MCFG, tcfg)
    losses = []
    for s in range(start, steps):
        state, m = step_fn(state, data_mod.model_batch(DCFG, MCFG, s,
                                                       device="cpu"))
        losses.append(float(m["loss"]))
    return state, losses


def test_loss_decreases():
    _, losses = _run(12)
    assert losses[-1] < losses[0] - 0.3, losses


def test_microbatch_equivalence():
    """Gradient accumulation over 2 micro-batches == one big batch (the
    JAX test's bounds: loss rtol 1e-5, params atol 2e-5)."""
    t1 = T.TrainConfig(micro_batches=1, adamw=opt_mod.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=4))
    t2 = t1._replace(micro_batches=2)
    s1 = T.init_state(MCFG, t1, torch.Generator().manual_seed(0), "cpu")
    s2 = T.clone_state(s1)
    batch = data_mod.model_batch(DCFG, MCFG, 0, device="cpu")
    s1, m1 = T.make_train_step(MCFG, t1)(s1, batch)
    s2, m2 = T.make_train_step(MCFG, t2)(s2, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    _assert_close_trees(s1.params, s2.params, atol=2e-5)
    with pytest.raises(ValueError, match="micro-batches"):
        T.value_and_grad(MCFG, t1._replace(micro_batches=3), s1.params,
                         batch)


def test_step_updates_its_state_in_place():
    """The step consumes its input state; ``clone_state`` keeps one."""
    state = T.init_state(MCFG, tcfg_for(4), torch.Generator().manual_seed(0),
                         "cpu")
    keep = T.clone_state(state)
    new, _ = T.make_train_step(MCFG, tcfg_for(4))(
        state, data_mod.model_batch(DCFG, MCFG, 0, device="cpu"))
    assert new.params["embed"] is state.params["embed"]
    assert not torch.equal(keep.params["embed"], new.params["embed"])
    assert int(keep.opt.step) == 0 and int(new.opt.step) == 1


# ----------------------------------------------------------- compression

@pytest.mark.parametrize("scale", [1e-3, 1.0, 0.0])
def test_quantize_and_compress_tree_bit_equal_jax(jx, scale):
    rng = np.random.default_rng([7, int(scale * 1000)])
    g = {"a": (rng.normal(size=(33, 17)) * scale).astype(np.float32),
         "b": [(rng.standard_t(2, size=(64,)) * scale).astype(np.float32)]}
    r = map_tree(lambda a: (rng.normal(size=a.shape) * 1e-4 * scale)
                 .astype(np.float32), g)
    jq, js = jx.coll.quantize_int8(jx.jnp.asarray(g["a"]))
    tq, ts = collectives.quantize_int8(torch.from_numpy(g["a"]))
    assert_bit_equal(np.asarray(jq), tq.numpy(), "q")
    assert_bit_equal(np.asarray(js), ts.numpy(), "scale")
    assert_bit_equal(np.asarray(jx.coll.dequantize_int8(jq, js)),
                     collectives.dequantize_int8(tq, ts).numpy(), "deq")
    jj = lambda tree: jx.jax.tree.map(jx.jnp.asarray, tree)
    jdeq, jef = jx.coll.compress_tree(jj(g), jx.coll.EFState(jj(r)))
    tt = lambda tree: map_tree(torch.from_numpy, tree)
    tdeq, tef = collectives.compress_tree(tt(g), collectives.EFState(tt(r)))
    for got, want in ((tdeq, jdeq), (tef.residual, jef.residual)):
        w, t_ = _flat(_to_numpy(jx, want)), _flat(got)
        assert sorted(w) == sorted(t_)
        for k in w:
            assert_bit_equal(w[k], t_[k], k)


def test_grad_compression_error_feedback():
    """Lossy per step, but error feedback keeps the sum of what was
    applied plus the residual equal to the sum of the gradients."""
    rng = np.random.default_rng(0)
    g_true = [torch.from_numpy((rng.normal(size=(64, 64)) * 1e-3)
                               .astype(np.float32)) for _ in range(8)]
    ef = collectives.init_error_feedback(g_true[0])
    applied = torch.zeros((64, 64))
    for g in g_true:
        deq, ef = collectives.compress_tree(g, ef)
        applied = applied + deq
    want = sum(g.numpy().astype(np.float64) for g in g_true)
    assert np.abs(applied.numpy() + ef.residual.numpy() - want).max() < 1e-5
    one, _ = collectives.compress_tree(
        g_true[0], collectives.init_error_feedback(g_true[0]))
    assert float((one - g_true[0]).abs().max()) > 0


def _ef_inputs(rank: int):
    rng = np.random.default_rng([13, rank])
    g = torch.from_numpy(rng.normal(size=(40, 24)).astype(np.float32))
    ef = torch.from_numpy((rng.normal(size=(40, 24)) * 1e-3)
                          .astype(np.float32))
    return g, ef


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ef_rank(rank: int, world: int, port: int, out: str) -> None:
    """One gloo rank: ``compressed_all_reduce`` of its inputs, written to
    ``out.<rank>``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        red, new_ef = collectives.compressed_all_reduce(
            *_ef_inputs(rank), dist.group.WORLD)
        with open(f"{out}.{rank}", "wb") as fh:
            pickle.dump({"red": red.numpy(), "ef": new_ef.numpy(),
                         "jax": [m for m in sys.modules if m == "jax"
                                 or m.startswith(("jax.", "repro."))]}, fh)
    finally:
        dist.destroy_process_group()


def test_compressed_all_reduce_gloo_matches_one_process(tmp_path):
    """Two gloo ranks: each holds the sum of both ranks' dequantized
    values, bit-equal to the one-process sum in rank order, and its own
    residual, bit-equal to the one-process case (``group=None``)."""
    world, out = 2, str(tmp_path / "rank")
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_ef_rank, args=(r, world, port, out))
             for r in range(world)]
    for pr in procs:
        pr.start()
    try:
        for pr in procs:
            pr.join(SPAWN_TIMEOUT_S)
        assert not any(pr.is_alive() for pr in procs), "gloo ranks hung"
        assert [pr.exitcode for pr in procs] == [0] * world
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
    one = [collectives.compressed_all_reduce(*_ef_inputs(r))
           for r in range(world)]
    want = one[0][0] + one[1][0]
    for r in range(world):
        with open(f"{out}.{r}", "rb") as fh:
            got = pickle.load(fh)
        assert got["jax"] == []
        assert_bit_equal(want.numpy(), got["red"], f"sum on rank {r}")
        assert_bit_equal(one[r][1].numpy(), got["ef"], f"residual {r}")


# ------------------------------------------------------------ checkpoint

def test_checkpoint_restart_resumes_exactly(tmp_path):
    """Train 8; checkpoint at 4; 'crash'; resume from 4 -> identical."""
    tcfg = tcfg_for(8)
    state = T.init_state(MCFG, tcfg, torch.Generator().manual_seed(0), "cpu")
    step_fn = T.make_train_step(MCFG, tcfg)
    mgr = ckpt_mod.CheckpointManager(str(tmp_path))
    batch = lambda s: data_mod.model_batch(DCFG, MCFG, s, device="cpu")
    for s in range(4):
        state, _ = step_fn(state, batch(s))
    mgr.save(4, state, blocking=True)
    ref = state
    for s in range(4, 8):
        ref, _ = step_fn(ref, batch(s))
    restored = mgr.restore(device="cpu")           # simulate restart
    assert int(restored.opt.step) == 4
    for s in range(4, 8):
        restored, _ = step_fn(restored, batch(s))
    _assert_close_trees(restored.params, ref.params, atol=1e-6)


def test_checkpoint_snapshot_survives_in_place_steps(tmp_path):
    """``save`` returns with a complete host copy: the steps that update
    the state in place while the write runs do not reach the
    checkpoint."""
    tcfg = tcfg_for(8)
    state = T.init_state(MCFG, tcfg, torch.Generator().manual_seed(0), "cpu")
    want = T.clone_state(state)
    mgr = ckpt_mod.CheckpointManager(str(tmp_path))
    mgr.save(0, state)                              # asynchronous
    step_fn = T.make_train_step(MCFG, tcfg)
    for s in range(3):
        state, _ = step_fn(state, data_mod.model_batch(DCFG, MCFG, s,
                                                       device="cpu"))
    mgr.wait()
    got = mgr.restore(0, device="cpu")
    _assert_close_trees(got, want)
    assert not torch.equal(got.params["embed"], state.params["embed"])


def test_checkpoint_atomic_no_partial_dirs(tmp_path):
    mgr = ckpt_mod.CheckpointManager(str(tmp_path), keep=2)
    state = T.init_state(MCFG, T.TrainConfig(),
                         torch.Generator().manual_seed(0), "cpu")
    for s in (1, 2, 3):
        mgr.save(s, state, blocking=True)
    names = sorted(os.listdir(tmp_path))
    assert all(n.startswith("step_") for n in names), names
    assert len(names) == 2                      # keep=2 removed step_1
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path / names[-1])) == ["meta.json",
                                                        "state.pkl"]
    with pytest.raises(FileNotFoundError):
        ckpt_mod.CheckpointManager(str(tmp_path / "empty")).restore()


def test_checkpoint_elastic_restore_roundtrip(tmp_path):
    """A checkpoint holds host arrays: restoring onto another device
    (here the CPU, with compression's residuals in the state) gives the
    same values, in tensors of their own."""
    tcfg = T.TrainConfig(compress_grads=True)
    state = T.init_state(MCFG, tcfg, torch.Generator().manual_seed(0), "cpu")
    mgr = ckpt_mod.CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=True)
    restored = mgr.restore(device="cpu")
    assert isinstance(restored, T.TrainState)
    assert isinstance(restored.ef, collectives.EFState)
    _assert_close_trees(restored, state)
    assert restored.params["embed"].data_ptr() != \
        state.params["embed"].data_ptr()


def test_checkpoint_write_error_is_raised(tmp_path):
    """A failed background write surfaces at ``wait``."""
    d = tmp_path / "ck"
    mgr = ckpt_mod.CheckpointManager(str(d))
    d.rmdir()
    d.write_text("")                      # a file where the directory was
    with pytest.raises(OSError):
        mgr.save(1, {"x": torch.zeros(2)}, blocking=True)


# -------------------------------------------------------------- launcher

def test_launcher_resumes_at_the_saved_step(tmp_path, capsys):
    """``launch.train.main`` on the CPU: 6 steps with a checkpoint every
    4; with the final checkpoint gone (a crash before it), ``--resume``
    restarts at step 4 and gives steps 4-5's losses exactly."""
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "6",
            "--batch", "4", "--seq", "32", "--lr", "1e-3",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "4"]
    losses = launch_train.main(args)
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert ckpt_mod.CheckpointManager(str(tmp_path)).all_steps() == [4, 6]
    shutil.rmtree(tmp_path / "step_00000006")
    resumed = launch_train.main(args + ["--resume"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert resumed == losses[4:]


def test_launcher_micro_batches():
    assert launch_train.main(
        ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
         "--batch", "4", "--seq", "16", "--micro-batches", "2"])


def test_example_train_small_lm_torch(capsys):
    """``examples/train_small_lm_torch.py`` for 60 steps on the CPU:
    the loss drops, the mid-run checkpoint is restored."""
    path = ROOT / "examples" / "train_small_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_small_lm_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--steps", "60", "--batch", "4", "--seq", "32", "--device",
              "cpu"])
    assert "restored the checkpoint of step 31" in capsys.readouterr().out


# ----------------------------------------------------------------- guard

def test_trainer_refuses_kernel_backends():
    """No kernel has a backward: ``make_train_step`` refuses every backend
    but "reference" (a kernel's output would carry no gradient)."""
    for backend in ("cuda", "pallas"):
        with pytest.raises(NotImplementedError, match="no kernel"):
            T.make_train_step(MCFG, T.TrainConfig(backend=backend))


def test_reference_fault_pallas_grad_raises(jx):
    """Reference fault F7 (ROADMAP Queue 3): the JAX package cannot take a
    gradient through a Pallas kernel (no kernel defines a VJP; ``jax.grad``
    of the selective scan's Pallas path raises in interpret mode, while
    its forward runs), so ``TrainConfig(backend="pallas")`` cannot train.
    The port refuses the kernel backend up front
    (``test_trainer_refuses_kernel_backends``)."""
    from repro.kernels.mamba_scan.ops import selective_scan
    rng = np.random.default_rng(17)
    a = lambda *s: jx.jnp.asarray(rng.normal(size=s), jx.jnp.float32)
    x, bm, cm = a(1, 8, 16), a(1, 8, 4), a(1, 8, 4)
    dt = jx.jnp.asarray(rng.random((1, 8, 16)) * 0.1, jx.jnp.float32)
    A = -jx.jnp.asarray(rng.random((16, 4)) + 0.5, jx.jnp.float32)
    D = jx.jnp.ones(16)
    run = lambda x: selective_scan(x, dt, A, bm, cm, D, backend="pallas",
                                   interpret=True)
    assert run(x).shape == (1, 8, 16)
    with pytest.raises(AssertionError):
        jx.jax.grad(lambda x: run(x).sum())(x)
    with pytest.raises(NotImplementedError):
        T.make_train_step(MCFG, T.TrainConfig(backend="cuda"))


# ------------------------------------------------------------------ card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_attention", "rwkv6_scan",
                                    "mamba_scan"])
def test_kernels_refuse_inputs_that_require_grad_on_card(kernel):
    """B7, B8 and B9 have no backward: on inputs that require grad, with
    grad mode on, each launcher raises instead of returning a tensor
    with no gradient; under ``torch.no_grad`` the same call launches."""
    _needs_card()
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
    g = torch.Generator("cuda").manual_seed(3)
    r = lambda *s: torch.randn(s, generator=g, device="cuda")
    if kernel == "flash_attention":
        fn, args = flash_attention, (r(1, 4, 64, 32), r(1, 2, 64, 32),
                                     r(1, 2, 64, 32))
    elif kernel == "rwkv6_scan":
        fn, args = rwkv6_scan, (r(1, 2, 16, 32), r(1, 2, 16, 32),
                                r(1, 2, 16, 32),
                                torch.rand(1, 2, 16, 32, device="cuda"),
                                r(2, 32))
    else:
        fn, args = mamba_scan, (r(1, 16, 32), r(1, 16, 32).abs() * 0.1,
                                -r(32, 8).abs(), r(1, 16, 8), r(1, 16, 8),
                                r(32))
    args[0].requires_grad_(True)
    before = kernels.LAUNCHES[kernel]
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args)
    assert kernels.LAUNCHES[kernel] == before
    with torch.no_grad():
        out = fn(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[kernel] == before + 1 and not out.requires_grad


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu():
    """One step of reduced gemma3-1b on the card (backend "reference",
    TF32 off) against the same step on the CPU: loss rtol 1e-5, every
    parameter within 1e-5 (AdamW's first step moves each by ~lr)."""
    _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_arch("gemma3-1b"))
    tcfg = tcfg_for(4)
    dcfg = data_mod.DataConfig(seed=0, batch=4, seq_len=32, vocab=cfg.vocab)
    cpu = T.init_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    card = map_tree(lambda t: t.to("cuda"), cpu)
    losses = []
    for state, dev in ((cpu, "cpu"), (card, "cuda")):
        new, m = T.make_train_step(cfg, tcfg)(
            state, data_mod.model_batch(dcfg, cfg, 0, device=dev))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for a, b in zip(leaves(cpu.params), leaves(card.params)):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), atol=1e-5)
