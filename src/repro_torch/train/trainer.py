"""The training step: loss -> gradients -> (int8 compression) -> AdamW
(the port's copy of the JAX package's ``train/trainer.py``).

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``
with ``loss``, ``grad_norm`` and ``lr``.  Gradients come from
``torch.autograd.grad`` through ``model.loss_fn`` (each block recomputed
in the backward pass with ``remat``, as JAX's ``jax.checkpoint``), on
backend "reference" only: no kernel of the port has a backward, as no
Pallas kernel of the JAX package has a VJP.  On DTensors (the dry run's
SPMD half) each gradient is reduced to its parameter's layout, and the
optimizer's ZeRO-1 moments take their shards of it.  Micro-batches
accumulate as JAX's scan does: the sum of the per-micro-batch gradients
over n, and the loss likewise.  The step updates the state's tensors IN
PLACE (it consumes its input state, as the engine steps do);
``clone_state`` keeps a copy.  ``state_specs`` gives the state's logical
specs (the moments and the residual ZeRO-1 sharded).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.core.tree import leaves, map_tree
from repro_torch.distributed import collectives
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt_mod


class TrainConfig(NamedTuple):
    micro_batches: int = 1
    backend: str = "reference"
    remat: bool = True
    compress_grads: bool = False     # int8 + error feedback
    adamw: opt_mod.AdamWConfig = opt_mod.AdamWConfig()


class TrainState(NamedTuple):
    params: dict
    opt: opt_mod.OptState
    ef: collectives.EFState | None


def init_state(mcfg: ModelConfig, tcfg: TrainConfig,
               generator: torch.Generator, device=None,
               dtype=torch.float32) -> TrainState:
    """Fresh parameters from ``generator`` (``model.init_params``) on
    ``device`` (None: the card), zero moments, and zero residuals when
    ``tcfg.compress_grads``."""
    params = M.init_params(mcfg, generator, dtype, device)
    ef = collectives.init_error_feedback(params) if tcfg.compress_grads \
        else None
    return TrainState(params, opt_mod.init(params), ef)


def state_specs(param_specs, tcfg: TrainConfig) -> TrainState:
    """The logical specs of a ``TrainState`` whose parameters have
    ``param_specs``: the moments and the error-feedback residual (with
    ``compress_grads``) take ``optimizer.moment_specs``; the step is a
    scalar."""
    mspec = opt_mod.moment_specs(param_specs)
    return TrainState(
        params=param_specs,
        opt=opt_mod.OptState(step=(), m=mspec, v=mspec),
        ef=collectives.EFState(mspec) if tcfg.compress_grads else None)


def state_from_numpy(mcfg: ModelConfig, tree, device=None) -> TrainState:
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) -> the port's, on ``device`` (None: the card): the params,
    ``opt.m``, ``opt.v`` and the ``ef`` residual through
    ``model.params_from_numpy`` (one dict per layer), ``opt.step`` int32.
    Copies every leaf."""
    conv = lambda t: M.params_from_numpy(mcfg, t, device)
    step = torch.tensor(int(np.asarray(tree.opt.step)), dtype=torch.int32,
                        device=resolve_device(device))
    ef = None if tree.ef is None else collectives.EFState(
        conv(tree.ef.residual))
    return TrainState(conv(tree.params),
                      opt_mod.OptState(step, conv(tree.opt.m),
                                       conv(tree.opt.v)), ef)


def clone_state(state: TrainState) -> TrainState:
    """A copy of ``state`` in buffers of its own (a step updates its input
    state in place)."""
    return map_tree(lambda t: t.detach().clone(), state)


def _check_backend(tcfg: TrainConfig) -> None:
    if tcfg.backend != "reference":
        raise NotImplementedError(
            f"training on backend {tcfg.backend!r}: no kernel of the port "
            "has a backward (as jax.grad through the JAX package's "
            "pallas_call raises); train on backend 'reference'")


def value_and_grad(mcfg: ModelConfig, tcfg: TrainConfig, params,
                   batch: dict):
    """(loss, grads) of ``model.loss_fn`` at ``params`` on ``batch``: the
    loss a detached 0-d tensor, the gradients a tree like ``params``.
    With ``tcfg.micro_batches`` n > 1 the batch splits into n equal
    slices along its first dimension, and both are the sums over the
    slices divided by n."""
    _check_backend(tcfg)
    n = tcfg.micro_batches
    if n == 1:
        return _value_and_grad(mcfg, tcfg, params, batch)
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} micro-batches")
    loss_sum, gsum = None, None
    for i in range(n):
        mb = {k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
        loss, g = _value_and_grad(mcfg, tcfg, params, mb)
        if gsum is None:
            loss_sum, gsum = loss, g
        else:
            loss_sum = loss_sum + loss
            map_tree(lambda acc, gi: acc.add_(gi), gsum, g)
        del g
    return loss_sum / n, map_tree(lambda g: g.div_(n), gsum)


def _value_and_grad(mcfg: ModelConfig, tcfg: TrainConfig, params, batch):
    live = map_tree(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = M.loss_fn(mcfg, live, batch, backend=tcfg.backend,
                         remat=tcfg.remat)
        # a parameter that the loss does not read gets zeros, as under
        # jax.grad
        grads = iter(torch.autograd.grad(loss, list(leaves(live)),
                                         allow_unused=True,
                                         materialize_grads=True))
    return loss.detach(), map_tree(lambda p: _laid_out_as(next(grads), p),
                                   params)


def _laid_out_as(g, p):
    """A gradient laid out as its parameter: on DTensors the data-parallel
    reduction (a gradient partial over the batch's ranks is all-reduced),
    as JAX's gradients take their parameters' shardings; a plain
    gradient as it is."""
    if type(g).__name__ != "DTensor" or g.placements == p.placements:
        return g
    return g.redistribute(p.device_mesh, p.placements)


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig):
    """``step(state, batch) -> (state, metrics)``: gradients
    (``value_and_grad``), then with ``tcfg.compress_grads`` the int8
    error-feedback round trip of every leaf (``compress_tree``), then
    AdamW (``optimizer.apply``), all in place.  Raises
    ``NotImplementedError`` for any backend but "reference"."""
    _check_backend(tcfg)

    def train_step(state: TrainState, batch: dict):
        loss, grads = value_and_grad(mcfg, tcfg, state.params, batch)
        ef = state.ef
        if tcfg.compress_grads and ef is not None:
            grads, ef = collectives.compress_tree(grads, ef)
        params, opt, metrics = opt_mod.apply(tcfg.adamw, state.params,
                                             grads, state.opt)
        metrics["loss"] = loss
        return TrainState(params, opt, ef), metrics

    return train_step
