"""AdamW with a warmup-cosine schedule and clipping by the global norm
(the port's copy of the JAX package's ``train/optimizer.py``).

``apply`` follows the JAX update order: clip by the global norm, then
``step + 1``, then the bias corrections ``1 - b**step`` in float32, then
``delta = mhat / (sqrt(vhat) + eps) + wd * p`` and ``p - lr * delta``.
(``torch.optim.AdamW`` decays the weights first, as ``p *= 1 - lr * wd``,
which rounds differently.)  The update is written leaf by leaf and runs
IN PLACE: the parameters and the moments given are the ones returned.
The schedule and the step counter stay on the device, so a step reads
nothing back to the host.  ``moment_specs`` gives the moments' logical
specs under ZeRO-1.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.core.tree import is_spec, leaves, map_tree


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


class OptState(NamedTuple):
    step: torch.Tensor         # int32 [], on the parameters' device
    m: Any
    v: Any


def init(params) -> OptState:
    """Zero moments (float32) beside every parameter, step 0."""
    z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = next(leaves(params)).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=map_tree(z, params), v=map_tree(z, params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (an integer tensor), float32: linear
    warmup over ``warmup_steps``, then a cosine from lr down to 0.1 lr at
    ``total_steps``."""
    f32 = torch.float32
    warm = torch.clamp(step.to(f32) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps).to(f32)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0,
                       1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over every leaf of its float32 squares."""
    total = torch.zeros((), dtype=torch.float32,
                        device=next(leaves(grads)).device)
    for g in leaves(grads):
        total = total + torch.sum(g.to(torch.float32) ** 2)
    return torch.sqrt(total)


@torch.no_grad()
def apply(cfg: AdamWConfig, params, grads, opt: OptState):
    """One AdamW update of ``params`` by ``grads`` (trees of the same
    structure), in place.  Returns (params, new OptState, metrics with
    ``grad_norm`` and ``lr``, 0-d float32 tensors)."""
    f32 = torch.float32
    gnorm = global_norm(grads)
    # a tensor numerator: a Python number over a tensor is computed as a
    # reciprocal times the number, which rounds differently from JAX
    scale = torch.clamp(gnorm.new_tensor(cfg.grad_clip)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = opt.step + 1
    lr = schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(f32)
    b2c = 1.0 - cfg.b2 ** step.to(f32)

    def upd(p, g, m, v):
        g = g.to(f32) * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))
        delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.to(f32))
        p.copy_(p.to(f32) - delta.mul_(lr))

    map_tree(upd, params, grads, opt.m, opt.v)     # leaves matched by key
    return params, OptState(step, opt.m, opt.v), {"grad_norm": gnorm,
                                                  "lr": lr}


def moment_specs(param_specs):
    """ZeRO-1: each moment takes its parameter's logical spec with the
    first dimension (after a leading "layers" or "stack") that has no
    logical name given the ``zero`` axis, which the rules map to
    'data'."""
    def one(spec):
        out = list(spec)
        if out and out[0] is None:
            out[0] = "zero"
        elif out and out[0] in ("layers", "stack") and len(out) > 1 \
                and out[1] is None:
            out[1] = "zero"
        return tuple(out)
    return map_tree(one, param_specs, is_leaf=is_spec)
