"""GPipe pipeline parallelism over the "pod" mesh axis (the port's copy of
the JAX package's ``distributed/pipeline.py``).

The uniform layer stack is split into S = mesh["pod"] stages of
contiguous layers; a GPipe schedule of n_micro + S - 1 ticks feeds
microbatch t to stage 0 at tick t and passes each tick's stage outputs
on to the next stage, the last stage's outputs being the result.  The
bubble share is (S - 1) / (n_micro + S - 1).

Where the stages run follows the mesh:

* a stand-in mesh (``launch/mesh.MeshShape``): every stage in turn in
  this process, on one device, the rotation a shift of a list.  A
  stage's bubble ticks, whose outputs the JAX package computes and
  discards, are skipped;
* a named ``DeviceMesh`` with a "pod" dimension: each rank runs its own
  stage; the rotation is ``batch_isend_irecv`` to the next rank of the
  "pod" group (JAX's ``ppermute``), and the last stage's outputs reach
  every rank by an ``all_reduce`` of zeros elsewhere (JAX's ``psum``),
  which is exact.  Forward only: nothing carries a gradient across a
  send, so it refuses inputs that require grad.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.models import model
from repro_torch.models.common import norm


def pipelined_forward(mcfg: ModelConfig, mesh, params, batch, *,
                      n_micro: int = 4, backend: str = "reference"):
    """Logits [B, S, V] of ``batch["tokens"]`` through an S-stage GPipe
    over ``mesh``'s "pod" axis; stage s owns layers [s L / S,
    (s + 1) L / S) of ``params["blocks"]``.  As in the JAX package, the
    layers see the token embeddings and 1-D positions ``arange(S)`` (a
    vlm's batch ``embeds`` and M-RoPE positions are not read: reference
    fault F9, ROADMAP Queue 3), and the MoE layers' aux losses are
    dropped.  Refuses what the JAX package asserts: a family other than
    dense, moe and vlm, a layer count the stages do not divide, a batch
    ``n_micro`` does not divide.  With backend "cuda", B7 runs in every
    attention layer of every stage."""
    axes = sharding.mesh_axes(mesh)
    if "pod" not in axes:
        raise ValueError(f"pipelined_forward needs a 'pod' mesh axis, not "
                         f"{tuple(axes)}")
    n_stages = axes["pod"]
    if mcfg.family not in ("dense", "moe", "vlm") \
            or mcfg.n_layers % n_stages:
        raise ValueError(f"{mcfg.name}: the pipeline takes the dense, moe "
                         f"and vlm families with a layer count that the "
                         f"{n_stages} stages divide")
    tokens = batch["tokens"].to(torch.int64)
    b, s = tokens.shape
    if b % n_micro:
        raise ValueError(f"a batch of {b} in {n_micro} microbatches")
    x = params["embed"][tokens]
    mb = x.reshape(n_micro, b // n_micro, s, -1)
    pos = model._arange_positions(b // n_micro, s, x.device)
    stage = lambda st, h: run_stage(mcfg, params, st, n_stages, h, pos,
                                    backend)
    if hasattr(mesh, "axis_sizes"):
        outs = _in_turn(stage, mb, n_stages)
    else:
        outs = _on_mesh(stage, mb, mesh, n_stages)
    x = norm(params["final_norm"], outs.reshape(b, s, -1), mcfg.norm_kind,
             mcfg.norm_eps)
    return model._lm_logits(mcfg, params, x)


def run_stage(mcfg: ModelConfig, params, st: int, n_stages: int, h, pos,
              backend: str):
    """Stage ``st``'s layers over one microbatch's hidden state ``h``."""
    per = mcfg.n_layers // n_stages
    plan = model.layer_plan(mcfg)
    for l in range(st * per, (st + 1) * per):
        kind, use_moe, window = plan[l]
        h, _ = model._block_apply(mcfg, params["blocks"][l], h, pos, window,
                                  kind, use_moe, backend)
    return h


def _in_turn(stage, mb, n_stages: int):
    """The schedule with every stage in this process: at tick t, stage st
    runs microbatch t - st where there is one, from stage 0's input
    ``mb[t]`` or from what stage st - 1 gave at tick t - 1."""
    n_micro = mb.shape[0]
    bufs, outs = [None] * n_stages, []
    for t in range(n_micro + n_stages - 1):
        ys = [stage(st, mb[t] if st == 0 else bufs[st])
              if 0 <= t - st < n_micro else None for st in range(n_stages)]
        if ys[-1] is not None:
            outs.append(ys[-1])
        bufs = ys[-1:] + ys[:-1]               # stage st's output to st + 1
    return torch.stack(outs)


def _on_mesh(stage, mb, mesh, n_stages: int):
    """The schedule with this rank's stage only (its coordinate on the
    "pod" dimension of ``mesh``)."""
    import torch.distributed as dist
    if torch.is_grad_enabled() and mb.requires_grad:
        raise RuntimeError("pipelined_forward on a process group is forward "
                           "only: call it under torch.no_grad()")
    group = mesh.get_group("pod")
    st = mesh.get_local_rank("pod")
    peer = lambda i: dist.get_global_rank(group, i % n_stages)
    n_micro = mb.shape[0]
    buf = torch.zeros_like(mb[0])
    outs = torch.zeros_like(mb)
    for t in range(n_micro + n_stages - 1):
        m = t - st
        y = buf                                # a bubble tick: nothing new
        if 0 <= m < n_micro:
            y = stage(st, mb[m] if st == 0 else buf)
            if st == n_stages - 1:
                outs[m] = y
        if n_stages > 1:
            recv = torch.empty_like(buf)
            ops = [dist.P2POp(dist.isend, y.contiguous(), peer(st + 1),
                              group),
                   dist.P2POp(dist.irecv, recv, peer(st - 1), group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            buf = recv
    dist.all_reduce(outs, group=group)
    return outs
