"""Dry run of every (arch x shape x mesh) cell (the port's counterpart of
the JAX package's ``launch/dryrun.py``).

JAX lowers and compiles each cell for a 256- or 512-chip mesh of fake
devices and reads XLA's memory and cost analyses and the collectives of
the partitioned program.  The port runs each cell twice on the CPU,
with no data:

1. on meta tensors of the global shapes (shapes and dtypes, no values;
   params and state in bfloat16, as JAX's ``abstract_params`` /
   ``abstract_state`` take them) under ``roofline/op_cost``: the global
   count, ``op_cost``;
2. on DTensors, as rank 0 of the production mesh: a ``DeviceMesh`` of
   256 or 512 ranks over a fake process group (``launch/mesh.
   production_device_mesh``), every leaf laid out by its logical spec
   (``sharding.distribute_tree``), each local shard a meta tensor, under
   ``roofline/comm_cost``: what rank 0 computes and what it
   communicates.

The cell's function:

* ``train``: ``trainer.make_train_step`` (the loss's forward and
  backward, then AdamW; int8 error feedback on the multi-pod mesh, as
  JAX compresses there);
* ``prefill``: ``model.forward``;
* ``decode``: ``model.decode_step`` on an ``init_cache``-shaped cache.

Each record holds JAX's keys where the port has a counterpart:

* ``memory_analysis.argument_size_in_bytes``: the bytes one device holds
  of the arguments, each leaf's bytes over the product of the mesh axes
  of its spec (``distributed/sharding``; size-aware specs never pad, so
  this is exact);
* ``collectives``: rank 0's collectives by JAX's kind names, each kind's
  result bytes summed and ``count_<kind>`` (``comm_cost``; DTensor's
  choice of collective, not XLA's: ROADMAP Queue 3 lists where they
  part);
* ``hlo_cost``: ``flops`` and ``bytes`` of rank 0's local operations
  (sharded work once, replicated work in full), ``collectives`` and
  their sum ``collective_bytes``, which ``roofline/analysis`` turns into
  the collective term; beside it ``collective_axes``, the bytes by the
  mesh axes each collective's group spans ("pod", "data+model", ...);
* ``cost_analysis.flops`` and ``bytes accessed``: op_cost's global count
  over the devices, an even split (``cost_analysis.split``), with the
  global counts beside it in ``op_cost``;
* ``memory_analysis.output_size_in_bytes``, ``temp_size_in_bytes`` and
  ``alias_size_in_bytes``: rank 0's buffers in the DTensor run
  (``roofline/buffer_cost``): the bytes of its local shards of the
  cell's results, the peak of its live local bytes less the arguments
  and the results, and the results that are arguments updated in place
  (the train step's state, the decode step's cache; JAX's dry run
  donates nothing, so its alias is 0 and its output holds a second
  state or cache).  Eager frees are not XLA's buffer reuse, so temp
  parts from XLA's (ROADMAP D9); ``peak_unseen`` names the functions
  whose live bytes the peak cannot see.
  ``generated_code_size_in_bytes`` is null, with its ``why``;
* ``devices``, ``mesh``, ``ok``, ``lower_s`` (the seconds the cell took,
  ``spmd_s`` of them the DTensor run).

A cell's results are JAX's: the train step's (state, metrics), the
prefill's logits, the decode step's (logits, cache).

The plain RWKV-6 and Mamba scans loop over the sequence; they are counted
from runs of 2, 3 and 4 steps (``op_cost.StepCounted``), which the record
says under ``counted_apart``; on DTensors they run on each rank's local
shards.  Each cell runs under its mesh (``sharding.use_mesh``) and
rules, as JAX lowers it under its mesh.  ``--variant opt`` applies JAX's
opt changes: banded attention for mixed-window archs, the decode rules
(batch over data x model, cache head dim replicated), and the
expert-parallel MoE dispatch (``moe.moe_ffn_ep_local``), which on the
meta device runs one rank's part of each MoE layer and counts it once
per (data shard, model rank), and on DTensors runs rank 0's part and
sums the parts over "model" (JAX's ``shard_map`` and ``psum``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|both] [--out artifacts/dryrun_torch]
      [--micro-batches N] [--variant baseline|opt]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import (SHAPES, all_archs, applicable_shapes,
                                      get_arch)
from repro_torch.core.tree import is_spec, leaves, map_tree
from repro_torch.distributed.sharding import (DEFAULT_RULES, axis_rules,
                                              distribute_tree,
                                              logical_to_spec,
                                              register_strategies,
                                              shard_count, use_mesh)
from repro_torch.kernels.mamba_scan import ops as mamba_ops
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
from repro_torch.launch.mesh import (make_production_mesh,
                                    production_device_mesh)
from repro_torch.launch.specs import decode_specs, input_specs
from repro_torch.models import model as M
from repro_torch.roofline.comm_cost import collective_axes, spmd_cost
from repro_torch.roofline.op_cost import OpCost, StepCounted
from repro_torch.train import trainer as T

META = torch.device("meta")
NO_CODE = ("no counterpart: XLA's size of the compiled program's code; "
           "the port runs eager operations and compiles nothing a cell")
BUFFERS_FROM = ("rank 0's local storages in the DTensor run "
                "(roofline/buffer_cost): eager frees, not XLA's buffer "
                "reuse (ROADMAP D9)")
PEAK_UNSEEN = ("run 2-4 steps (op_cost.StepCounted): their live bytes at "
               "the full sequence are not in the peak")
COUNTED_APART = ("rwkv6_ref and mamba_ref (the plain scans) counted from "
                 "runs of 2, 3 and 4 steps, extrapolated to the sequence "
                 "length (roofline/op_cost.StepCounted)")


def batch_specs_tree(cfg, shape) -> dict:
    """Logical specs for the input batch."""
    logical = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"),
               "enc_embeds": ("batch", None, "embed"),
               "embeds": ("batch", "seq", "embed"),
               "positions": ("batch", "seq", None)}
    return {k: logical[k] for k in input_specs(cfg, shape)}


def per_device_bytes(specs, tensors, mesh) -> int:
    """The bytes one device holds of ``tensors``: each leaf's bytes over
    the product of the mesh axes its logical spec maps to."""
    def one(spec, t):
        n = shard_count(logical_to_spec(spec, mesh, shape=t.shape), mesh)
        return t.numel() * t.element_size() // n
    return sum(leaves(map_tree(one, specs, tensors, is_leaf=is_spec)))


@contextlib.contextmanager
def _scans_by_trip_count():
    """The plain scans counted by ``StepCounted`` while the block runs."""
    saved = rwkv_ops.rwkv6_ref, mamba_ops.mamba_ref
    rwkv_ops.rwkv6_ref = StepCounted(saved[0], {0: 2, 1: 2, 2: 2, 3: 2}, 2)
    mamba_ops.mamba_ref = StepCounted(saved[1], {0: 1, 1: 1, 3: 1, 4: 1}, 1)
    try:
        yield
    finally:
        rwkv_ops.rwkv6_ref, mamba_ops.mamba_ref = saved


def cell_rules(cfg, shape, variant: str) -> tuple:
    """(the model config, the sharding rules) of a cell: the opt variant's
    MoE dispatch, banded attention and decode rules (JAX's
    ``lower_cell``)."""
    rules = DEFAULT_RULES
    if variant == "opt":
        if cfg.moe:
            cfg = cfg.replace(moe_dispatch="ep_local")
        if len(set(cfg.window_pattern)) > 1:
            cfg = cfg.replace(banded_local=True)
        if shape.kind == "decode":
            rules = {**DEFAULT_RULES, "batch": ("pod", "data", "model"),
                     "cache_head_dim": None}
    return cfg, rules


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               micro_batches: int = 1, variant: str = "baseline") -> dict:
    """A cell on the meta device: {"cfg", "rules", "mesh", "args" (the
    argument tree), "specs" (its logical specs), "fn" (runs the cell on
    ``args``)}."""
    shape = SHAPES[shape_name]
    cfg, rules = cell_rules(get_arch(arch), shape, variant)
    return build_cell(cfg, shape, rules, multi_pod, micro_batches)


def build_cell(cfg, shape, rules: dict, multi_pod: bool,
               micro_batches: int = 1) -> dict:
    """``lower_cell``'s cell of a model config and a ``ShapeConfig``
    (the tests build cells of reduced configs with it)."""
    bf16 = torch.bfloat16
    pspecs = M.param_specs(cfg)
    if shape.kind == "train":
        tcfg = T.TrainConfig(micro_batches=micro_batches,
                             compress_grads=multi_pod)
        state = T.init_state(cfg, tcfg, None, META, bf16)
        batch = input_specs(cfg, shape)
        args = (state, batch)
        specs = (T.state_specs(pspecs, tcfg), batch_specs_tree(cfg, shape))
        fn = T.make_train_step(cfg, tcfg)
    elif shape.kind == "prefill":
        params = M.init_params(cfg, None, bf16, META)
        batch = input_specs(cfg, shape)
        args = (params, batch)
        specs = (pspecs, batch_specs_tree(cfg, shape))

        def fn(p, b):
            with torch.no_grad():
                return M.forward(cfg, p, b, remat=False)[0]
    else:
        params = M.init_params(cfg, None, bf16, META)
        cache = M.init_cache(cfg, shape.global_batch, shape.seq_len, bf16,
                             META)
        d = decode_specs(cfg, shape)
        args = (params, cache, d["tokens"], d["pos"])
        specs = (pspecs, M.cache_specs(cfg), ("batch",), ("batch",))
        fn = lambda p, c, t, q: M.decode_step(cfg, p, c, t, q)
    return {"cfg": cfg, "rules": rules,
            "mesh": make_production_mesh(multi_pod=multi_pod),
            "args": args, "specs": specs, "fn": fn}


def spmd_count(cell: dict, mesh) -> dict:
    """``cell`` run on DTensors on ``mesh`` (a named ``DeviceMesh``), as
    the mesh's rank 0: each leaf of its arguments laid out by its spec
    on a meta local shard, the plain tensors the model makes replicated
    (``implicit_replication``).  Returns ``comm_cost.spmd_cost``'s count
    of rank 0's work, collectives and buffers, with ``collective_axes``:
    the collectives' bytes by the mesh axes each group spans."""
    from torch.distributed.tensor.experimental import implicit_replication
    register_strategies()
    with axis_rules(cell["rules"]):
        args = distribute_tree(cell["specs"], cell["args"], mesh)
        with use_mesh(mesh), implicit_replication(), \
                _scans_by_trip_count():
            cost = spmd_cost(cell["fn"], *args)[1]
    return {**cost, "collective_axes": collective_axes(cost["by_group"],
                                                       mesh)}


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: str,
             micro_batches: int = 1, variant: str = "baseline") -> dict:
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    try:
        cell = lower_cell(arch, shape_name, multi_pod, micro_batches,
                          variant)
        mesh = cell["mesh"]
        n_dev = mesh.size
        with axis_rules(cell["rules"]), use_mesh(mesh):
            arg_bytes = per_device_bytes(cell["specs"], cell["args"], mesh)
            with _scans_by_trip_count(), OpCost() as mode:
                cell["fn"](*cell["args"])
        cost = mode.result()
        t1 = time.time()
        with production_device_mesh(multi_pod=multi_pod) as dmesh:
            spmd = spmd_count(cell, dmesh)
        buf = spmd["buffers"]
        rec["memory_analysis"] = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": buf["output"],
            "temp_size_in_bytes": buf["temp"],
            "generated_code_size_in_bytes": None,
            "alias_size_in_bytes": buf["alias"],
            "why_null": NO_CODE, "buffers_from": BUFFERS_FROM,
            "peak_unseen": {f: PEAK_UNSEEN for f in buf["unseen"]}}
        rec["cost_analysis"] = {
            "flops": cost["flops"] / n_dev,
            "bytes accessed": cost["bytes"] / n_dev,
            "split": "op_cost's global count over the devices, evenly"}
        rec["op_cost"] = {"flops": cost["flops"], "bytes": cost["bytes"],
                          "by_op": cost["by_op"]}
        rec["counted_apart"] = COUNTED_APART
        rec["collectives"] = spmd["collectives"]
        rec["hlo_cost"] = {k: spmd[k] for k in (
            "flops", "bytes", "collectives", "collective_bytes")}
        rec["collective_axes"] = spmd["collective_axes"]
        rec["lower_s"] = round(time.time() - t0, 2)
        rec["spmd_s"] = round(time.time() - t1, 2)
        rec["devices"] = n_dev
        rec["ok"] = True
        print(f"[OK]   {arch:24s} {shape_name:12s} {rec['mesh']:8s} "
              f"run={rec['lower_s']:7.1f}s "
              f"flops={rec['hlo_cost']['flops']:.3e}/dev "
              f"coll={rec['hlo_cost']['collective_bytes']:.3e} B/dev "
              f"args={arg_bytes / 2**30:.2f} GiB/dev "
              f"peak={buf['peak'] / 2**30:.2f} GiB/dev")
    except Exception as e:                  # a failed cell is a record
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[FAIL] {arch:24s} {shape_name:12s} {rec['mesh']:8s} {e}")
    os.makedirs(outdir, exist_ok=True)
    tag = "" if variant == "baseline" else f".{variant}"
    fn = f"{arch}_{shape_name}_{'multi' if multi_pod else 'single'}{tag}.json"
    with open(os.path.join(outdir, fn), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "opt"])
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(all_archs())
    results = []
    for arch in archs:
        shapes = [s.name for s in applicable_shapes(get_arch(arch))]
        if args.shape:
            shapes = [s for s in shapes if s == args.shape]
        for sn in shapes:
            for mp in {"single": [False], "multi": [True],
                       "both": [False, True]}[args.mesh]:
                results.append(run_cell(arch, sn, mp, args.out,
                                        args.micro_batches, args.variant))
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells passed")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
