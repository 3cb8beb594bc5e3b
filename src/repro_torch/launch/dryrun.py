"""Dry run of every (arch x shape x mesh) cell on the meta device (the
port's counterpart of the JAX package's ``launch/dryrun.py``).

JAX lowers and compiles each cell for a 256- or 512-chip mesh of fake
devices and reads XLA's memory and cost analyses.  The port has no SPMD
compiler: it builds each cell's parameters, state and inputs as meta
tensors (shapes and dtypes, no values; params and state in bfloat16, as
JAX's ``abstract_params`` / ``abstract_state`` take them) and runs the
cell's function on them under ``roofline/op_cost``:

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
* ``cost_analysis.flops`` and ``bytes accessed``: op_cost's global count
  over the devices, an even split (``cost_analysis.split``), with the
  global counts beside it in ``op_cost``;
* ``devices``, ``mesh``, ``ok``, ``lower_s`` (the seconds the run took).

``output_size_in_bytes``, ``temp_size_in_bytes``, ``alias_size_in_bytes``,
``collectives`` and ``hlo_cost`` are null, each with its ``why``: they
come from a compiled SPMD program, which the port does not build.

The plain RWKV-6 and Mamba scans loop over the sequence; they are counted
from runs of 2, 3 and 4 steps (``op_cost.StepCounted``), which the record
says under ``counted_apart``.  Each cell runs under its mesh
(``sharding.use_mesh``) and rules, as JAX lowers it under its mesh.
``--variant opt`` applies JAX's opt changes: banded attention for
mixed-window archs, the decode rules (batch over data x model, cache
head dim replicated), and the expert-parallel MoE dispatch
(``moe.moe_ffn_ep_local``), which on the meta device runs one rank's
part of each MoE layer and counts it once per (data shard, model rank).

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
                                              logical_to_spec,
                                              shard_count, use_mesh)
from repro_torch.kernels.mamba_scan import ops as mamba_ops
from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import decode_specs, input_specs
from repro_torch.models import model as M
from repro_torch.roofline.op_cost import OpCost, StepCounted
from repro_torch.train import trainer as T

META = torch.device("meta")
NO_SPMD = ("no counterpart: XLA reports it for a compiled SPMD program, "
           "and the port builds none")
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
    bf16 = torch.bfloat16
    pspecs = M.param_specs(cfg)
    if shape.kind == "train":
        tcfg = T.TrainConfig(micro_batches=micro_batches,
                             compress_grads=multi_pod)
        state = T.init_state(cfg, tcfg, None, META, bf16)
        batch = input_specs(cfg, shape)
        args = (state, batch)
        specs = (T.state_specs(pspecs, tcfg), batch_specs_tree(cfg, shape))
        step = T.make_train_step(cfg, tcfg)
        fn = lambda st, b: step(st, b)[1]["loss"]
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
        fn = lambda p, c, t, q: M.decode_step(cfg, p, c, t, q)[0]
    return {"cfg": cfg, "rules": rules,
            "mesh": make_production_mesh(multi_pod=multi_pod),
            "args": args, "specs": specs, "fn": fn}


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
        rec["memory_analysis"] = {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": None, "temp_size_in_bytes": None,
            "alias_size_in_bytes": None, "why_null": NO_SPMD}
        rec["cost_analysis"] = {
            "flops": cost["flops"] / n_dev,
            "bytes accessed": cost["bytes"] / n_dev,
            "split": "op_cost's global count over the devices, evenly"}
        rec["op_cost"] = {"flops": cost["flops"], "bytes": cost["bytes"],
                          "by_op": cost["by_op"]}
        rec["counted_apart"] = COUNTED_APART
        rec["collectives"] = None
        rec["hlo_cost"] = None
        rec["why_null"] = NO_SPMD
        rec["lower_s"] = round(time.time() - t0, 2)
        rec["devices"] = n_dev
        rec["ok"] = True
        print(f"[OK]   {arch:24s} {shape_name:12s} {rec['mesh']:8s} "
              f"run={rec['lower_s']:7.1f}s "
              f"flops={rec['cost_analysis']['flops']:.3e}/dev "
              f"args={arg_bytes / 2**30:.2f} GiB/dev")
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
