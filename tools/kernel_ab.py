#!/usr/bin/env python3
"""Time another tree's build of the port's kernels against this tree's,
in one process on one card, in turns, through chip_smoke's own checks.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 tools/kernel_ab.py --parent DIR --kernels mamba_scan ...

DIR holds another tree's ``csrc`` sources (for instance the parent
commit's ``src/repro_torch/csrc``, written out with ``git archive`` or
``git show``); each named source must export the same C functions with
the same signatures as this tree's.  For each name, DIR's source is
built with the port's nvcc flags into a temporary directory and this
tree's as ``kernels/build.py`` builds it.  Then chip_smoke's check of
that kernel (its kernels rows: error against the plain version and
every timing) runs ``--rounds`` times a build, the two builds in turns
(in order, then reversed), on inputs drawn from the same seed: the
wrapper loads whichever library ``build.load`` holds, and the tool swaps
it.  paged_attention is checked, as in the smoke, on the live pools of a
serve engine at phi4-mini's width, stepped to the smoke's tick.

Prints one JSON line per check and per build (registers, spills and
SASS counts of each instance), then one line per kernel with every
``*ms`` figure of its rows as a list over the rounds for each build; all
go to chiprun_out/kernel_ab.jsonl.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "kernel_ab.jsonl"
OPCODES = ("FFMA", "FMUL", "FADD", "MUFU", "SHFL", "LDS", "LDG", "HMMA",
           "HGMMA")
NOT_TIMES = ("plain_ms", "library_ms", "bound_ms", "bound_parts")


def emit(obj: dict) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def build_other(names, parent: Path, tmp: Path) -> dict:
    """Compile DIR's source of every name at once; returns name ->
    (library path, ptxas report)."""
    from repro_torch.kernels import build
    procs = {}
    for name in names:
        out = tmp / f"lib{name}-parent.so"
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
             str(parent / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    built = {}
    for name, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {p.returncode}\n{log}")
        built[name] = (out, log)
    return built


def use(name: str, lib) -> None:
    """Make the wrappers of kernel source ``name`` launch from ``lib``."""
    from repro_torch.kernels import build
    build._LIBS[name] = lib
    ops = importlib.import_module(f"repro_torch.kernels.{name}.ops")
    getattr(ops, "_LIB", []).clear()          # wrappers that hold theirs
    if ops._lib() is not lib:
        raise RuntimeError(f"{name}: the wrapper did not take the library")


def checks(cs, np):
    """source name -> f(seed) -> chip_smoke's kernels rows for it."""
    from repro_torch.configs.prismdb_kv import paper_tier_config
    from repro_torch.core.embedding_store import EmbedStoreConfig
    full = paper_tier_config(cs.FULL_SCALE)
    embed = EmbedStoreConfig(vocab=cs.EMBED_VOCAB, dim=cs.EMBED_DIM,
                             fast_rows=cs.EMBED_FAST_ROWS)
    rng = np.random.default_rng
    engine = []

    def paged(seed):
        if not engine:                         # built once, on first use
            import torch
            from repro_torch.configs.base import get_arch
            from repro_torch.models import model
            cfg = get_arch(cs.MODEL)
            params = model.init_params(
                cfg, torch.Generator("cuda").manual_seed(cs.MODEL_SEED))
            eng, _ = cs.serve_engine(params, cfg, cs.SERVE_SEED, "cuda")
            while eng.stats["steps"] <= cs.SERVE_SHAPE.b6_at:
                eng.step()
            engine.append(eng)
        return [cs._check_paged_attention(engine[0], seed)]

    return {
        "clock_update": lambda s: [cs.check_clock_update(full, cs.BATCH,
                                                         rng(s))],
        "msc_score": lambda s: [cs.check_msc_score(full, rng(s))],
        "tier_compact": lambda s: cs.check_tier_compact(full, embed, rng(s)),
        "flash_attention": lambda s: [cs.check_flash_attention(rng(s), {})],
        "rwkv6_scan": lambda s: [cs.check_rwkv6_scan(rng(s), {})],
        "mamba_scan": lambda s: [cs.check_mamba_scan(rng(s), {})],
        "paged_attention": paged,
    }


def times(obj, path: str = "") -> dict:
    """Every number under a key "ms" or "*_ms" in ``obj``, by its path,
    but the plain version's, the library call's and the bound's."""
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            p = f"{path}.{k}" if path else str(k)
            if k in NOT_TIMES:
                continue
            if isinstance(v, (int, float)) and (k == "ms"
                                                or k.endswith("_ms")):
                out[p] = v
            elif isinstance(v, (dict, list)):
                out.update(times(v, p))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            tag = v.get("tag") or v.get("name") if isinstance(v, dict) \
                else None
            out.update(times(v, f"{path}[{tag or i}]"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="directory with the other tree's csrc sources")
    ap.add_argument("--kernels", required=True, nargs="+",
                    help="csrc source names, as kernels/build.py has them")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from repro_torch.kernels import build
    drive = checks(cs, np)
    unknown = [n for n in args.kernels if n not in drive]
    if unknown:
        ap.error(f"no check for {unknown}; known: {sorted(drive)}")
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text("")
    emit({"nvidia_smi": cs.smi_line(), "torch": torch.__version__,
          "parent": str(args.parent), "kernels": args.kernels})
    build.build_all()                  # all at once: the checks need others
    with tempfile.TemporaryDirectory() as tmp:
        other = build_other(args.kernels, args.parent, Path(tmp))
        for name in args.kernels:
            libs = {"parent": ctypes.CDLL(str(other[name][0])),
                    "this": build.load(name)}
            path, log = other[name]
            emit({"kernel": name, "build": "parent", "instances":
                  cs._kernel_instances({name: {"ptxas": log}}, name,
                                       OPCODES, path)})
            emit({"kernel": name, "build": "this", "instances":
                  cs._kernel_instances({}, name, OPCODES)})
            got = {b: {} for b in libs}
            for r in range(args.rounds):
                for b in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                    use(name, libs[b])
                    rows = drive[name](args.seed)
                    emit({"kernel": name, "build": b, "round": r,
                          "rows": rows})
                    for path, v in times(rows).items():
                        got[b].setdefault(path, []).append(v)
            use(name, libs["this"])
            emit({"kernel": name, "ms_by_build": got})
    return 0


if __name__ == "__main__":
    sys.exit(main())
