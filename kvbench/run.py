"""Run one cell of the benchmark and print its result line.

    python3 kvbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card.  The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, traced also
``breakdown``, and last ``checks``: each number compared beside its
limit, which also end standard error).  It exits non-zero and prints no
result without a card, without the program (``src/``), or when a module
of JAX, Flax, the JAX package or its benchmarks was loaded.

Rehearsal on the CPU, at the configuration's counts cut by a factor
(no device metric is read there):

    python3 kvbench/run.py --workload <cell> --seed 1 --seconds 2 \\
        --trace 0 --cpu-shrink 1536
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of the program and of its libraries stays in the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's, Flax's, the JAX package's or its
    benchmarks'."""
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--cpu-shrink", type=int, default=0,
                   help="rehearse on the CPU, counts cut by this factor")
    p.add_argument("--control", choices=("bf16",), default=None,
                   help="run the comparison's control in the store's "
                        "place (never a benchmark run)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "kvbench" / ".cache" / sub)
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch
    from kvbench import harness, spec

    cell = spec.Cell(args.workload, root=ROOT)
    device = None
    if args.cpu_shrink:
        device = "cpu"
    elif not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"kvbench: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START, root=ROOT,
                           device=device, shrink_factor=args.cpu_shrink,
                           control=args.control)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"kvbench: the run loaded {bad}: the benchmark runs the "
              "PyTorch port alone", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
