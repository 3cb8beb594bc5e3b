"""Workloads of the PyTorch port in 60 seconds.

  PYTHONPATH=src python examples/workloads_demo_torch.py [--device cpu]

The port's ``examples/workloads_demo.py``, line for line, on the card
unless ``--device`` says otherwise (``--backend cuda``, the default: the
hand-written kernels; on CPU tensors their plain versions).  Three acts:
  1. YCSB-A through ``run_workload``: each batch drawn and run as one
     engine step -- sampling, puts/gets, compactions, the read policy.
  2. A phased flash-crowd scenario: uniform traffic, a sudden skewed
     crowd, recovery.
  3. Trace replay: a recorded host trace packed into the same stacked
     stream format and replayed through ``run_ops``.
The integers printed are the JAX example's; the dispatch counts differ
by design: the port counts engine steps (one a batch), JAX one jitted
call a segment.
"""
import argparse

import numpy as np

from repro_torch import workloads as W
from repro_torch.core import engine
from repro_torch.core.db import PrismDB
from repro_torch.core.tiers import TierConfig

OPS = {engine.PUT: "put", engine.GET: "get", engine.DELETE: "del",
       engine.SCAN: "scan"}


def phase_report(stats, label):
    kinds = stats.kind.cpu().numpy()
    mix = {OPS[k]: int((kinds == k).sum()) for k in np.unique(kinds)}
    print(f"  {label}: {len(kinds)} batches, op mix {mix}, "
          f"found={int(stats.found.sum())}, "
          f"scan keys={int(stats.returned.sum())}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--backend", default="cuda",
                    help='"cuda" (the kernels) or "reference"')
    args = ap.parse_args(argv)
    cfg = TierConfig(key_space=1 << 13, fast_slots=1 << 10,
                     slow_slots=1 << 13, value_width=2, max_runs=64,
                     run_size=256, bloom_bits_per_run=1 << 12,
                     tracker_slots=1 << 10, n_buckets=64,
                     pin_threshold=0.5)
    db = PrismDB(cfg, seed=0, backend=args.backend, device=args.device)

    print("1) YCSB-A, each batch drawn and run as one engine step")
    db.reset_workload(seed=42)
    stats = db.run_workload(W.ycsb("A"), n_batches=32, batch=128)
    phase_report(stats, "ycsb-A")
    # the port counts engine steps: 32 here, where JAX counts 1
    print(f"  dispatches so far: {db.dispatches} (one per engine step)")
    c = db.counters
    print(f"  device counters: puts={c['puts']} gets={c['gets']} "
          f"compactions={c['compactions']}")

    print("2) flash-crowd scenario: 3 phases, one engine step a batch")
    sched = W.scenario("flash-crowd", cfg.key_space, 48)
    db.reset_workload(seed=43)      # new schedule -> restart the timeline
    stats = db.run_workload(sched, n_batches=W.total_batches(sched),
                            batch=128)
    phase_report(stats, "flash-crowd")
    print(f"  dispatches so far: {db.dispatches}")

    print("3) trace replay: host records -> stacked stream -> run_ops")
    trace = [("put", np.arange(200, dtype=np.int32)),
             ("get", np.arange(0, 200, 4, dtype=np.int32)),
             ("scan", np.array([16, 128], np.int32),
              np.array([8, 12], np.int32))]
    ops = W.pack_trace(trace, batch=256, value_width=cfg.value_width)
    res = db.run_ops(ops)
    hits = int(res.found[1].sum())
    print(f"  replayed {len(trace)} records in {len(trace)} engine steps: "
          f"{hits}/50 gets hit, scans returned "
          f"{int(res.src[2][:2].sum())} keys")
    print(f"  round-trip: {[r[0] for r in W.unpack_trace(ops)]}")


if __name__ == "__main__":
    main()
