"""Quickstart of the PyTorch port: the PrismDB core in 60 seconds.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The port's ``examples/quickstart.py``, line for line: builds a two-tier
store, writes past the fast tier's capacity to trigger MSC compactions,
reads with a zipfian skew, and prints where reads were served from --
the paper's central effect: hot keys stay on the fast tier.  Runs on the
card unless ``--device`` says otherwise, on the hand-written kernels
(``--backend cuda``, the default; on CPU tensors their plain versions).
Every client batch is one engine step, which runs the whole compaction
control plane; the tail drives a whole op stream through ``run_ops``.
The integers printed are the JAX example's; the dispatch counts differ
by design, because the port counts engine steps
(``repro_torch.core.db.PrismDB.dispatches``) where JAX counts jitted
calls.
"""
import argparse

import numpy as np

from repro_torch.core import engine
from repro_torch.core.db import PrismDB, stack_trees
from repro_torch.core.tiers import TierConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--backend", default="cuda",
                    help='"cuda" (the kernels) or "reference"')
    args = ap.parse_args(argv)
    cfg = TierConfig(
        key_space=1 << 14,        # 16k keys
        fast_slots=1 << 11,       # fast tier holds 12.5% of them
        slow_slots=1 << 14,
        value_width=4,
        tracker_slots=1 << 11,    # clock tracker ~12% of key space
        pin_threshold=0.7,        # pin the hottest 70% of tracked keys
        run_size=512, max_runs=64, n_buckets=64,
        bloom_bits_per_run=1 << 13,
    )
    db = PrismDB(cfg, seed=0, backend=args.backend, device=args.device)
    rng = np.random.default_rng(0)

    print("writing 3x the fast tier's capacity ...")
    for i in range(24):
        db.put(rng.integers(0, cfg.key_space, 256).astype(np.int32))
    print(f"  occupancy={db.occupancy():.2f} "
          f"compactions={db.counters['compactions']} "
          f"demoted={db.counters['demoted']}")

    print("reading with zipfian skew (hot keys should stay fast) ...")
    for i in range(40):
        keys = ((rng.zipf(1.3, 256) - 1) * 2654435761) % cfg.key_space
        vals, found, src = db.get(keys.astype(np.int32))
    c = db.counters
    ratio = c["hits_fast"] / max(c["hits_fast"] + c["hits_slow"], 1)
    print(f"  fast-tier read ratio: {ratio:.2f}")
    print(f"  slow-tier bytes written: {c['slow_bytes_written']:,} "
          f"(sequential runs)")
    print(f"  bloom filters skipped {c['bloom_probes'] - c['bloom_fps']:,} "
          f"pointless slow reads")

    print("scan [1000, +20):")
    keys, ok = db.scan(1000, 20)
    print(" ", [int(k) for k, o in zip(keys, ok) if o])

    # the port counts engine steps: one per client batch here, as JAX's
    # one jitted call per batch
    print(f"device dispatches so far: {db.dispatches} "
          f"(one per client batch -- compactions ran inside them)")

    print("run_ops: 16 batches through the engine loop ...")
    mk = lambda kind, ks: engine.make_op(kind, ks,
                                         value_width=cfg.value_width,
                                         device=db.device)
    batches = [mk(engine.PUT if i % 2 == 0 else engine.GET,
                  rng.integers(0, cfg.key_space, 256).astype(np.int32))
               for i in range(16)]
    ops = stack_trees(batches)
    before = db.dispatches
    res = db.run_ops(ops)
    # JAX runs the stream as ONE jitted lax.scan; the port counts each of
    # its engine steps
    print(f"  16 batches -> {db.dispatches - before} engine steps; "
          f"{int(res.found.sum())} keys found across the stream")
    print("OK")


if __name__ == "__main__":
    main()
