"""End-to-end training driver of the PyTorch port: a small LM for a few
hundred steps with the port's trainer (AdamW, checkpointing, synthetic
data), on the card unless ``--device`` says otherwise.

  PYTHONPATH=src python examples/train_small_lm_torch.py [--steps 200] \\
      [--device cpu]

Uses the gemma3-family reduced config with a 2,048-token vocabulary (the
huge-vocab family that motivates the tiered embedding store).  The loss
must drop.  A checkpoint is cut asynchronously mid-run, restored, and
replayed to the end, where its parameters must equal the uninterrupted
run's (deterministic algorithms on, so the card's atomic adds do not
part them).
"""
import argparse
import tempfile
import time

import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.backend import resolve_device
from repro_torch.core.tree import leaves
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import trainer as T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    mcfg = reduced(get_arch("gemma3-1b")).replace(vocab=2048)
    tcfg = T.TrainConfig(adamw=opt_mod.AdamWConfig(
        lr=1e-3, warmup_steps=10, total_steps=args.steps))
    dcfg = data_mod.DataConfig(seed=0, batch=args.batch, seq_len=args.seq,
                               vocab=mcfg.vocab)
    batch = lambda s: data_mod.model_batch(dcfg, mcfg, s, device=dev)
    mid = args.steps // 2 + 1

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        state = T.init_state(mcfg, tcfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
        step_fn = T.make_train_step(mcfg, tcfg)
        with tempfile.TemporaryDirectory(prefix="ck_") as ckdir:
            mgr = ckpt_mod.CheckpointManager(ckdir)
            losses = []
            t0 = time.time()
            for s in range(args.steps):
                state, m = step_fn(state, batch(s))
                losses.append(float(m["loss"]))
                if s % 20 == 0:
                    print(f"step {s:4d}  loss {losses[-1]:7.4f}  "
                          f"lr {float(m['lr']):.2e}")
                if s + 1 == mid:
                    mgr.save(mid, state)       # async mid-run checkpoint
            mgr.save(args.steps, state, blocking=True)
            dt = time.time() - t0
            toks = args.steps * args.batch * args.seq
            print(f"\n{toks:,} tokens in {dt:.1f}s ({toks / dt:.0f} tok/s "
                  f"on {dev})")
            print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
            if not losses[-1] < losses[0] - 1.0:
                raise RuntimeError("training failed to learn")

            restored = mgr.restore(mid, device=dev)
            for s in range(mid, args.steps):
                restored, _ = step_fn(restored, batch(s))
            diff = max(float((a - b).abs().max()) for a, b in
                       zip(leaves(restored.params), leaves(state.params)))
            print(f"restored the checkpoint of step {mid} and replayed to "
                  f"step {args.steps}: max |param diff| {diff:.3g}")
            if diff > 1e-6:
                raise RuntimeError("the restart did not resume exactly")
    finally:
        torch.use_deterministic_algorithms(deterministic)


if __name__ == "__main__":
    main()
