"""Training launcher (the port's copy of the JAX package's
``launch/train.py``): real steps on one device, the card unless
``--device`` says otherwise.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --steps 20 [--reduced] --batch 8 --seq 128 \\
      [--checkpoint-dir ckpt] [--resume] [--device cpu]

``main(argv)`` returns the losses.  With ``--resume`` and a checkpoint in
``--checkpoint-dir``, training restarts at its step (the data stream is
a pure function of the step).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.backend import resolve_device
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import trainer as T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    mcfg = get_arch(args.arch)
    if args.reduced:
        mcfg = reduced(mcfg)
    tcfg = T.TrainConfig(
        micro_batches=args.micro_batches,
        adamw=opt_mod.AdamWConfig(lr=args.lr, warmup_steps=5,
                                  total_steps=args.steps))
    dcfg = data_mod.DataConfig(seed=args.seed, batch=args.batch,
                               seq_len=args.seq, vocab=mcfg.vocab)
    dev = resolve_device(args.device)

    state = None
    start = 0
    mgr = None
    if args.checkpoint_dir:
        mgr = ckpt_mod.CheckpointManager(args.checkpoint_dir)
        if args.resume and mgr.latest_step() is not None:
            state = mgr.restore(device=dev)
            start = int(state.opt.step)
            print(f"resumed from step {start}")
    if state is None:
        state = T.init_state(mcfg, tcfg,
                             torch.Generator(dev).manual_seed(args.seed),
                             device=dev)

    step_fn = T.make_train_step(mcfg, tcfg)
    losses = []
    for step in range(start, args.steps):
        batch = data_mod.model_batch(dcfg, mcfg, step, device=dev)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])           # waits for the step
        losses.append(loss)
        print(f"step {step:5d} loss {loss:8.4f} "
              f"gnorm {float(metrics['grad_norm']):8.3f} "
              f"dt {time.time() - t0:6.2f}s")
        if mgr and (step + 1) % args.checkpoint_every == 0:
            mgr.save(step + 1, state)
    if mgr:
        mgr.save(args.steps, state, blocking=True)
    if len(losses) > 5:
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"loss did not improve: {losses[0]:.4f} -> "
                               f"{losses[-1]:.4f}")
        print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


if __name__ == "__main__":
    main()
