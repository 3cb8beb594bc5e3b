"""Serving launcher: the tiered-KV engine with batched synthetic requests
(the port's copy of the JAX package's ``launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --requests 16 --prompt-len 48 --max-new 16

Runs on the card with backend "cuda" (the clock_update, msc_score,
tier_compact and paged-attention kernels, B1-B6, launch there) unless
``--device cpu`` asks for the CPU, where backend "cuda" takes each
kernel's plain version.  The model is the arch's ``reduced`` config,
random from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.backend import resolve_device
from repro_torch.core.paged_kv import PagedKVConfig
from repro_torch.models import model as M
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> ServeEngine:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--fast-pages", type=int, default=96)
    ap.add_argument("--page-tokens", type=int, default=8)
    ap.add_argument("--max-seqs", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card (fails without one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mcfg = reduced(get_arch(args.arch))
    params = M.init_params(
        mcfg, torch.Generator(device=dev).manual_seed(args.seed),
        device=dev)
    kv_cfg = PagedKVConfig(
        n_layers=mcfg.n_layers, kv_heads=mcfg.n_kv_heads,
        head_dim=mcfg.head_dim, page_tokens=args.page_tokens,
        fast_pages=args.fast_pages, slow_pages=args.fast_pages * 16,
        max_seqs=args.max_seqs,
        max_pages_per_seq=(args.prompt_len + args.max_new)
        // args.page_tokens + 2,
        topk_pages=8, recent_pages=2, dtype="float32")
    eng = ServeEngine(mcfg, kv_cfg, params, seed=args.seed, backend="cuda",
                      device=dev)

    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        eng.submit(Request(rid=i,
                           prompt=list(rng.integers(1, mcfg.vocab,
                                                    size=args.prompt_len)),
                           max_new=args.max_new))
    t0 = time.time()
    ticks = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    c = eng.counters
    tok = c["gets"] and (args.requests * (args.prompt_len + args.max_new))
    print(f"served {args.requests} requests in {ticks} ticks "
          f"({dt:.1f}s, {tok / max(dt, 1e-9):.0f} tok/s)")
    print(f"engine stats: {eng.stats}")
    print("tier counters:", {k: v for k, v in c.items() if v})
    frac = c["hits_fast"] / max(c["hits_fast"] + c["hits_slow"], 1)
    print(f"fast-tier page-read fraction: {frac:.3f}")
    return eng


if __name__ == "__main__":
    main()
