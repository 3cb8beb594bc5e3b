"""Serving example of the PyTorch port: batched requests through the
tiered-KV engine.

  PYTHONPATH=src python examples/serve_tiered_torch.py [--device cpu]

The port's ``examples/serve_tiered.py``, line for line, on the card
unless ``--device`` says otherwise (``--backend cuda``, the default: the
hand-written kernels under the paged-KV mirror; on CPU tensors their
plain versions).  Runs a small dense model behind the continuous-
batching engine with a deliberately small fast page pool, so the PrismDB
machinery works visibly: cold pages demote into slow runs, selected hot
pages stay resident, re-heated pages promote back.  The weights come
from a torch generator unless ``main`` is handed others (the tests hand
it the JAX example's, carried across by ``model.params_from_numpy``).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.backend import resolve_device
from repro_torch.core.paged_kv import PagedKVConfig
from repro_torch.models import model as M
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None, params=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--backend", default="cuda",
                    help='"cuda" (the kernels) or "reference"')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mcfg = reduced(get_arch("phi4-mini-3.8b"))
    if params is None:
        params = M.init_params(mcfg, torch.Generator(dev).manual_seed(0),
                               device=dev)
    kv_cfg = PagedKVConfig(
        n_layers=mcfg.n_layers, kv_heads=mcfg.n_kv_heads,
        head_dim=mcfg.head_dim, page_tokens=8,
        fast_pages=40,              # deliberately small: forces tiering
        slow_pages=1024, max_seqs=4, max_pages_per_seq=32,
        topk_pages=8, recent_pages=2, dtype="float32")
    eng = ServeEngine(mcfg, kv_cfg, params, backend=args.backend,
                      device=dev)

    rng = np.random.default_rng(0)
    n_req = 10
    for i in range(n_req):
        eng.submit(Request(rid=i,
                           prompt=list(rng.integers(1, mcfg.vocab, 64)),
                           max_new=24))
    t0 = time.time()
    ticks = eng.run()
    dt = time.time() - t0

    c = eng.counters
    total_reads = max(c["hits_fast"] + c["hits_slow"], 1)
    print(f"served {n_req} requests ({ticks} engine ticks, {dt:.1f}s)")
    print(f"compactions: {eng.stats['compactions']}  "
          f"pages demoted: {c['demoted']}  promoted: {c['promoted']}")
    print(f"page reads  : {total_reads} "
          f"({100 * c['hits_fast'] / total_reads:.1f}% from the fast pool, "
          f"{100 * c['hits_slow'] / total_reads:.1f}% from slow runs)")
    print(f"slow-link traffic: "
          f"{(c['slow_reads'] + c['slow_writes'])} pages, all sequential "
          f"runs (the paper's compaction I/O discipline)")
    assert eng.stats["retired"] == n_req
    print("OK")
    return eng


if __name__ == "__main__":
    main()
