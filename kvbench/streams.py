"""The one generator of traffic: it reads a traffic file and makes the
cell's op stream from the seed, on the device, before the window.

A traffic file gives:

    loop       the driver in ``kvbench/loops/`` ("closed")
    batch      ops a step; every op of a step is of one kind
    kinds      {kind: share of steps}, each a module in ``kvbench/kinds/``
    block      steps a block: each block holds every kind's share exactly,
               in an order drawn from the seed, so every seed gets the
               same work in another order
    keys       {"dist": module in ``kvbench/keys/``, and the
               distribution's own parameters}, over the loaded records
    warmup     {"until": "watermark_drain" or "steps", "steps": n,
               "max_steps": n}
    stream_ops_per_s   the highest rate the stream is made long enough for
    judge_every        one step in this many of a kind that answers
               (a get) keeps its answers for the checks, at an offset
               drawn from the seed
    readback   keys read back after the window: {"loaded": n,
               "written": n}

The load is the configuration's: every record, keys 0 .. n - 1 (YCSB's
hashed insert order) in an order drawn from the seed, write ids 0 ..
n - 1 in load order.  Every value is made from its write id and the
run's seed (``kvbench/values.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from kvbench import values
from kvbench.spec import plugin


def seeds(seed: int, n: int) -> list:
    """``n`` independent 63-bit seeds from one run seed (any size)."""
    ss = np.random.SeedSequence(int(seed))
    return [int(s.generate_state(2, np.uint64)[0] >> np.uint64(1))
            for s in ss.spawn(n)]


def generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def block_order(shares: dict, n_steps: int, block: int,
                rng: np.random.Generator) -> list:
    """Kinds of ``n_steps`` steps: every block of ``block`` steps holds
    round(share * block) of each kind, shuffled."""
    names = sorted(shares)
    counts = [int(round(shares[k] * block)) for k in names]
    counts[-1] = block - sum(counts[:-1])
    if min(counts) < 0:
        raise ValueError(f"kind shares {shares} do not fill a block")
    pattern = np.repeat(np.arange(len(names)), counts)
    out = []
    while len(out) < n_steps:
        out.extend(names[i] for i in rng.permutation(pattern))
    return out[:n_steps]


class _Ctx:
    """What a kind's ``make`` draws from."""

    def __init__(self, dist, key_gen, salt, wid0, value_width):
        self.dist, self.key_gen = dist, key_gen
        self.salt, self.wid0, self.value_width = salt, wid0, value_width

    def draw_keys(self, n: int) -> torch.Tensor:
        return self.dist.keys(self.key_gen, n)


class Load:
    """The configuration's load: every record's key on the device, in an
    order drawn from the seed; its values are made batch by batch."""

    def __init__(self, load: dict, seed: int, salt: int, value_width: int,
                 device):
        n = int(load["keys"])
        self.batch = int(load["batch"])
        self.salt, self.width = salt, value_width
        self.keys = torch.randperm(n, generator=generator(device, seed),
                                   device=device).to(torch.int32)

    def batches(self):
        for a in range(0, self.keys.shape[0], self.batch):
            k = self.keys[a:a + self.batch]
            wid = torch.arange(a, a + k.shape[0], dtype=torch.int64,
                               device=k.device)
            yield k, values.torch_values(self.salt, wid, self.width)


class Streams:
    """The op stream of ``n_steps`` steps: ``kinds[i]`` is step i's kind,
    ``index[i]`` its place among that kind's steps, and ``data[kind]``
    holds that kind's batches in step order."""

    def __init__(self, traffic: dict, n_steps: int, batch: int, seed: int,
                 salt: int, n_loaded: int, value_width: int, device,
                 bench_dir):
        s_order, s_keys, s_judge = seeds(seed, 3)
        self.readback = traffic.get("readback", {})
        self.kinds = block_order(traffic["kinds"], n_steps,
                                 int(traffic.get("block", 64)),
                                 np.random.default_rng(s_order))
        self.mods = {k: plugin(bench_dir, "kinds", k)
                     for k in sorted(traffic["kinds"])}
        self.index, seen = [], dict.fromkeys(self.mods, 0)
        for k in self.kinds:
            self.index.append(seen[k])
            seen[k] += 1
        self.every = int(traffic.get("judge_every", 1))
        self.offset = int(np.random.default_rng(s_judge).integers(
            self.every))
        dist = plugin(bench_dir, "keys", traffic["keys"]["dist"]).sampler(
            traffic["keys"], n_loaded, device)
        self.data = {}
        for i, k in enumerate(sorted(self.mods)):
            # each kind's writes follow the load's and the kinds before
            wid0 = n_loaded + sum(seen[m] for m in sorted(self.mods)[:i]) \
                * batch
            ctx = _Ctx(dist, generator(device, s_keys + i), salt, wid0,
                       value_width)
            self.data[k] = self.mods[k].make(ctx, max(seen[k], 1), batch)

    def submit(self, store, i: int):
        k = self.kinds[i]
        return self.mods[k].submit(store, self.data[k], self.index[i])

    def kept(self, i: int) -> bool:
        """Whether step ``i``'s answer is kept for the checks."""
        return (self.index[i] + self.offset) % self.every == 0
