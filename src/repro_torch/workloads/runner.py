"""Workload execution: generation + engine step, one batch at a time (the
port's copy of the JAX package's ``workloads/runner.py``).

The JAX package fuses sampling and ``engine_step`` under one
``lax.scan``.  Here each step draws its batch on the host
(``sampler.sample_batch``: one host-to-device copy of its keys and
lengths, no read back) and runs one ``engine.engine_step``; the step's
aggregates (``StepStats``) are reduced on the device and stacked at the
end, so a segment adds no device-to-host read to those of its engine
steps.  The whole ``EngineState`` threads through, the in-flight
compaction carry of ``compaction_quantum > 0`` included, so a job
triggered in one segment drains across the next.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import engine, prng
from repro_torch.workloads.sampler import sample_batch
from repro_torch.workloads.schedule import PhaseSchedule, spec_at
from repro_torch.workloads.spec import GenState


class StepStats(NamedTuple):
    """Per-batch aggregates stacked over the segment (int32, on the
    engine's device)."""
    kind: torch.Tensor       # i32[T]: op kind executed
    found: torch.Tensor      # i32[T]: found lanes (get) / non-empty scans
    fast: torch.Tensor       # i32[T]: get lanes served from the fast tier
    returned: torch.Tensor   # i32[T]: scan keys returned


def run_schedule(estate: engine.EngineState, gst: GenState,
                 rng: torch.Tensor, sched: PhaseSchedule,
                 cfg: engine.EngineConfig, *, n_batches: int, batch: int,
                 t0: int = 0
                 ) -> tuple[engine.EngineState, GenState, torch.Tensor,
                            StepStats]:
    """Run ``n_batches`` schedule steps starting at step index ``t0``
    (a caller splits one schedule across segments on one phase
    timeline); ``gst`` and ``rng`` thread through so the stream
    continues where the previous segment stopped."""
    dev = estate.steps.device
    ks, vw = cfg.tier.key_space, cfg.tier.value_width
    i32 = torch.int32
    zero = torch.zeros((), dtype=i32, device=dev)
    kinds, found, fast, returned = [], [], [], []
    for t in range(int(t0), int(t0) + n_batches):
        rng, k = prng.split(rng, 2)
        gst, op = sample_batch(k, spec_at(sched, t), gst, batch=batch,
                               key_space=ks, value_width=vw, device=dev)
        estate, res = engine.engine_step(estate, op, cfg)
        kind = int(op.kind)
        kinds.append(kind)
        found.append(res.found.sum(dtype=i32))
        fast.append(((res.src == 0) & (kind == engine.GET)).sum(dtype=i32))
        returned.append(res.src.sum(dtype=i32) if kind == engine.SCAN
                        else zero)
    stats = StepStats(kind=torch.tensor(kinds, dtype=i32).to(dev),
                      found=torch.stack(found), fast=torch.stack(fast),
                      returned=torch.stack(returned))
    return estate, gst, rng, stats


def run_tenants(estates: list, gsts: list, rngs: torch.Tensor,
                scheds: list, cfg: engine.EngineConfig, *, n_batches: int,
                batch: int, t0: int = 0
                ) -> tuple[list, list, torch.Tensor, StepStats]:
    """``run_schedule`` for each tenant: tenant i runs ``scheds[i]`` on
    ``estates[i]`` (partition i of a ``PartitionedDB``) from its
    generator ``gsts[i]`` and key ``rngs[i]`` (int64[P, 2]).  Tenants
    share nothing, so tenant-major order (tenant 0's whole segment, then
    tenant 1's, ...) gives the bits of the JAX package's vmap over
    tenants.  Returns the new states, generators and keys, and StepStats
    stacked [P, T]."""
    out = [run_schedule(e, g, r, s, cfg, n_batches=n_batches, batch=batch,
                        t0=t0)
           for e, g, r, s in zip(estates, gsts, rngs, scheds)]
    est, gen, rng, stats = zip(*out)
    return (list(est), list(gen), torch.stack(rng),
            StepStats(*[torch.stack(x) for x in zip(*stats)]))
