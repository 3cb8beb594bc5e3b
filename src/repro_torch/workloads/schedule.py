"""PhaseSchedule: piecewise composition of WorkloadSpecs (the port's copy
of the JAX package's ``workloads/schedule.py``).

A schedule is the stacked spec (every field a CPU tensor with one entry
per phase) plus cumulative batch boundaries.  ``spec_at(sched, t)``
selects the phase of step ``t``, so a multi-phase workload (hot-set
shift, diurnal swing, flash crowd, ...) runs as one ``run_workload``
segment on one phase timeline.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.workloads.spec import WorkloadSpec

_FLOAT = ("p_get", "p_put", "p_del", "p_scan", "theta", "wtheta")


class PhaseSchedule(NamedTuple):
    specs: WorkloadSpec     # stacked: every field a CPU tensor [P]
    bounds: torch.Tensor    # i32[P]: cumulative batch count per phase end


def schedule(phases: Sequence[tuple[WorkloadSpec, int]]) -> PhaseSchedule:
    """Compose ``[(spec, n_batches), ...]`` into one schedule."""
    def field(name):
        dt = torch.float32 if name in _FLOAT else torch.int32
        return torch.stack([torch.as_tensor(getattr(sp, name), dtype=dt)
                            for sp, _ in phases])

    specs = WorkloadSpec(*[field(f) for f in WorkloadSpec._fields])
    bounds = torch.cumsum(torch.tensor([n for _, n in phases],
                                       dtype=torch.int32), 0,
                          dtype=torch.int32)
    return PhaseSchedule(specs=specs, bounds=bounds)


def as_schedule(work, n_batches: int) -> PhaseSchedule:
    """A bare spec becomes a single-phase schedule of ``n_batches``."""
    if isinstance(work, PhaseSchedule):
        return work
    return schedule([(work, n_batches)])


def total_batches(sched: PhaseSchedule) -> int:
    return int(sched.bounds[-1])


def n_phases(sched: PhaseSchedule) -> int:
    return sched.bounds.shape[0]


def spec_at(sched: PhaseSchedule, t) -> WorkloadSpec:
    """Spec governing step ``t`` as 0-d tensors (steps past the end keep
    the last phase: boundaries are end-exclusive, so the search takes
    the right side)."""
    t = torch.as_tensor(t, dtype=torch.int32).reshape(1)
    idx = torch.searchsorted(sched.bounds, t, right=True)[0]
    idx = idx.clamp(0, sched.bounds.shape[0] - 1)
    return WorkloadSpec(*[x[idx] for x in sched.specs])
