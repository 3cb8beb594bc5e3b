"""Workload driver (paper §7's evaluation traffic), the port's copy of the
JAX package's ``workloads/``.

Layers:
  spec       -- WorkloadSpec / GenState: op-mix + key-dist parameters
  sampler    -- samplers on jax.random's bits (bounded zipf, uniform,
                latest, seq) and ``sample_ops`` (stacked streams for
                ``run_ops``)
  schedule   -- PhaseSchedule: piecewise spec composition
  runner     -- generation and ``engine_step`` batch by batch, for one
                engine (``run_schedule``) or for the tenants of a
                ``PartitionedDB`` (``run_tenants``)
  trace      -- host-trace pack/unpack into the stacked stream format
  specs      -- canned YCSB A-F, Twitter clusters, phased scenarios
  reference  -- numpy mirrors + analytic pmfs (for tests)

The JAX package's ``run_tenants_sharded`` (a mesh) has no counterpart
here: on a process group each rank calls ``run_tenants`` on its own
tenants (``PartitionedDB.run_workload``).
"""
from repro_torch.workloads.spec import (GenState, WorkloadSpec,  # noqa: F401
                                        init_gen, spec)
from repro_torch.workloads.sampler import (sample_batch,  # noqa: F401
                                           sample_ops)
from repro_torch.workloads.schedule import (PhaseSchedule,  # noqa: F401
                                            as_schedule, n_phases, schedule,
                                            spec_at, total_batches)
from repro_torch.workloads.runner import (StepStats,  # noqa: F401
                                          run_schedule, run_tenants)
from repro_torch.workloads.trace import pack_trace, unpack_trace  # noqa: F401
from repro_torch.workloads.specs import (SCENARIOS,  # noqa: F401
                                         TWITTER_CLUSTERS, YCSB_KINDS,
                                         scenario, twitter, ycsb)
