"""PrismDB facade: the paper's client interface over the port's engine.

A client batch is one ``engine.engine_step``: the data op and the whole
compaction control plane (rate limit, watermark loop, §5.3 read policy,
the deep boundaries' hysteresis when there are more than two tiers, and
with ``compaction_quantum > 0`` one drained quantum of the in-flight
migration).  ``run_workload`` drives the paper's traffic
(``repro_torch.workloads``) through the same step.
``device=None`` means the card; ``backend`` defaults to "cuda" (the
hand-written kernels).  The CPU tests pass ``device="cpu"``, where the
"cuda" backend takes each kernel's plain PyTorch version.

``PartitionedDB`` is the same step over P shared-nothing partitions
(paper §4.1), in one process or spread over a ``torch.distributed``
process group.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import engine, policy, prng, tiers
from repro_torch.core.engine import EngineConfig, OpBatch, OpResult
from repro_torch.core.tiers import TierConfig
from repro_torch.core.utils import pack_buckets, part_of_key
from repro_torch.obs import export as obs_export
from repro_torch.obs.state import ObsConfig


class PrismDB:
    """Single-partition store: batched Put/Get/Delete/Scan + compaction.

    ``dispatches`` counts engine steps issued by this facade (one per
    client batch, ``len(stream)`` per ``run_ops``, ``n_batches`` per
    ``run_workload``); ``host_reads`` counts
    the device-to-host reads their control flow took."""

    def __init__(self, cfg: TierConfig, seed: int = 0,
                 pol_cfg: policy.PolicyConfig | None = None,
                 promote: bool = True, precise: bool = False,
                 selection: str = "msc", pin_mode: str = "object",
                 append_only: bool = False, consolidate_every: int = 0,
                 backend: str = "cuda", obs: ObsConfig | None = None,
                 compaction_quantum: int = 0, device=None):
        self.cfg = cfg
        self.device = backend_mod.resolve_device(device)
        obs = obs if obs is not None else ObsConfig()
        if obs.n_tiers != cfg.n_tiers:
            obs = obs._replace(n_tiers=cfg.n_tiers)
        self.ecfg = EngineConfig(
            tier=cfg, pol=pol_cfg or policy.PolicyConfig(), promote=promote,
            precise=precise, selection=selection, pin_mode=pin_mode,
            append_only=append_only, consolidate_every=consolidate_every,
            backend=backend, obs=obs, compaction_quantum=compaction_quantum)
        self.estate = engine.init(self.ecfg, prng.PRNGKey(seed),
                                  device=self.device)
        self.dispatches = 0
        self.host_reads = 0

    @property
    def state(self) -> tiers.TierState:
        return self.estate.tier

    @property
    def pol(self) -> policy.PolicyState:
        """A copy of the §5.3 policy state (the engine updates it in
        place)."""
        return engine.dealias(self.estate.pol)

    @property
    def promote(self) -> bool:
        return self.ecfg.promote

    @property
    def precise(self) -> bool:
        return self.ecfg.precise

    def _dispatch(self, op: OpBatch):
        before = engine.HOST_READS.n
        self.estate, res = engine.engine_step(self.estate, op, self.ecfg)
        self.host_reads += engine.HOST_READS.n - before
        self.dispatches += 1
        return res

    def _op(self, kind, keys, vals=None, valid=None, aux=None) -> OpBatch:
        return engine.make_op(kind, keys, vals, valid, aux,
                              value_width=self.cfg.value_width,
                              device=self.device)

    def put(self, keys, vals=None, valid=None):
        self._dispatch(self._op(engine.PUT, keys, vals, valid))

    def get(self, keys, valid=None):
        res = self._dispatch(self._op(engine.GET, keys, valid=valid))
        return res.vals, res.found, res.src

    def delete(self, keys, valid=None):
        self._dispatch(self._op(engine.DELETE, keys, valid=valid))

    def scan(self, lo: int, n: int):
        return tiers.scan(self.estate.tier, lo, n)

    def scan_ops(self, starts, lens, valid=None):
        """Batched bounded range scans (YCSB-E); per-lane live counts."""
        res = self._dispatch(self._op(engine.SCAN, starts, valid=valid,
                                      aux=lens))
        return res.src

    def run_ops(self, ops: OpBatch):
        """Drive a stacked op stream (leading axis = batches); returns
        stacked OpResults."""
        ops = OpBatch(*[x.to(self.device) if i else x
                        for i, x in enumerate(ops)])
        before = engine.HOST_READS.n
        self.estate, res = engine.run_ops(self.estate, ops, self.ecfg)
        self.host_reads += engine.HOST_READS.n - before
        self.dispatches += int(ops.kind.numel())
        return res

    def reset_workload(self, seed: int = 0) -> None:
        """(Re)start the workload stream: generator state, its key and
        the phase timeline."""
        from repro_torch import workloads
        self._gen = workloads.init_gen(self.cfg.key_space)
        self._wrng = prng.PRNGKey(seed)
        self._wt = 0

    def run_workload(self, work, n_batches: int, batch: int):
        """Run ``n_batches`` steps of a WorkloadSpec / PhaseSchedule, each
        batch drawn on the host and run as one engine step.  Successive
        calls continue the same stream and phase timeline
        (``reset_workload`` restarts them); returns stacked StepStats.
        ``dispatches`` grows by ``n_batches`` (it counts engine steps)."""
        from repro_torch import workloads
        if getattr(self, "_gen", None) is None:
            self.reset_workload()
        sched = workloads.as_schedule(work, n_batches)
        before = engine.HOST_READS.n
        self.estate, self._gen, self._wrng, stats = workloads.run_schedule(
            self.estate, self._gen, self._wrng, sched, self.ecfg,
            n_batches=n_batches, batch=batch, t0=self._wt)
        self.host_reads += engine.HOST_READS.n - before
        self._wt += n_batches
        self.dispatches += n_batches
        return stats

    @property
    def counters(self) -> dict:
        """Object-unit counters + derived byte counters (host readback)."""
        c = tiers.counters_dict(self.estate.tier.ctr)
        vb = self.cfg.value_bytes
        c["fast_bytes_read"] = c["fast_reads"] * vb
        c["fast_bytes_written"] = c["fast_writes"] * vb
        c["slow_bytes_read"] = c["slow_reads"] * vb
        c["slow_bytes_written"] = c["slow_writes"] * vb
        return c

    def occupancy(self) -> float:
        return float(tiers.fast_occupancy(self.estate.tier))

    def obs_snapshot(self) -> dict:
        """Host snapshot of the observability plane (one readback)."""
        return obs_export.snapshot(self.estate.obs)



# --------------------------------------------------------- partitions

def route_batch(keys: torch.Tensor, p: int, per_part: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter a batch into [P, per_part] padded per-partition batches:
    ``(routed, valid, dropped)``, with the keys beyond ``per_part`` in
    one partition counted in the per-partition ``dropped`` int32[P].
    The partition of a key is ``utils.part_of_key``, as in the
    process-group exchange, so both routing paths place keys alike."""
    return pack_buckets(keys, part_of_key(keys, p), p, per_part)


def stack_trees(trees: list):
    """Per-partition trees (NamedTuples of tensors) -> one tree whose
    leaves carry a leading partition axis (copies)."""
    first = trees[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[stack_trees(list(x)) for x in zip(*trees)])
    if isinstance(first, tuple):
        return tuple(stack_trees(list(x)) for x in zip(*trees))
    return torch.stack(trees) if torch.is_tensor(first) else first


class PartitionedDB:
    """Shared-nothing partitions (paper §4.1, Fig. 11d): keys are routed
    by hash, and each partition runs the same ``engine_step`` on its own
    slice of a client batch, masked for the load imbalance within the
    batch.  ``dropped`` counts the keys beyond a partition's pad, per
    partition.

    The JAX package vmaps ``engine_step`` over a stacked state; here each
    partition keeps its own ``EngineState`` on the device (``estates``),
    and a client batch steps partition 0, then 1, ...  Partitions share
    nothing, so the order changes no bit.  ``state``, ``pol``,
    ``counters`` and ``obs_snapshot`` present JAX's stacked layout (a
    leading partition axis on every leaf) as copies.

    ``group=None`` keeps every partition in this process, on ``device``
    (None: the card).  A ``torch.distributed`` process group of D > 1
    ranks, D dividing ``n_partitions``, spreads them: rank r owns
    partitions ``[r * lp, (r + 1) * lp)``, every rank is handed the same
    global batch and routes its slice of it through
    ``distributed.collectives.exchange_keys``; ``get`` then returns the
    rank's own rows, and ``stacked``, ``state``, ``pol``, ``counters``
    and ``obs_snapshot`` gather the global layout (collectives: every
    rank calls them, in the same order).

    ``dispatches`` counts client batches: one per ``put`` or ``get`` (as
    in JAX, though each is P engine steps here), and ``n_batches`` per
    ``run_workload``, which JAX counts as one; ``host_reads`` counts the
    device-to-host reads of the engine steps' control flow."""

    def __init__(self, cfg: TierConfig, n_partitions: int, seed: int = 0,
                 promote: bool = True,
                 pol_cfg: policy.PolicyConfig | None = None,
                 backend: str = "cuda", obs: ObsConfig | None = None,
                 compaction_quantum: int = 0, group=None, device=None):
        self.cfg = cfg
        self.p = n_partitions
        self.device = backend_mod.resolve_device(device)
        self.group = group
        self.d, self.rank = 1, 0
        if group is not None:
            import torch.distributed as dist
            self.d = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            if self.d < 2 or n_partitions % self.d:
                raise ValueError(
                    f"a process group of {self.d} ranks for {n_partitions} "
                    "partitions: it needs more than one rank, and a number "
                    "that divides the partitions (group=None for one "
                    "process)")
        self.lp = n_partitions // self.d
        obs = obs if obs is not None else ObsConfig()
        if obs.n_tiers != cfg.n_tiers:
            obs = obs._replace(n_tiers=cfg.n_tiers)
        self.ecfg = EngineConfig(
            tier=cfg, pol=pol_cfg or policy.PolicyConfig(), promote=promote,
            backend=backend, obs=obs, compaction_quantum=compaction_quantum)
        self._own = range(self.rank * self.lp, (self.rank + 1) * self.lp)
        keys = prng.split(prng.PRNGKey(seed), n_partitions)
        self.estates = [engine.init(self.ecfg, keys[i], device=self.device)
                        for i in self._own]
        self._dropped = torch.zeros(n_partitions, dtype=torch.int32,
                                    device=self.device)
        self.dispatches = 0
        self.host_reads = 0
        self._gen = None

    def _gather(self, tree):
        """This process's [lp, ...] tree -> the global [P, ...] one."""
        if self.group is None:
            return tree
        from repro_torch.distributed import collectives
        return collectives.all_gather_stack(tree, self.group, self.device)

    @property
    def state(self) -> tiers.TierState:
        return self._gather(stack_trees([e.tier for e in self.estates]))

    @property
    def pol(self) -> policy.PolicyState:
        return self._gather(stack_trees([e.pol for e in self.estates]))

    def stacked(self) -> engine.EngineState:
        """A copy of every partition's engine state in the stacked
        layout (gathered from every rank on a process group)."""
        return self._gather(stack_trees(self.estates))

    @property
    def dropped(self) -> int:
        """Keys that exceeded a partition's pad, in all."""
        return int(self._dropped.sum())

    @property
    def dropped_per_partition(self) -> list:
        """Routing-overflow drops per partition: a skewed tenant whose
        keys land on one partition shows up here."""
        return [int(x) for x in self._dropped.cpu()]

    def _route(self, keys: torch.Tensor):
        """(routed, valid, dropped) of this process's partitions."""
        b = keys.shape[0]
        if self.group is None:
            return route_batch(keys, self.p, max(2 * b // self.p, 8))
        from repro_torch.distributed import collectives
        # the JAX mesh path's padding and capacity (equal to the one-
        # process pad at D = 1)
        bpad = -(-b // self.d) * self.d
        cap = max(2 * (bpad // self.d) // self.p, 8)
        kpad = torch.zeros(bpad, dtype=torch.int32, device=self.device)
        kpad[:b] = keys
        vpad = torch.arange(bpad, device=self.device) < b
        lo, hi = self.rank * bpad // self.d, (self.rank + 1) * bpad // self.d
        return collectives.exchange_keys(
            kpad[lo:hi], self.p, cap, self.group, local_parts=self.lp,
            valid=vpad[lo:hi])

    def _dispatch(self, keys, kind: int) -> OpResult:
        keys = torch.as_tensor(np.asarray(keys, np.int32) if not
                               torch.is_tensor(keys) else keys,
                               device=self.device).to(torch.int32)
        routed, valid, dropped = self._route(keys)
        before = engine.HOST_READS.n
        res = []
        for i in range(self.lp):
            op = engine.make_op(kind, routed[i], valid=valid[i],
                                value_width=self.cfg.value_width,
                                device=self.device)
            self.estates[i], r = engine.engine_step(self.estates[i], op,
                                                    self.ecfg)
            res.append(r)
        self.host_reads += engine.HOST_READS.n - before
        self._dropped += dropped
        self.dispatches += 1
        return OpResult(*[torch.stack(x) for x in zip(*res)])

    def put(self, keys):
        self._dispatch(keys, engine.PUT)

    def get(self, keys):
        """Routed get: ``(vals, found, src)`` of this process's
        partitions, [lp, per, ...] (lp = P with no process group)."""
        res = self._dispatch(keys, engine.GET)
        return res.vals, res.found, res.src

    # -- multi-tenant workloads ------------------------------------------
    def reset_workload(self, seed: int = 0) -> None:
        """(Re)start every tenant's stream: tenant i draws from
        ``prng.split(prng.PRNGKey(seed), P)[i]``."""
        from repro_torch import workloads
        self._gen = [workloads.init_gen(self.cfg.key_space)
                     for _ in self._own]
        self._wrng = prng.split(prng.PRNGKey(seed), self.p)[
            self._own.start:self._own.stop]
        self._wt = 0

    def run_workload(self, works, n_batches: int, batch: int):
        """Multi-tenant mixes: tenant i (= partition i) runs its own
        WorkloadSpec / PhaseSchedule over its own partition.  ``works`` is
        one workload for every tenant or a list of P (with equal phase
        counts, as JAX's stacked schedules need).  Each batch is drawn on
        the host; no batch crosses partitions, so a process group runs
        its own tenants with no collective.  Returns StepStats stacked
        [lp, T] (the rank's own tenants on a process group)."""
        from repro_torch import workloads
        if self._gen is None:
            self.reset_workload()
        if isinstance(works, (workloads.WorkloadSpec,
                              workloads.PhaseSchedule)):
            works = [works] * self.p
        works = list(works)
        if len(works) != self.p:
            raise ValueError(f"{len(works)} workloads for {self.p} tenants")
        scheds = [workloads.as_schedule(w, n_batches) for w in works]
        counts = [workloads.n_phases(s) for s in scheds]
        if len(set(counts)) != 1:
            raise ValueError("tenant schedules must have equal phase "
                             f"counts, got {counts}")
        before = engine.HOST_READS.n
        self.estates, self._gen, self._wrng, stats = workloads.run_tenants(
            self.estates, self._gen, self._wrng,
            [scheds[i] for i in self._own], self.ecfg,
            n_batches=n_batches, batch=batch, t0=self._wt)
        self.host_reads += engine.HOST_READS.n - before
        self._wt += n_batches
        self.dispatches += n_batches
        return stats

    @property
    def counters(self) -> dict:
        """Per-partition counter lists (``tiers.counters_dict`` with
        ``partitioned=True``)."""
        return tiers.counters_dict(
            self._gather(stack_trees([e.tier.ctr for e in self.estates])),
            partitioned=True)

    def obs_snapshot(self) -> dict:
        """Merged cross-partition snapshot: histograms summed, timelines
        and event rings per partition (``obs.export.snapshot``)."""
        return obs_export.snapshot(
            self._gather(stack_trees([e.obs for e in self.estates])))
