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
"""
from __future__ import annotations

from repro_torch.core import backend as backend_mod
from repro_torch.core import engine, policy, prng, tiers
from repro_torch.core.engine import EngineConfig, OpBatch
from repro_torch.core.tiers import TierConfig
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

