"""The engine step: one client batch with its whole control plane.

A port of the JAX package's ``core/engine.py`` for the two-tier,
run-to-completion configuration.  ``engine_step`` runs the maintenance
loop (§4.2 rate limit, watermark hysteresis, §5.3 read policy), then the
masked put/get/delete pass, the scan lane and the obs record.

The JAX package keeps the maintenance loop on the device
(``lax.while_loop``).  Here it is a Python loop bounded by
``max_rounds`` whose condition is read back with one host read per round
(plus one per step for the loop's inputs); every such read is counted in
``HOST_READS``.  ``run_ops`` is a Python loop over a stacked op stream.

State tensors are updated in place where that saves a pool-sized copy
(see ``tiers`` and ``compaction``): ``engine_step`` consumes the state
it is given, as the JAX engine's donated buffers are.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import compaction, policy, prng, tiers
from repro_torch.core.tiers import (Counters, TierConfig, TierState,
                                    TrackerState)
from repro_torch.obs import state as obs_plane
from repro_torch.obs.state import ObsConfig, ObsState

PUT, GET, DELETE, SCAN = 0, 1, 2, 3


class HostReads:
    """Count of device-to-host reads taken by the engine's control flow."""
    n = 0


HOST_READS = HostReads()


def _read(*ts: torch.Tensor) -> list:
    """One host read of a few scalars (counted)."""
    HOST_READS.n += 1
    return torch.stack([t.to(torch.int64).reshape(()) for t in ts]).tolist()


class EngineConfig(NamedTuple):
    """Static engine parameters (the JAX ``EngineConfig`` without its
    jit- and mesh-specific knobs)."""
    tier: TierConfig
    pol: policy.PolicyConfig = policy.PolicyConfig()
    promote: bool = True
    precise: bool = False
    selection: str = "msc"
    pin_mode: str = "object"
    append_only: bool = False
    scan_chunk: int = 32
    max_rounds: int = 256
    consolidate_every: int = 0
    backend: str = "reference"  # "reference" (plain PyTorch) or "cuda"
    obs: ObsConfig = ObsConfig()
    compaction_quantum: int = 0


class EngineState(NamedTuple):
    tier: TierState
    pol: policy.PolicyState
    rng: torch.Tensor           # int64[2] on the host: the two uint32
                                # key words (see core.prng)
    virtual_extra: torch.Tensor  # i32: append-only phantom fast-tier fill
    steps: torch.Tensor         # i32: engine steps (consolidation clock)
    payload: Any = ()
    obs: Any = ()               # ObsState when cfg.obs.enabled, else ()
    comp: Any = ()              # in-flight carry: not ported (quantum 0)


class OpBatch(NamedTuple):
    """One client batch (stacked on a leading axis for ``run_ops``)."""
    kind: torch.Tensor          # i32 scalar: PUT / GET / DELETE / SCAN
    keys: torch.Tensor          # i32[B] (scan: range start keys)
    vals: torch.Tensor          # f32[B, V]
    valid: torch.Tensor         # bool[B]
    aux: torch.Tensor           # i32[B] (scan: requested range length)


class OpResult(NamedTuple):
    vals: torch.Tensor          # f32[B, V] (zeros unless get)
    found: torch.Tensor         # bool[B]
    src: torch.Tensor           # i32[B]: get 0=fast 1=slow -1=miss;
                                #         scan: live keys returned


def check_supported(cfg: EngineConfig) -> None:
    """Raise for configurations this slice of the port does not run."""
    backend_mod.check(cfg.backend)
    if cfg.tier.n_tiers != 2:
        raise NotImplementedError(
            "n_tiers > 2 is not ported yet (ROADMAP Queue 1: N=3, "
            "compact_boundary / _deep_tick)")
    if cfg.compaction_quantum > 0:
        raise NotImplementedError(
            "compaction_quantum > 0 is not ported yet (ROADMAP Queue 1: "
            "next slice, tier_compact B3/B4 + InFlight/drain_quantum)")


def init(cfg: EngineConfig, rng: torch.Tensor, device=None) -> EngineState:
    """A fresh engine state on ``device`` (None: the card; raises without
    one).  ``rng`` is a host key from ``prng.PRNGKey``."""
    check_supported(cfg)
    dev = backend_mod.resolve_device(device)
    return EngineState(
        tier=tiers.init(cfg.tier, dev), pol=policy.init(dev),
        rng=rng.cpu(),
        virtual_extra=torch.zeros((), dtype=torch.int32, device=dev),
        steps=torch.zeros((), dtype=torch.int32, device=dev),
        obs=obs_plane.init(cfg.obs, dev) if cfg.obs.enabled else ())


def make_op(kind: int, keys, vals=None, valid=None, aux=None, *,
            value_width: int, device=None) -> OpBatch:
    """Build an OpBatch with the facade defaults (value = broadcast key)
    on ``device`` (None: the card).  ``kind`` stays a host scalar: the
    engine branches on it without a device read."""
    dev = backend_mod.resolve_device(device)
    keys = torch.as_tensor(np.asarray(keys, np.int32) if not
                           torch.is_tensor(keys) else keys,
                           device=dev).to(torch.int32)
    if vals is None:
        vals = keys[:, None].to(torch.float32).expand(
            keys.shape[0], value_width)
    if valid is None:
        valid = torch.ones(keys.shape, dtype=torch.bool, device=dev)
    if aux is None:
        aux = torch.zeros(keys.shape, dtype=torch.int32, device=dev)
    as_t = lambda x, dt: torch.as_tensor(
        np.asarray(x) if not torch.is_tensor(x) else x, device=dev).to(dt)
    return OpBatch(kind=torch.tensor(int(kind), dtype=torch.int32),
                   keys=keys, vals=as_t(vals, torch.float32).contiguous(),
                   valid=as_t(valid, torch.bool), aux=as_t(aux, torch.int32))


# ------------------------------------------------------------ compaction

def _compact1(state: EngineState, cfg: EngineConfig, force_pin_keys,
              trigger: int) -> EngineState:
    """One compaction + append-only fill accounting + one obs event."""
    rng, sub = prng.split(state.rng, 2)
    tier, stats = compaction.compact_once(
        state.tier, cfg.tier, sub, promote=cfg.promote, precise=cfg.precise,
        selection=cfg.selection, pin_mode=cfg.pin_mode,
        force_pin_keys=force_pin_keys, backend=cfg.backend)
    ve = state.virtual_extra
    if cfg.append_only:
        ve = (ve - stats.n_superseded).clamp(min=0)
    obs = state.obs
    if cfg.obs.enabled:
        obs = obs_plane.record_compaction(obs, cfg.obs, step=state.steps,
                                          trigger=trigger, stats=stats)
    return state._replace(tier=tier, rng=rng, virtual_extra=ve, obs=obs)


def _occupancy(used: int, n: int) -> np.float32:
    """float32 occupancy, computed as the JAX package does on device."""
    return np.float32(used) / np.float32(n)


def maintenance(state: EngineState, cfg: EngineConfig, *, need=0,
                wm_gate: bool = True, policy_enable: bool = True,
                force_pin_keys=None) -> EngineState:
    """The maintenance plane as one loop bounded by ``cfg.max_rounds``:
    compact while usable fast slots are below ``need`` (§4.2 rate
    limit), while the watermark trigger armed at entry holds the fast
    tier above the low watermark, and for the §5.3 policy budget.
    One host read at entry and one per compaction round."""
    t = state.tier
    total = t.ctr.gets + t.ctr.puts + t.ctr.scans
    scalars = [tiers.free_fast_slots(t), state.virtual_extra]
    if torch.is_tensor(need):
        scalars.append(need)
    if policy_enable:
        pol_next, go = policy.step(state.pol, t, cfg.pol, total_ops=total)
        state = state._replace(pol=pol_next)
        scalars.append(torch.where(go & (pol_next.phase == policy.ACTIVE),
                                   cfg.pol.compactions_per_epoch_step, 0))
    vals = _read(*scalars)
    free, ve = vals[:2]
    if torch.is_tensor(need):
        need = vals[2]
    n_pol = vals[-1] if policy_enable else 0
    nf = t.keys[0].shape[0]
    high = np.float32(cfg.tier.high_watermark)
    low = np.float32(cfg.tier.low_watermark)
    wm0 = wm_gate and bool(_occupancy(nf - free, nf) >= high)

    rounds = 0
    while rounds < cfg.max_rounds:
        rate = free - ve < need
        wm = wm0 and bool(_occupancy(nf - free, nf) >= low)
        if not (rate or wm or rounds < n_pol):
            break
        trig = (obs_plane.TRIG_RATE_LIMIT if rate else
                obs_plane.TRIG_WATERMARK if wm else obs_plane.TRIG_POLICY)
        state = _compact1(state, cfg, force_pin_keys, trig)
        rounds += 1
        free, ve = _read(tiers.free_fast_slots(state.tier),
                         state.virtual_extra)
    return state


def maintain(state: EngineState, cfg: EngineConfig, need=0, *,
             force_pin_keys=None, wm_gate: bool = True) -> EngineState:
    """Rate-limit + watermark compactions only (no policy step)."""
    return maintenance(state, cfg, need=need, wm_gate=wm_gate,
                       policy_enable=False, force_pin_keys=force_pin_keys)


def read_policy(state: EngineState, cfg: EngineConfig, *,
                force_pin_keys=None, enable: bool = True) -> EngineState:
    """§5.3 read-triggered policy step + its compaction budget only."""
    return maintenance(state, cfg, need=0, wm_gate=False,
                       policy_enable=enable, force_pin_keys=force_pin_keys)


def _consolidation_tick(state: EngineState, cfg: EngineConfig
                        ) -> EngineState:
    """Full index rebuild every ``consolidate_every`` steps."""
    (steps,) = _read(state.steps)
    if steps % cfg.consolidate_every == cfg.consolidate_every - 1:
        state = state._replace(tier=tiers.consolidate_indexes(state.tier))
    return state


# ------------------------------------------------------------ engine step

def engine_step(state: EngineState, op: OpBatch, cfg: EngineConfig, *,
                force_pin_keys=None, mirror=None
                ) -> tuple[EngineState, OpResult]:
    """One client batch, control plane included.  ``op.kind`` is read on
    the host (it is a host scalar from ``make_op``/``run_ops``); the lanes
    of the other kinds are masked off as in the JAX package.  Payload
    mirrors are not ported yet: ``mirror`` must be None."""
    if mirror is not None:
        raise NotImplementedError(
            "payload mirrors are not ported yet (ROADMAP Queue 1 item 11, "
            "tier_compact B5)")
    kind = int(op.kind)
    is_put, is_get = kind == PUT, kind == GET
    is_del, is_scan = kind == DELETE, kind == SCAN
    dev = op.keys.device
    ctr0 = state.tier.ctr
    n_valid = op.valid.sum(dtype=torch.int32)
    need = n_valid if is_put else 0

    state = maintenance(state, cfg, need=need, wm_gate=True,
                        policy_enable=is_get or is_scan,
                        force_pin_keys=force_pin_keys)
    before = tiers.free_fast_slots(state.tier) if cfg.append_only else None

    tier, gvals, gfound, gsrc = tiers.apply_point_ops(
        state.tier, cfg.tier, op.keys, op.vals, op.valid, is_put=is_put,
        is_get=is_get, is_del=is_del, backend=cfg.backend)
    if is_scan:
        lens = op.aux.clamp(max=cfg.scan_chunk)
        tier, n_live = tiers.scan_batch(tier, cfg.tier, op.keys, lens,
                                        op.valid, chunk=cfg.scan_chunk)
    else:
        n_live = torch.zeros(op.keys.shape, dtype=torch.int32, device=dev)
    state = state._replace(tier=tier)

    if cfg.append_only and is_put:
        fresh = before - tiers.free_fast_slots(tier)
        state = state._replace(virtual_extra=state.virtual_extra
                               + (need - fresh).clamp(min=0))

    state = state._replace(steps=state.steps + 1)
    if cfg.consolidate_every > 0:
        state = _consolidation_tick(state, cfg)

    if cfg.obs.enabled:
        delta = obs_plane.counter_delta(state.tier.ctr, ctr0)
        state = state._replace(obs=obs_plane.record_step(
            state.obs, cfg.obs, kind=kind, n_ops=n_valid, delta=delta))

    if is_get:
        res = OpResult(vals=gvals.to(torch.float32), found=gfound,
                       src=gsrc.to(torch.int32))
    else:
        res = OpResult(
            vals=torch.zeros(op.vals.shape, dtype=torch.float32, device=dev),
            found=(n_live > 0) if is_scan else torch.zeros_like(op.valid),
            src=n_live if is_scan else torch.full_like(n_live, -1))
    return state, res


def run_ops(state: EngineState, ops: OpBatch, cfg: EngineConfig, *,
            force_pin_keys=None, mirror=None) -> tuple[EngineState, OpResult]:
    """Drive a stacked op stream (leading axis = batches) step by step;
    results stack likewise.  The kinds are read to the host once."""
    kinds = [int(k) for k in ops.kind.reshape(-1).tolist()]
    outs = []
    for i, k in enumerate(kinds):
        op = OpBatch(kind=torch.tensor(k, dtype=torch.int32),
                     keys=ops.keys[i], vals=ops.vals[i], valid=ops.valid[i],
                     aux=ops.aux[i])
        state, res = engine_step(state, op, cfg,
                                 force_pin_keys=force_pin_keys, mirror=mirror)
        outs.append(res)
    return state, OpResult(*[torch.stack(x) for x in zip(*outs)])


# ------------------------------------------------- state carried across

_TYPES = {c.__name__: c for c in (EngineState, TierState, TrackerState,
                                  Counters, policy.PolicyState, ObsState)}


def state_from_numpy(tree, cfg: EngineConfig, device=None) -> EngineState:
    """A JAX ``EngineState`` (after ``jax.device_get``: numpy leaves) ->
    the port's state, leaf for leaf: pools, indexes, run directory,
    blooms (uint32 -> int32 bit pattern), tracker, buckets, counters,
    policy, obs, and the rng key words (uint32 -> int64).  Copies every
    leaf, so the engine's in-place updates never reach the source."""
    check_supported(cfg)
    dev = backend_mod.resolve_device(device)

    def conv(x, field=None):
        name = type(x).__name__
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            cls = _TYPES.get(name)
            if cls is None or cls._fields != x._fields:
                raise ValueError(f"cannot carry {name} across")
            return cls(*[conv(getattr(x, f), f) for f in x._fields])
        if isinstance(x, tuple):
            return tuple(conv(v, field) for v in x)
        a = np.asarray(x)
        if field == "rng":
            return torch.from_numpy(a.astype(np.int64))   # host key words
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return conv(tree)


def state_to_numpy(state: EngineState):
    """The port's state -> the same structure with numpy leaves in the
    JAX package's dtypes (rng and blooms back to uint32)."""
    def conv(x, field=None):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[conv(getattr(x, f), f) for f in x._fields])
        if isinstance(x, tuple):
            return tuple(conv(v, field) for v in x)
        a = x.detach().cpu().numpy()
        if field == "rng":
            return a.astype(np.uint32)
        if field == "dir_blooms":
            return a.view(np.uint32)
        return a

    return conv(state)
