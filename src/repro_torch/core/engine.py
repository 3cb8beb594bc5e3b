"""The engine step: one client batch with its whole control plane.

A port of the JAX package's ``core/engine.py``.  ``engine_step`` runs
the maintenance loop (§4.2 rate limit, watermark hysteresis, §5.3 read
policy; with more than two tiers each deep boundary's hysteresis,
``_deep_tick``), then, with ``compaction_quantum > 0``,
one drained quantum of the in-flight migration (``drain_tick``), the
masked put/get/delete pass, the scan lane and the obs record.  A
``mirror(payload, movement) -> payload`` replays every compaction's
Movement on the payload pools of ``EngineState.payload`` (the embedding
row store) at commit.

The JAX package keeps the maintenance loop on the device
(``lax.while_loop``).  Here it is a Python loop bounded by
``max_rounds`` whose condition is read back with one host read per round
(plus one per step for the loop's inputs); so are the deep boundaries'
loops (one read at entry and one per deep merge), in the JAX package's
order of loops and recursion.  Every such read is counted in
``HOST_READS``.  ``run_ops`` is a Python loop over a stacked op stream.

State tensors are updated in place where that saves a pool-sized copy
(see ``tiers`` and ``compaction``): ``engine_step`` consumes the state
it is given, as the JAX engine's donated buffers are.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import backend as backend_mod
from repro_torch.core import compaction, policy, prng, tiers
from repro_torch.core.tiers import (Counters, TierConfig, TierState,
                                    TrackerState)
from repro_torch.obs import state as obs_plane
from repro_torch.obs.cost import drain_io_us
from repro_torch.obs.state import ObsConfig, ObsState

PUT, GET, DELETE, SCAN = 0, 1, 2, 3

MirrorFn = Callable[[Any, compaction.Movement], Any]


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
    payload: Any = ()           # pytree mirrored through compactions
    obs: Any = ()               # ObsState when cfg.obs.enabled, else ()
    comp: Any = ()              # compaction.InFlight when
                                # cfg.compaction_quantum > 0, else ()


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
    """Raise for configurations the port does not run."""
    backend_mod.check(cfg.backend)
    if cfg.tier.n_tiers < 2:
        raise ValueError("a tier list needs at least two tiers")


def dealias(tree):
    """A copy of ``tree`` with every tensor leaf in its own buffer (the
    engine updates its state in place, so a held view would change)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[dealias(x) for x in tree])
    if isinstance(tree, tuple):
        return tuple(dealias(x) for x in tree)
    return tree.clone() if torch.is_tensor(tree) else tree


def init(cfg: EngineConfig, rng: torch.Tensor, payload: Any = (),
         tier: TierState | None = None, device=None) -> EngineState:
    """A fresh engine state on ``device`` (None: the card; raises without
    one).  ``rng`` is a host key from ``prng.PRNGKey``; ``payload`` is
    mirrored through compactions; ``tier`` replaces the empty tier state
    (it must lie on ``device``)."""
    check_supported(cfg)
    dev = backend_mod.resolve_device(device)
    return EngineState(
        tier=tier if tier is not None else tiers.init(cfg.tier, dev),
        pol=policy.init(dev), rng=rng.cpu(),
        virtual_extra=torch.zeros((), dtype=torch.int32, device=dev),
        steps=torch.zeros((), dtype=torch.int32, device=dev),
        payload=payload,
        obs=obs_plane.init(cfg.obs, dev) if cfg.obs.enabled else (),
        comp=(compaction.init_inflight(cfg.tier, dev)
              if cfg.compaction_quantum > 0 else ()))


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

def _compact1(state: EngineState, cfg: EngineConfig,
              mirror: MirrorFn | None, force_pin_keys,
              trigger: int) -> EngineState:
    """One compaction + payload mirroring + append-only fill accounting
    + one obs event.  With ``cfg.compaction_quantum > 0`` the logical
    transition still commits here, the Movement rows and I/O categories
    are staged into the in-flight carry, and the event is an EV_START
    with zero ``io_us``: the cost lands on the draining steps."""
    quantized = cfg.compaction_quantum > 0
    want_mv = quantized or mirror is not None
    rng, sub = prng.split(state.rng, 2)
    out = compaction.compact_once(
        state.tier, cfg.tier, sub, promote=cfg.promote, precise=cfg.precise,
        selection=cfg.selection, pin_mode=cfg.pin_mode,
        force_pin_keys=force_pin_keys, backend=cfg.backend,
        with_movement=want_mv)
    tier, stats = out[:2]
    payload, comp = state.payload, state.comp
    if mirror is not None:
        # mirrors replay at commit, not per quantum: a later step may
        # recycle the source slots
        payload = mirror(payload, out[2])
    if quantized:
        comp = compaction.stage_inflight(comp, stats, out[2], trigger)
    ve = state.virtual_extra
    if cfg.append_only:
        ve = (ve - stats.n_superseded).clamp(min=0)
    obs = state.obs
    if cfg.obs.enabled:
        start = dict(kind=obs_plane.EV_START, io_us=0.0) if quantized else {}
        obs = obs_plane.record_compaction(obs, cfg.obs, step=state.steps,
                                          trigger=trigger, stats=stats,
                                          **start)
    return state._replace(tier=tier, rng=rng, virtual_extra=ve,
                          payload=payload, obs=obs, comp=comp)


def _occupancy(used: int, n: int) -> np.float32:
    """float32 occupancy, computed as the JAX package does on device."""
    return np.float32(used) / np.float32(n)


def _deep_tick(state: EngineState, cfg: EngineConfig, boundary: int,
               wm_gate: bool, need: int = 0) -> EngineState:
    """Watermark hysteresis at one deep (run-to-run) boundary >= 1: while
    tier ``boundary`` sits above the high watermark, migrate its best run
    down into tier ``boundary + 1`` until it falls below the low one
    (bounded by ``max_rounds``, and only while a run exists to migrate).
    ``need`` also drains until the tier has that many free slots: free
    slots are hard capacity, a merge landing in a full middle tier drops
    rows, so the maintenance loop pre-drains each tier's worst-case
    single-merge inflow.  Before each merge a receiving middle tier is
    given the same headroom first (the recursion ends at the last
    boundary).  Deep merges move run rows wholesale: no mirror, no
    policy, no in-flight carry.  One host read at entry and one per
    merge."""
    if not wm_gate and need <= 0:
        return state
    n = state.tier.keys[boundary].shape[0]
    high = np.float32(cfg.tier.high_watermark)
    low = np.float32(cfg.tier.low_watermark)

    def read(s):
        k = s.tier.keys[boundary]
        return _read((k >= 0).sum(dtype=torch.int32),
                     s.tier.dir_active[boundary - 1].any())

    used, can = read(state)
    wm0 = wm_gate and bool(_occupancy(used, n) >= high)
    rounds = 0
    while rounds < cfg.max_rounds and can and (
            (wm0 and not bool(_occupancy(used, n) < low))
            or n - used < need):
        if boundary + 1 < cfg.tier.n_tiers - 1:
            state = _deep_tick(state, cfg, boundary + 1, True,
                               need=2 * cfg.tier.run_size)
        tier, stats = compaction.compact_boundary(
            state.tier, cfg.tier, boundary, cost=cfg.obs.cost)
        state = state._replace(tier=tier)
        if cfg.obs.enabled:
            state = state._replace(obs=obs_plane.record_compaction(
                state.obs, cfg.obs, step=state.steps,
                trigger=obs_plane.TRIG_WATERMARK, stats=stats,
                boundary=boundary))
        rounds += 1
        used, can = read(state)
    return state


def maintenance(state: EngineState, cfg: EngineConfig, *, need=0,
                wm_gate: bool = True, policy_enable: bool = True,
                mirror: MirrorFn | None = None,
                force_pin_keys=None) -> EngineState:
    """The maintenance plane as one loop bounded by ``cfg.max_rounds``:
    compact while usable fast slots are below ``need`` (§4.2 rate
    limit), while the watermark trigger armed at entry holds the fast
    tier above the low watermark, and for the §5.3 policy budget.
    One host read at entry and one per compaction round.  With more than
    two tiers, each round first pre-drains the deep boundaries, deepest
    first, to a merge's worth of free slots, and after the loop the deep
    boundaries cascade from the top down."""
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
        for b in range(cfg.tier.n_tiers - 2, 0, -1):
            state = _deep_tick(state, cfg, b, True,
                               need=2 * cfg.tier.run_size)
        state = _compact1(state, cfg, mirror, force_pin_keys, trig)
        rounds += 1
        free, ve = _read(tiers.free_fast_slots(state.tier),
                         state.virtual_extra)
    for b in range(1, cfg.tier.n_tiers - 1):
        state = _deep_tick(state, cfg, b, wm_gate)
    return state


def maintain(state: EngineState, cfg: EngineConfig, need=0, *,
             mirror: MirrorFn | None = None, force_pin_keys=None,
             wm_gate: bool = True) -> EngineState:
    """Rate-limit + watermark compactions only (no policy step)."""
    return maintenance(state, cfg, need=need, wm_gate=wm_gate,
                       policy_enable=False, mirror=mirror,
                       force_pin_keys=force_pin_keys)


def read_policy(state: EngineState, cfg: EngineConfig, *,
                mirror: MirrorFn | None = None, force_pin_keys=None,
                enable: bool = True) -> EngineState:
    """§5.3 read-triggered policy step + its compaction budget only."""
    return maintenance(state, cfg, need=0, wm_gate=False,
                       policy_enable=enable, mirror=mirror,
                       force_pin_keys=force_pin_keys)


def drain_tick(state: EngineState, cfg: EngineConfig) -> EngineState:
    """Drain one compaction quantum from the in-flight carry and log the
    resume/commit event; nothing when the quantum knob is off.  Runs on
    every engine step, right behind the maintenance loop, with no host
    read: on a step with nothing in flight it changes no leaf (see
    ``compaction.drain_quantum``; ``record_drain`` writes nothing when
    nothing moved), where the JAX package gates it with a count-gated
    ``while_loop``."""
    if cfg.compaction_quantum <= 0:
        return state
    fl0 = state.comp
    tier, fl, drained, k = compaction.drain_quantum(
        state.tier, fl0, cfg.compaction_quantum, backend=cfg.backend)
    state = state._replace(tier=tier, comp=fl)
    if cfg.obs.enabled:
        state = state._replace(obs=obs_plane.record_drain(
            state.obs, cfg.obs, step=state.steps, trigger=fl0.trigger,
            score=fl0.score, moved=k,
            io_us=drain_io_us(*drained, cfg.obs.cost,
                              cfg.obs.fast_write_amp),
            done=(fl0.rem_rows > 0) & (fl.rem_rows == 0)))
    return state


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
    of the other kinds are masked off as in the JAX package.  ``mirror``
    replays each compaction's Movement on ``state.payload`` at commit;
    with ``compaction_quantum > 0`` one quantum drains right behind the
    maintenance loop and gets inside the in-flight range are served by
    ``compaction.inflight_read``."""
    kind = int(op.kind)
    is_put, is_get = kind == PUT, kind == GET
    is_del, is_scan = kind == DELETE, kind == SCAN
    dev = op.keys.device
    ctr0 = state.tier.ctr
    comp0 = state.comp     # carry baseline for the obs cost deferral
    n_valid = op.valid.sum(dtype=torch.int32)
    need = n_valid if is_put else 0

    state = maintenance(state, cfg, need=need, wm_gate=True,
                        policy_enable=is_get or is_scan, mirror=mirror,
                        force_pin_keys=force_pin_keys)
    state = drain_tick(state, cfg)
    before = tiers.free_fast_slots(state.tier) if cfg.append_only else None

    tier, gvals, gfound, gsrc = tiers.apply_point_ops(
        state.tier, cfg.tier, op.keys, op.vals, op.valid, is_put=is_put,
        is_get=is_get, is_del=is_del, backend=cfg.backend)
    if cfg.compaction_quantum > 0 and is_get:
        gvals = compaction.inflight_read(tier, state.comp, op.keys, gvals,
                                         gfound, gsrc)
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
        if cfg.compaction_quantum > 0:
            delta = compaction.defer_adjust(delta, comp0, state.comp)
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
                                  Counters, policy.PolicyState, ObsState,
                                  compaction.InFlight)}


def state_from_numpy(tree, cfg: EngineConfig, device=None,
                     payload_types=()) -> EngineState:
    """A JAX ``EngineState`` (after ``jax.device_get``: numpy leaves) ->
    the port's state, leaf for leaf: pools, indexes, run directory,
    blooms (uint32 -> int32 bit pattern), tracker, buckets, counters,
    policy, obs, the in-flight carry, and the rng key words (uint32 ->
    int64).  A payload's NamedTuple classes come in ``payload_types``
    (the embedding store's: ``(embedding_store.EmbedStoreState,)``, the
    paged-KV cache's: ``(paged_kv.PagedKVState,)``; bfloat16 page pools
    come across bit for bit).
    Copies every leaf, so the engine's in-place updates never reach the
    source."""
    check_supported(cfg)
    dev = backend_mod.resolve_device(device)
    types = dict(_TYPES, **{c.__name__: c for c in payload_types})

    def conv(x, field=None):
        name = type(x).__name__
        if x is None:
            return None
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            cls = types.get(name)
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
        if a.dtype.name == "bfloat16":    # ml_dtypes' bfloat16 (page pools)
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return conv(tree)


def state_to_numpy(state: EngineState):
    """The port's state -> the same structure with numpy leaves in the
    JAX package's dtypes (rng and blooms back to uint32)."""
    def conv(x, field=None):
        if x is None:
            return None
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*[conv(getattr(x, f), f) for f in x._fields])
        if isinstance(x, tuple):
            return tuple(conv(v, field) for v in x)
        if x.dtype == torch.bfloat16:
            import ml_dtypes    # the JAX package's bfloat16 numpy dtype
            return x.detach().cpu().view(torch.int16).numpy().view(
                ml_dtypes.bfloat16)
        a = x.detach().cpu().numpy()
        if field == "rng":
            return a.astype(np.uint32)
        if field == "dir_blooms":
            return a.view(np.uint32)
        return a

    return conv(state)
