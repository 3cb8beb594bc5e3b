"""Device-resident observability state, carried through the engine.

``ObsState`` rides inside ``EngineState`` exactly as in the JAX package:
log2-bucketed histograms of the modeled per-op service cost per op kind,
a ring of per-step counter deltas, and a compaction event ring.  Every
update is a scatter on the device (no host read); the obs tensors of the
state passed in are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.backend import resolve_device
from repro_torch.core.utils import take
from repro_torch.obs.cost import CostModel, compaction_io_us, step_io_us

TICK = 4
N_KINDS = 5
KIND_NAMES = ("put", "get", "delete", "scan", "tick")

TRIG_RATE_LIMIT, TRIG_WATERMARK, TRIG_POLICY = 0, 1, 2
TRIGGER_NAMES = ("rate_limit", "watermark", "policy")

EV_COMMIT, EV_START, EV_RESUME = 0, 1, 2
EVENT_KIND_NAMES = ("commit", "start", "resume")


def timeline_fields(n_tiers: int = 2) -> tuple:
    """Timeline row layout: [kind, n_ops, *flattened Counters deltas]."""
    from repro_torch.core.tiers import Counters
    zeros = Counters.zeros(n_tiers, "meta")   # shapes only
    out = ["kind", "n_ops"]
    for f in Counters._fields:
        leaf = getattr(zeros, f)
        if leaf.dim() == 0:
            out.append(f)
        else:
            out.extend(f"{f}{i}" for i in range(leaf.shape[0]))
    return tuple(out)


class ObsConfig(NamedTuple):
    enabled: bool = True
    n_buckets: int = 32        # bucket b covers (2^(b-1), 2^b] us
    timeline_len: int = 256
    event_len: int = 128
    cost: CostModel = CostModel()
    fast_write_amp: float = 1.0
    n_tiers: int = 2

    @property
    def n_boundaries(self) -> int:
        return self.n_tiers - 1


class ObsState(NamedTuple):
    hist: torch.Tensor          # i32[N_KINDS, n_buckets]
    timeline: torch.Tensor      # i32[timeline_len, len(timeline_fields)]
    t_pos: torch.Tensor         # i32
    ev_step: torch.Tensor       # i32[event_len]
    ev_trigger: torch.Tensor    # i32[event_len]
    ev_score: torch.Tensor      # f32[event_len]
    ev_moved: torch.Tensor      # i32[event_len]
    ev_superseded: torch.Tensor  # i32[event_len]
    ev_io_us: torch.Tensor      # f32[event_len]
    ev_count: torch.Tensor      # i32
    hist_sum: torch.Tensor      # f32[N_KINDS, n_buckets]
    ev_kind: torch.Tensor       # i32[event_len]
    ev_jobs: torch.Tensor       # i32
    ev_boundary: torch.Tensor   # i32[event_len]
    ev_jobs_b: torch.Tensor     # i32[n_boundaries]


def init(cfg: ObsConfig, device=None) -> ObsState:
    device = resolve_device(device)
    e = cfg.event_len
    i = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
    f = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return ObsState(
        hist=i(N_KINDS, cfg.n_buckets),
        timeline=i(cfg.timeline_len, len(timeline_fields(cfg.n_tiers))),
        t_pos=i(), ev_step=i(e), ev_trigger=i(e), ev_score=f(e),
        ev_moved=i(e), ev_superseded=i(e), ev_io_us=f(e), ev_count=i(),
        hist_sum=f(N_KINDS, cfg.n_buckets), ev_kind=i(e), ev_jobs=i(),
        ev_boundary=i(e), ev_jobs_b=i(cfg.n_boundaries))


def bucket_of_us(us: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Log2 bucket of a cost in microseconds: ceil(log2) read off the f32
    bit pattern (integer ops only, as in the JAX package)."""
    us = us.to(torch.float32).clamp(min=1e-6)
    bits = us.view(torch.int32)
    b = (bits >> 23) - 127 + ((bits & 0x7FFFFF) != 0).to(torch.int32)
    return b.clamp(0, n_buckets - 1)


def counter_delta(after, before):
    return type(after)(*[a - b for a, b in zip(after, before)])


def _put(t: torch.Tensor, i: torch.Tensor, v) -> None:
    """t[i] = v for a 0-dim device index (no host read)."""
    if not torch.is_tensor(v):
        v = torch.full((), v, dtype=t.dtype, device=t.device)
    t.index_put_((i.view(1).to(torch.int64),),
                 v.to(t.dtype).view((1,) + t.shape[1:]))


def record_step(obs: ObsState, cfg: ObsConfig, *, kind: int,
                n_ops: torch.Tensor, delta) -> ObsState:
    """Fold one engine step's counter deltas into the histograms and the
    timeline ring (``kind`` is the batch's op kind)."""
    f32 = torch.float32
    n_ops = n_ops.to(torch.int32)
    us = step_io_us(delta, cfg.cost, cfg.fast_write_amp)
    per_op = us / n_ops.to(f32).clamp(min=1.0)
    b = bucket_of_us(per_op, cfg.n_buckets).to(torch.int64).view(1)
    obs.hist[kind].index_add_(0, b, n_ops.view(1))
    obs.hist_sum[kind].index_add_(0, b, (per_op * n_ops.to(f32)).view(1))
    dev = n_ops.device
    row = torch.cat([torch.full((1,), kind, dtype=torch.int32, device=dev),
                     n_ops.view(1)]
                    + [v.to(torch.int32).reshape(-1) for v in delta])
    _put(obs.timeline, obs.t_pos % cfg.timeline_len, row)
    return obs._replace(t_pos=obs.t_pos + 1)


def record_compaction(obs: ObsState, cfg: ObsConfig, *, step: torch.Tensor,
                      trigger: int, stats, kind: int = EV_COMMIT,
                      io_us=None, boundary: int = 0) -> ObsState:
    """Append one compaction job to the event ring and count it in
    ``ev_jobs``.  Run to completion keeps the defaults: one EV_COMMIT per
    job pricing its whole migration.  The quantized path logs the trigger
    as an EV_START with ``io_us=0.0`` (its cost lands on the draining
    steps)."""
    i = obs.ev_count % cfg.event_len
    moved = stats.n_demoted + stats.n_promoted + stats.n_merged
    if io_us is None:
        io_us = compaction_io_us(stats, cfg.cost, cfg.fast_write_amp,
                                 boundary=boundary)
    _put(obs.ev_step, i, step)
    _put(obs.ev_trigger, i, trigger)
    _put(obs.ev_score, i, stats.score)
    _put(obs.ev_moved, i, moved)
    _put(obs.ev_superseded, i, stats.n_superseded)
    _put(obs.ev_io_us, i, io_us)
    _put(obs.ev_kind, i, kind)
    _put(obs.ev_boundary, i, boundary)
    obs.ev_jobs_b[boundary:boundary + 1].add_(1)
    return obs._replace(ev_count=obs.ev_count + 1, ev_jobs=obs.ev_jobs + 1)


def record_drain(obs: ObsState, cfg: ObsConfig, *, step: torch.Tensor,
                 trigger: torch.Tensor, score: torch.Tensor,
                 moved: torch.Tensor, io_us: torch.Tensor,
                 done: torch.Tensor) -> ObsState:
    """Append one drained compaction quantum to the event ring: EV_RESUME
    while the job has backlog left, EV_COMMIT on the quantum that
    finishes it.  With ``moved == 0`` (nothing in flight) every slot is
    rewritten with its own value and ``ev_count`` stays: the ring is
    untouched bit for bit, with no host read."""
    write = moved > 0
    i = obs.ev_count % cfg.event_len
    kind = torch.where(done, EV_COMMIT, EV_RESUME).to(torch.int32)

    def put(t: torch.Tensor, v) -> None:
        if not torch.is_tensor(v):
            v = torch.full((), v, dtype=t.dtype, device=t.device)
        _put(t, i, torch.where(write, v.to(t.dtype), take(t, i)))

    put(obs.ev_step, step)
    put(obs.ev_trigger, trigger)
    put(obs.ev_score, score)
    put(obs.ev_moved, moved)
    put(obs.ev_superseded, 0)
    put(obs.ev_io_us, io_us)
    put(obs.ev_kind, kind)
    put(obs.ev_boundary, 0)
    return obs._replace(ev_count=obs.ev_count + write.to(torch.int32))
