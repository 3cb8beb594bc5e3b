"""Op-stream sampler on ``jax.random``'s bits (``core.prng``), the port's
copy of the JAX package's ``workloads/sampler.py``.

The zipfian is a bounded inverse-CDF sampler over ranks ``[0, N)``; ranks
are scrambled into keys with a Knuth multiplicative hash so popularity is
not correlated with key order, and ``hot_offset`` rotates ranks before
scrambling, which moves the whole hot set to other keys.

Generation runs on the host, one batch at a time, with the JAX package's
key order: a batch's key splits three ways (kind, keys, scan lengths),
the key draw two ways (uniform keys, zipf uniforms).  Only the
distribution a batch selects is drawn (the JAX package draws all four
and selects one; the others' bits come from keys of their own, so the
stream is the same).  The finished keys and scan lengths reach the
device in one copy.  UNIFORM and SEQ keys, op kinds, scan lengths and
the insert pointer are bit-equal to the JAX package's; ZIPF and LATEST
ranks go through float32 ``pow``, which torch and XLA can round one ulp
apart, so a rank can differ by one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine, prng
from repro_torch.core.backend import resolve_device
from repro_torch.core.utils import M32, mul32
from repro_torch.workloads.spec import (LATEST, SEQ, UNIFORM, ZIPF,
                                        GenState, WorkloadSpec)

SCRAMBLE_MUL = 2654435761       # Knuth multiplicative constant


def _scalar(x):
    """A spec field as a Python number (fields are Python scalars or 0-d
    CPU tensors)."""
    return x.item() if torch.is_tensor(x) else x


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with the int32 wraparound of the JAX package."""
    return (((x + 2**31) & M32) - 2**31).to(torch.int32)


def zipf_ranks(u: torch.Tensor, n: int, theta) -> torch.Tensor:
    """Bounded inverse-CDF zipfian ranks in ``[0, n)`` from float32
    uniforms ``u``: P(rank = r) = ((r+2)^(1-t) - (r+1)^(1-t)) /
    (n^(1-t) - 1), theta clamped away from the singularity at 1 (float32
    throughout, in the JAX package's operation order)."""
    f32 = torch.float32
    t = torch.as_tensor(_scalar(theta), dtype=f32).clamp(min=1e-3)
    t = torch.where((t - 1.0).abs() < 1e-4, t + 2e-4, t)
    c = torch.pow(torch.tensor(n, dtype=f32), 1.0 - t)
    inv = torch.div(torch.ones((), dtype=f32), 1.0 - t)
    ranks = torch.pow((c - 1.0) * u.to(f32) + 1.0, inv) - 1.0
    return ranks.clamp(0, n - 1).to(torch.int32)


def scramble(ranks: torch.Tensor, offset, key_space: int) -> torch.Tensor:
    """Rank -> key via multiplicative scrambling (uint32 wraparound, in
    int64 with ``& 0xFFFFFFFF``)."""
    x = (ranks.to(torch.int64) + int(_scalar(offset))) & M32
    return (mul32(x, SCRAMBLE_MUL) % key_space).to(torch.int32)


def sample_keys(key: torch.Tensor, dist, theta, hot_offset, ptr: int,
                batch: int, key_space: int) -> tuple[torch.Tensor, int]:
    """One batch of int32 keys (on the CPU) under a distribution code.
    Returns ``(keys, ptr')``; the insert pointer advances only on SEQ."""
    dist, ptr = int(_scalar(dist)), int(ptr)
    ku, kz = prng.split(key, 2)
    if dist == UNIFORM:
        keys = prng.randint(ku, (batch,), 0, key_space, device="cpu")
    elif dist in (ZIPF, LATEST):
        ranks = zipf_ranks(prng.uniform(kz, (batch,)), key_space, theta)
        if dist == ZIPF:
            keys = scramble(ranks, hot_offset, key_space)
        else:
            keys = torch.remainder(ptr - 1 - ranks.to(torch.int64),
                                   key_space).to(torch.int32)
    else:
        seq = _i32(ptr + torch.arange(batch, dtype=torch.int64))
        keys = torch.remainder(seq.to(torch.int64), key_space).to(
            torch.int32)
    if dist == SEQ:
        ptr = int(_i32(torch.tensor(ptr + batch)))
    return keys, ptr


def sample_batch(key: torch.Tensor, sp: WorkloadSpec, gst: GenState, *,
                 batch: int, key_space: int, value_width: int,
                 device=None) -> tuple[GenState, engine.OpBatch]:
    """One ``OpBatch`` drawn from the spec: the op kind from one float32
    uniform against the cumulative (get, put, delete) mass, the keys, and
    scan lengths ``1 + randint(0, max(scan_len, 1))``.  The keys and
    lengths go to ``device`` (None: the card) in one copy; the kind stays
    a host scalar, as ``engine.make_op`` leaves it."""
    dev = resolve_device(device)
    kop, kkey, klen = prng.split(key, 3)
    u = np.float32(prng.uniform(kop, ()).item())
    cg = np.float32(_scalar(sp.p_get))
    cp = cg + np.float32(_scalar(sp.p_put))
    cd = cp + np.float32(_scalar(sp.p_del))
    kind = (engine.GET if u < cg else engine.PUT if u < cp else
            engine.DELETE if u < cd else engine.SCAN)
    is_write = kind in (engine.PUT, engine.DELETE)
    keys, ptr = sample_keys(kkey, sp.wdist if is_write else sp.dist,
                            sp.wtheta if is_write else sp.theta,
                            sp.hot_offset, gst.ptr, batch, key_space)
    if kind == engine.SCAN:
        hi = max(int(_scalar(sp.scan_len)), 1)
        aux = 1 + prng.randint(klen, (batch,), 0, hi, device="cpu")
    else:
        aux = torch.zeros(batch, dtype=torch.int32)
    both = torch.stack([keys, aux.to(torch.int32)]).to(dev)
    keys, aux = both[0], both[1]
    op = engine.OpBatch(
        kind=torch.tensor(kind, dtype=torch.int32), keys=keys,
        vals=keys[:, None].to(torch.float32).expand(batch, value_width),
        valid=torch.ones(batch, dtype=torch.bool, device=dev), aux=aux)
    return GenState(ptr=ptr), op


def sample_ops(key: torch.Tensor, work, n: int, batch: int, *,
               key_space: int, value_width: int,
               gst: GenState | None = None, t0: int = 0, device=None
               ) -> tuple[engine.OpBatch, GenState]:
    """Stacked op stream (leading axis = n batches) for a spec or a
    ``PhaseSchedule``, the format ``engine.run_ops`` consumes: each step
    splits the carried key ``r`` into ``(r, k)`` and draws its batch from
    ``k`` under the spec of step ``t0 + i``.  ``kind`` is a CPU tensor."""
    from repro_torch.workloads.schedule import as_schedule, spec_at
    sched = as_schedule(work, n)
    if gst is None:
        gst = GenState(ptr=key_space // 2)
    r, ops = key, []
    for t in range(int(t0), int(t0) + n):
        r, k = prng.split(r, 2)
        gst, op = sample_batch(k, spec_at(sched, t), gst, batch=batch,
                               key_space=key_space, value_width=value_width,
                               device=device)
        ops.append(op)
    return engine.OpBatch(*[torch.stack(x) for x in zip(*ops)]), gst
