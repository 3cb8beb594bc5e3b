"""WorkloadSpec: a description of an op mix and its key distributions
(the port's copy of the JAX package's ``workloads/spec.py``).

A spec's fields are Python scalars, or 0-d tensors where a
``PhaseSchedule`` hands out the phase of a step; generation runs on the
host, so no field is ever read back from the card.  Static knobs (batch
size, key space) stay outside the spec, on the call.

Op mix is batch-granular, like the paper's YCSB driver: each generated
batch is entirely one op kind, drawn from ``(p_get, p_put, p_del,
p_scan)``.  Key distributions (read side and write side independently):

  UNIFORM   uniform over ``[0, key_space)``
  ZIPF      bounded inverse-CDF zipfian over ranks, multiplicative rank
            scrambling (+ ``hot_offset`` rotates WHICH keys are hot)
  LATEST    zipfian over recency behind the insert pointer (YCSB-D reads)
  SEQ       sequential inserts at the pointer (YCSB-D/E writes); the
            pointer lives in ``GenState`` and advances on use
"""
from __future__ import annotations

from typing import NamedTuple

UNIFORM, ZIPF, LATEST, SEQ = 0, 1, 2, 3

_DIST = {"uniform": UNIFORM, "zipf": ZIPF, "latest": LATEST, "seq": SEQ}


class WorkloadSpec(NamedTuple):
    """Op mix + key-distribution parameters (float32 probabilities and
    exponents, int32 codes, as in the JAX package)."""
    p_get: float            # P(batch is point reads)
    p_put: float            # P(batch is writes)
    p_del: float            # P(batch is deletes)
    p_scan: float           # P(batch is range scans)
    dist: int               # read/scan-start key distribution
    theta: float            # zipf exponent for ``dist``
    wdist: int              # put/delete key distribution
    wtheta: float           # zipf exponent for ``wdist``
    hot_offset: int         # rank-scramble rotation (hot-set shift)
    scan_len: int           # max keys per scan lane


class GenState(NamedTuple):
    """Generator state threaded through sampling: the int32 insert
    pointer for LATEST reads / SEQ writes."""
    ptr: int


def init_gen(key_space: int) -> GenState:
    return GenState(ptr=key_space // 2)


def spec(*, read: float = 0.5, delete: float = 0.0, scan: float = 0.0,
         put: float | None = None, dist: str = "zipf", theta: float = 0.99,
         wdist: str | None = None, wtheta: float | None = None,
         hot_offset: int = 0, scan_len: int = 16) -> WorkloadSpec:
    """Build a WorkloadSpec from python knobs.  ``put`` defaults to the
    remaining probability mass; the write distribution defaults to the
    read one (``"latest"`` reads default to ``"seq"`` writes, YCSB-D
    style); a zipf exponent of 0 is the uniform distribution."""
    if put is None:
        put = 1.0 - read - delete - scan
    if put < -1e-6:
        raise ValueError(f"read + delete + scan exceed 1: "
                         f"{(read, delete, scan)}")
    if dist == "zipf" and theta == 0.0:
        dist = "uniform"
    if wdist is None:
        wdist = "seq" if dist == "latest" else dist
    if wtheta is None:
        wtheta = theta
    if wdist == "zipf" and wtheta == 0.0:
        wdist = "uniform"
    return WorkloadSpec(
        p_get=float(read), p_put=float(max(put, 0.0)), p_del=float(delete),
        p_scan=float(scan), dist=_DIST[dist], theta=float(theta),
        wdist=_DIST[wdist], wtheta=float(wtheta), hot_offset=int(hot_offset),
        scan_len=int(scan_len))
