"""Row-mover wrappers with backend dispatch (kernels B3 select_gather_rows,
B4 scatter_rows and B5 gather_rows, ``csrc/tier_compact.cu``), and the
Movement replay built on them, at a tier pair or at one boundary of a
tier list (the JAX package's ``kernels/tier_compact/ops.py``).

Each launch wrapper validates its tensors, launches its kernel on the
current stream and adds one to its ``LAUNCHES`` key; ``movers`` picks the
kernels for CUDA tensors under backend "cuda" and the plain versions of
``ref.py`` for backend "reference" or CPU tensors.  ``scatter_rows``
writes the pool in place, and so does the Movement replay: it consumes
the pools it is given, as the engine consumes its state.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import backend as backend_mod
from repro_torch.kernels import build
from repro_torch.kernels.tier_compact.ref import (gather_rows_ref,
                                                  scatter_rows_ref,
                                                  select_gather_rows_ref)


def _lib() -> ctypes.CDLL:
    lib = build.load("tier_compact")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gather_rows_launch.argtypes = [p, i64, p, i, i64, p, p]
    lib.select_gather_rows_launch.argtypes = [p, i64, p, i64, p, p, i, i64,
                                              p, p]
    lib.scatter_rows_launch.argtypes = [p, i64, p, p, p, i, i64, p]
    for fn in (lib.gather_rows_launch, lib.select_gather_rows_launch,
               lib.scatter_rows_launch):
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, dev: torch.device, *specs) -> None:
    """Raise unless every (label, tensor, dtype, dims) lies on ``dev``,
    contiguous, with that dtype (None: any) and number of dims."""
    for label, x, dtype, dims in specs:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name}: {label} must be on {dev} (a CUDA "
                             "device)")
        if (dtype is not None and x.dtype != dtype) or x.dim() != dims \
                or not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous "
                             f"{dims}-d {dtype or 'pool'} tensor")


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    kernels.LAUNCHES[name] += 1


def _row_bytes(pool: torch.Tensor) -> int:
    return pool.shape[1] * pool.element_size()


def gather_rows(pool: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch B5: ``out[i] = pool[clamp(idx[i], 0, P - 1)]`` -> [M, W]."""
    m = idx.shape[0]
    _check("gather_rows", pool.device, ("pool", pool, None, 2),
           ("idx", idx, torch.int32, 1))
    out = torch.empty((m, pool.shape[1]), dtype=pool.dtype,
                      device=pool.device)
    if m and pool.shape[1]:
        _launched("gather_rows", _lib().gather_rows_launch(
            pool.data_ptr(), pool.shape[0], idx.data_ptr(), m,
            _row_bytes(pool), out.data_ptr(),
            torch.cuda.current_stream(pool.device).cuda_stream))
    return out


def select_gather_rows(fast_pool: torch.Tensor, slow_pool: torch.Tensor,
                       src_slow: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    """Launch B3: ``out[i] = (slow if src_slow[i] else fast)[idx[i]]``,
    one read per row from its own pool -> [M, W]."""
    m = idx.shape[0]
    dev = fast_pool.device
    _check("select_gather_rows", dev, ("fast_pool", fast_pool, None, 2),
           ("slow_pool", slow_pool, fast_pool.dtype, 2),
           ("src_slow", src_slow, torch.bool, 1),
           ("idx", idx, torch.int32, 1))
    if slow_pool.shape[1] != fast_pool.shape[1] or src_slow.shape[0] != m:
        raise ValueError("select_gather_rows: shape mismatch")
    out = torch.empty((m, fast_pool.shape[1]), dtype=fast_pool.dtype,
                      device=dev)
    if m and fast_pool.shape[1]:
        _launched("select_gather_rows", _lib().select_gather_rows_launch(
            fast_pool.data_ptr(), fast_pool.shape[0], slow_pool.data_ptr(),
            slow_pool.shape[0], src_slow.data_ptr(), idx.data_ptr(), m,
            _row_bytes(fast_pool), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream))
    return out


def scatter_rows(pool: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Launch B4: ``pool[idx[i]] = rows[i]`` where ``valid[i]``, in place
    (valid destinations unique; out-of-range ones write nothing).
    Returns ``pool``."""
    m = idx.shape[0]
    _check("scatter_rows", pool.device, ("pool", pool, None, 2),
           ("idx", idx, torch.int32, 1), ("rows", rows, pool.dtype, 2),
           ("valid", valid, torch.bool, 1))
    if rows.shape != (m, pool.shape[1]) or valid.shape[0] != m:
        raise ValueError("scatter_rows: shape mismatch")
    if m and pool.shape[1]:
        _launched("scatter_rows", _lib().scatter_rows_launch(
            pool.data_ptr(), pool.shape[0], idx.data_ptr(), rows.data_ptr(),
            valid.data_ptr(), m, _row_bytes(pool),
            torch.cuda.current_stream(pool.device).cuda_stream))
    return pool


def movers(backend: str, like: torch.Tensor):
    """(select_gather, gather, scatter) for ``backend`` on ``like``'s
    device: the kernels (indices cast to contiguous int32) for backend
    "cuda" on a CUDA tensor, else the plain versions."""
    if not backend_mod.use_kernel(backend, like):
        return select_gather_rows_ref, gather_rows_ref, scatter_rows_ref
    i32 = lambda x: x.to(torch.int32).contiguous()
    return (lambda f, s, sl, i: select_gather_rows(f, s, sl.contiguous(),
                                                   i32(i)),
            lambda p, i: gather_rows(p, i32(i)),
            lambda p, i, r, v: scatter_rows(p, i32(i), r.contiguous(),
                                            v.contiguous()))


def apply_movement_rows(fast_pool: torch.Tensor, slow_pool: torch.Tensor,
                        mv, *, backend: str = "cuda"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Replay a compaction Movement on flat row pools [P, W], in place:
    gather the merged sources (each row once, from its own pool), gather
    the promotions from their ORIGINAL slow slots, then write the new run
    into the slow pool and the promotions into the fast pool.  Both
    gathers come before the first scatter, on one stream: the run write
    may recycle a promotion's source slot.  Returns (fast', slow')."""
    sel, gather, scatter = movers(backend, fast_pool)
    nf, ns = fast_pool.shape[0], slow_pool.shape[0]
    src_slow = mv.m_src_tier != 0
    idx = torch.where(src_slow, mv.m_src_slot.clamp(0, ns - 1),
                      mv.m_src_slot.clamp(0, nf - 1))
    rows = sel(fast_pool, slow_pool, src_slow, idx)
    pro = gather(slow_pool, mv.p_src_slot.clamp(0, ns - 1))
    slow_pool = scatter(slow_pool, mv.m_dst_slot, rows, mv.m_valid)
    fast_pool = scatter(fast_pool, mv.p_dst_slot, pro, mv.p_valid)
    return fast_pool, slow_pool


def apply_movement_pools(fast: torch.Tensor, slow: torch.Tensor, mv, *,
                         pool_axis: int = 0, backend: str = "cuda"
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``apply_movement_rows`` for payloads of any rank whose pool (slot)
    dimension sits at ``pool_axis`` (the paged-KV layout [L, P, ...] has
    pool_axis=1): each object's payload is flattened into one row for the
    movers and the result restored to the input layout.  Returns the
    updated pools; with a leading contiguous pool axis the rows are views
    and the inputs are updated in place."""
    def to_rows(x):
        x = torch.movedim(x, pool_axis, 0)
        return x.reshape(x.shape[0], -1), x.shape

    def from_rows(rows, shape):
        return torch.movedim(rows.reshape(shape), 0, pool_axis)

    frows, fshape = to_rows(fast)
    srows, sshape = to_rows(slow)
    frows, srows = apply_movement_rows(frows.contiguous(), srows.contiguous(),
                                       mv, backend=backend)
    return from_rows(frows, fshape), from_rows(srows, sshape)


def apply_movement_boundary(pools, mv, boundary: int = 0, *,
                            backend: str = "cuda") -> list:
    """Replay a Movement at one boundary of an N-tier pool list: ``pools``
    holds flat per-tier row pools [P_t, W] (hottest first), and the pair
    movers run on ``(pools[boundary], pools[boundary + 1])``, in place.
    The Movement's ``m_src_tier`` holds tier indices as ``compact_once``
    and ``compact_boundary`` emit them (the boundary's upper tier ==
    ``boundary``); a row comes from the upper pool exactly where its tier
    is ``boundary``.  Returns the list with those two entries replaced;
    at ``boundary=0`` on a two-entry list this is
    ``apply_movement_rows``."""
    pools = list(pools)
    rel = mv._replace(m_src_tier=(mv.m_src_tier != boundary).to(
        mv.m_src_tier.dtype))
    pools[boundary], pools[boundary + 1] = apply_movement_rows(
        pools[boundary], pools[boundary + 1], rel, backend=backend)
    return pools
