"""Tracker-update wrapper with backend dispatch (kernel B1, clock_update).

``tracker_access`` launches ``csrc/clock_update.cu`` for CUDA tensors and
takes the plain version, ``tracker.access_batched``, for CPU tensors or
backend "reference".  The kernel updates the tracker tables IN PLACE and
returns the same TrackerState; the plain version returns new tables.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import backend as backend_mod
from repro_torch.core import tracker
from repro_torch.kernels import build

_SCRATCH: dict = {}   # (device, capacity) -> (last_cand, last_hit), all -1


def _lib() -> ctypes.CDLL:
    lib = build.load("clock_update")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.clock_update_launch.argtypes = [p, p, p, p, i, p, p, p, i, p, p, p]
    lib.clock_update_launch.restype = ctypes.c_int
    return lib


def occurrences(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-access count of its key in the batch (sort + segment sums)."""
    return tracker.occ_large(torch.where(valid, keys, -1), valid)


def clock_update(state: tracker.TrackerState, keys: torch.Tensor,
                 locs: torch.Tensor, valid: torch.Tensor
                 ) -> tracker.TrackerState:
    """Launch the clock_update kernel: applies one access batch to the
    tracker tables in place (same result as ``access_batched``)."""
    tk, tc, tl = state
    t, b = tk.shape[0], keys.shape[0]
    for name, x, dt in (("keys", keys, torch.int32), ("locs", locs, torch.int8),
                        ("valid", valid, torch.bool),
                        ("tracker.keys", tk, torch.int32),
                        ("tracker.clock", tc, torch.int8),
                        ("tracker.loc", tl, torch.int8)):
        if x.device.type != "cuda" or x.device != tk.device:
            raise ValueError(f"clock_update: {name} must be on {tk.device}")
        if x.dtype != dt or x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"clock_update: {name} must be a contiguous "
                             f"1-d {dt} tensor")
    if locs.shape[0] != b or valid.shape[0] != b or tc.shape[0] != t \
            or tl.shape[0] != t or not 0 < t < 2**31:
        raise ValueError("clock_update: shape mismatch")
    occ = occurrences(keys, valid).contiguous()
    key = (tk.device, t)
    if key not in _SCRATCH:
        _SCRATCH[key] = (torch.full((t,), -1, dtype=torch.int32,
                                    device=tk.device),
                         torch.full((t,), -1, dtype=torch.int32,
                                    device=tk.device))
    last_cand, last_hit = _SCRATCH[key]
    stream = torch.cuda.current_stream(tk.device).cuda_stream
    rc = _lib().clock_update_launch(
        keys.data_ptr(), occ.data_ptr(), locs.data_ptr(), valid.data_ptr(),
        b, tk.data_ptr(), tc.data_ptr(), tl.data_ptr(), t,
        last_cand.data_ptr(), last_hit.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"clock_update launch failed: cudaError {rc}")
    kernels.LAUNCHES["clock_update"] += 1
    return state


def tracker_access(state: tracker.TrackerState, keys: torch.Tensor,
                   locs: torch.Tensor, valid: torch.Tensor, *,
                   backend: str = "cuda") -> tracker.TrackerState:
    if backend_mod.use_kernel(backend, keys):
        return clock_update(state, keys.to(torch.int32).contiguous(),
                            locs.to(torch.int8).contiguous(),
                            valid.contiguous())
    return tracker.access_batched(state, keys, locs, valid)
