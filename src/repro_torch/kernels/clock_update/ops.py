"""Tracker-update wrapper with backend dispatch (kernel B1, clock_update).

``tracker_access`` launches ``csrc/clock_update.cu`` for CUDA tensors and
takes the plain version, ``tracker.access_batched``, for CPU tensors or
backend "reference".  The kernel updates the tracker tables IN PLACE and
returns the same TrackerState; the plain version returns new tables.
``ref.clock_update_passes`` writes the kernel's three passes (claim,
mark, apply) in plain PyTorch.

On the CUDA path the wrapper launches the kernel and no PyTorch
operator: it validates its arguments in one pass, takes held scratch
(``_SCRATCH``, allocated only when a larger table or batch first
appears) and calls the library, whose argument types are set once when
it loads.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import backend as backend_mod
from repro_torch.core import tracker
from repro_torch.kernels import build

# (device, capacity) -> [last_cand int32[T] all -1, last_hit int32[T]
# all -1, dup uint8[>= B] all 0]; the kernel leaves them so.
_SCRATCH: dict = {}
_LIB: list = []
_DTYPES = (torch.int32, torch.int8, torch.bool, torch.int32, torch.int8,
           torch.int8)
_NAMES = ("keys", "locs", "valid", "tracker.keys", "tracker.clock",
          "tracker.loc")


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = build.load("clock_update")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.clock_update_launch.argtypes = [p, p, p, i, p, p, p, i, p, p, p,
                                            p]
        lib.clock_update_launch.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def _scratch(dev: torch.device, t: int, b: int) -> list:
    key = (dev, t)
    sc = _SCRATCH.get(key)
    if sc is None:
        sc = _SCRATCH[key] = [
            torch.full((t,), -1, dtype=torch.int32, device=dev),
            torch.full((t,), -1, dtype=torch.int32, device=dev),
            torch.zeros(0, dtype=torch.uint8, device=dev)]
    if sc[2].shape[0] < b:
        sc[2] = torch.zeros(max(b, 2 * sc[2].shape[0]), dtype=torch.uint8,
                            device=dev)
    return sc


def clock_update(state: tracker.TrackerState, keys: torch.Tensor,
                 locs: torch.Tensor, valid: torch.Tensor
                 ) -> tracker.TrackerState:
    """Launch the clock_update kernel (three launches, one C call):
    applies one access batch to the tracker tables in place (same result
    as ``access_batched``)."""
    tk, tc, tl = state
    xs = (keys, locs, valid, tk, tc, tl)
    b, t = keys.shape[0], tk.shape[0]
    dev = tk.device
    for name, x, dt in zip(_NAMES, xs, _DTYPES):
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"clock_update: {name} must be on {dev} "
                             "(a CUDA device)")
        if x.dtype != dt or x.dim() != 1 or x.stride(0) != 1:
            raise ValueError(f"clock_update: {name} must be a contiguous "
                             f"1-d {dt} tensor")
    if locs.shape[0] != b or valid.shape[0] != b or tc.shape[0] != t \
            or tl.shape[0] != t or not 0 < t < 2**31 or b >= 2**31:
        raise ValueError("clock_update: shape mismatch")
    last_cand, last_hit, dup = _scratch(dev, t, b)
    rc = _lib().clock_update_launch(
        keys.data_ptr(), locs.data_ptr(), valid.data_ptr(), b,
        tk.data_ptr(), tc.data_ptr(), tl.data_ptr(), t,
        last_cand.data_ptr(), last_hit.data_ptr(), dup.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
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
