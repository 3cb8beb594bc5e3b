"""RWKV-6 WKV with backend dispatch (kernel B8, rwkv6_scan; the JAX
package's ``kernels/rwkv6_scan/ops.py``).

``wkv`` launches ``csrc/rwkv6_scan.cu`` for CUDA tensors on backend
"cuda", and takes the plain version, ``ref.rwkv6_ref``, for backend
"reference" or tensors on the CPU.  The JAX wrapper's TPU tiling knobs
(``chunk``, ``interpret``) and its padding of the time axis have no
counterpart: the kernel takes any T.  It takes r/k/v/w with any strides
whose last dimension is contiguous, so ``time_mix``'s transposed
projections go in without a copy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import backend as backend_mod
from repro_torch.kernels import build
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_ref

MAX_HEAD_DIM = 64
_LIB: list = []
_INFO = ("threads", "registers", "local_bytes", "shared_bytes",
         "blocks_per_sm")


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = build.load("rwkv6_scan")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.rwkv6_scan_launch.argtypes = [p] * 6 + [i] * 4 + [i64] * 12 \
            + [p]
        lib.rwkv6_scan_launch.restype = ctypes.c_int
        lib.rwkv6_scan_info.argtypes = [p]
        lib.rwkv6_scan_info.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def launch_info() -> dict:
    """The launch shape of the kernel's instance with 16-byte loads (the
    one aligned inputs with D a multiple of 4 take; one block a (batch,
    head)): threads a block, registers and local-memory bytes a thread,
    shared memory a block, and resident blocks an SM."""
    info = (ctypes.c_int * len(_INFO))()
    rc = _lib().rwkv6_scan_info(info)
    if rc != 0:
        raise RuntimeError(f"rwkv6_scan_info failed: cudaError {rc}")
    return dict(zip(_INFO, info))


def rwkv6_scan(r, k, v, w, u) -> torch.Tensor:
    """Launch the rwkv6_scan kernel: r, k, v, w float32 [B, H, T, D] on
    one card (last dimension contiguous), u float32 [H, D], D <= 64.
    Returns a new contiguous float32 [B, H, T, D]."""
    backend_mod.refuse_grad("rwkv6_scan", r, k, v, w, u)
    b, h, t, d = r.shape
    dev = r.device
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"rwkv6_scan: {name} must be on {dev} "
                             "(a CUDA device)")
        if x.dtype != torch.float32:
            raise ValueError(f"rwkv6_scan: {name} must be float32")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape or x.dim() != 4 or x.stride(3) != 1:
            raise ValueError(f"rwkv6_scan: {name} must be [B, H, T, D] "
                             "like r, with a contiguous last dimension")
    if u.shape != (h, d) or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"rwkv6_scan: u must be [H, D] with D <= "
                         f"{MAX_HEAD_DIM}")
    out = torch.empty((b, h, t, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    u = u.contiguous()
    rc = _lib().rwkv6_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        out.data_ptr(), b, h, t, d, *r.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *w.stride()[:3],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: cudaError {rc}")
    kernels.LAUNCHES["rwkv6_scan"] += 1
    return out


def wkv(r, k, v, w, u, *, backend: str = "reference"):
    """r, k, v, w: [B, H, T, D]; u: [H, D] -> [B, H, T, D] in r's dtype.
    The kernel computes in float32, as the JAX wrapper does."""
    if backend_mod.use_kernel(backend, r):
        f32 = lambda x: x.to(torch.float32)
        return rwkv6_scan(f32(r), f32(k), f32(v), f32(w), f32(u)).to(r.dtype)
    return rwkv6_ref(r, k, v, w, u)
