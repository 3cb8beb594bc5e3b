"""Mamba selective scan with backend dispatch (kernel B9, mamba_scan; the
JAX package's ``kernels/mamba_scan/ops.py``).

``selective_scan`` launches ``csrc/mamba_scan.cu`` for CUDA tensors on
backend "cuda", and takes the plain version, ``ref.mamba_ref``, for
backend "reference" or tensors on the CPU.  The JAX wrapper's TPU tiling
knobs (``block_d``, ``chunk``, ``interpret``) and its padding of the
time axis have no counterpart: the kernel takes any T and any Di.  It
takes x, dt, B and C with any batch and time strides whose last
dimension is contiguous, so ``mamba_layer``'s B and C, column slices of
``x_proj``'s output, go in without a copy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import backend as backend_mod
from repro_torch.kernels import build
from repro_torch.kernels.mamba_scan.ref import mamba_ref

MAX_STATE = 16


def _lib() -> ctypes.CDLL:
    lib = build.load("mamba_scan")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mamba_scan_launch.argtypes = [p] * 7 + [i] * 4 + [i64] * 8 + [p]
    lib.mamba_scan_launch.restype = ctypes.c_int
    return lib


def mamba_scan(x, dt, A, B, C, D) -> torch.Tensor:
    """Launch the mamba_scan kernel: x, dt float32 [Bb, T, Di], A float32
    [Di, N], B, C float32 [Bb, T, N], D float32 [Di], on one card (x, dt,
    B, C with a contiguous last dimension), N <= 16.  Returns a new
    contiguous float32 [Bb, T, Di]."""
    backend_mod.refuse_grad("mamba_scan", x, dt, A, B, C, D)
    bb, t, di = x.shape
    dev = x.device
    for name, a in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C),
                    ("D", D)):
        if a.device.type != "cuda" or a.device != dev:
            raise ValueError(f"mamba_scan: {name} must be on {dev} "
                             "(a CUDA device)")
        if a.dtype != torch.float32:
            raise ValueError(f"mamba_scan: {name} must be float32")
    if dt.shape != x.shape or dt.stride(2) != 1 or x.stride(2) != 1:
        raise ValueError("mamba_scan: x and dt must be [Bb, T, Di] with a "
                         "contiguous last dimension")
    if A.dim() != 2 or A.shape[0] != di or not 0 < A.shape[1] <= MAX_STATE:
        raise ValueError(f"mamba_scan: A must be [Di, N] with N <= "
                         f"{MAX_STATE}")
    n = A.shape[1]
    for name, a in (("B", B), ("C", C)):
        if a.shape != (bb, t, n) or a.stride(2) != 1:
            raise ValueError(f"mamba_scan: {name} must be [Bb, T, N] with "
                             "a contiguous last dimension")
    if D.shape != (di,):
        raise ValueError("mamba_scan: D must be [Di]")
    y = torch.empty((bb, t, di), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    A, D = A.contiguous(), D.contiguous()
    rc = _lib().mamba_scan_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), y.data_ptr(), bb, t, di, n,
        *x.stride()[:2], *dt.stride()[:2], *B.stride()[:2],
        *C.stride()[:2], torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"mamba_scan launch failed: cudaError {rc}")
    kernels.LAUNCHES["mamba_scan"] += 1
    return y


def selective_scan(x, dt, A, B, C, D, *, backend: str = "reference"):
    """x, dt: [Bb, T, Di]; A: [Di, N]; B, C: [Bb, T, N]; D: [Di] -> y
    [Bb, T, Di] in x's dtype.  The kernel computes in float32, as the
    JAX wrapper does."""
    if backend_mod.use_kernel(backend, x):
        f32 = lambda a: a.to(torch.float32)
        return mamba_scan(f32(x), f32(dt), f32(A), f32(B), f32(C),
                          f32(D)).to(x.dtype)
    return mamba_ref(x, dt, A, B, C, D)
