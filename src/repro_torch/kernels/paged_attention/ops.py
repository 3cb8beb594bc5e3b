"""Paged decode attention with backend dispatch (kernel B6,
paged_attention; the JAX package's ``kernels/paged_attention/ops.py``).

``decode_attention`` launches ``csrc/paged_attention.cu`` for CUDA
tensors on backend "cuda", and takes the plain version,
``ref.paged_attention_ref``, for backend "reference" or tensors on the
CPU.  The kernel reads the page pools in place through the block tables.
It runs on the device its tensors lie on.

No model path of the JAX package runs this kernel: its serving engine
gathers the selected pages (``paged_kv.gather_pages``) and attends with a
dense einsum, and the port's serving engine does the same so that it
matches the JAX package.  ``decode_attention`` is its own entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import backend as backend_mod
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP, MAX_HEAD_DIM = 8, 256


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_launch.argtypes = [p] * 6 + [i] * 9 + [
        ctypes.c_int64, ctypes.c_float, p]
    lib.paged_attention_launch.restype = ctypes.c_int
    return lib


def paged_attention(q, k_pages, v_pages, block_tables, token_mask, *,
                    scale: float | None = None) -> torch.Tensor:
    """Launch the paged_attention kernel: q [B, Hq, D]; pools
    [P, T, Hkv, D] (float32 or bfloat16, each page contiguous, pages any
    stride apart: a layer's slice of the slot-major paged-KV pools reads
    in place); block_tables int32
    [B, K] (-1 absent); token_mask bool [B, K, T].  Returns [B, Hq, D] in
    q's dtype.  Hq / Hkv <= 8, D <= 256."""
    b, hq, d = q.shape
    p_, t, hkv, _ = k_pages.shape
    kpages = block_tables.shape[1]
    dev = q.device
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables),
                    ("token_mask", token_mask)):
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"paged_attention: {name} must be on {dev} "
                             "(a CUDA device)")
        if not (x[0] if x.dim() == 4 and len(x) else x).is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous "
                             "(the pools: within each page)")
    if v_pages.stride() != k_pages.stride():
        raise ValueError("paged_attention: the pools must share strides")
    if q.dtype not in _DTYPES or k_pages.dtype not in _DTYPES \
            or v_pages.dtype != k_pages.dtype:
        raise ValueError("paged_attention: q and the pools must be float32 "
                         "or bfloat16 (the two pools alike)")
    if block_tables.dtype != torch.int32 or token_mask.dtype != torch.bool:
        raise ValueError("paged_attention: block_tables must be int32 and "
                         "token_mask bool")
    if v_pages.shape != k_pages.shape or k_pages.shape[3] != d \
            or block_tables.shape != (b, kpages) \
            or token_mask.shape != (b, kpages, t) or hkv == 0 \
            or hq % hkv or hq // hkv > MAX_GROUP or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError("paged_attention: shapes must be q [B, Hq, D], "
                         "pools [P, T, Hkv, D], block_tables [B, K], "
                         f"token_mask [B, K, T], Hq / Hkv <= {MAX_GROUP}, "
                         f"D <= {MAX_HEAD_DIM}")
    out = torch.empty((b, hq, d), dtype=q.dtype, device=dev)
    if b == 0:
        return out
    scale = scale if scale is not None else d ** -0.5
    rc = _lib().paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), token_mask.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], _DTYPES[k_pages.dtype], b, hq, hkv, d, p_, t,
        kpages, k_pages.stride(0), scale,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"paged_attention launch failed: cudaError {rc}")
    kernels.LAUNCHES["paged_attention"] += 1
    return out


def decode_attention(q, k_pages, v_pages, block_tables, token_mask, *,
                     backend: str = "reference"):
    """Decode-step attention over selected KV pages: q [B, Hq, D]; pools
    [P, T, Hkv, D]; block_tables [B, K]; token_mask [B, K, T]."""
    if backend_mod.use_kernel(backend, q):
        # copy the table and the mask only where the kernel needs it
        if block_tables.dtype != torch.int32 \
                or not block_tables.is_contiguous():
            block_tables = block_tables.to(torch.int32).contiguous()
        if token_mask.dtype != torch.bool or not token_mask.is_contiguous():
            token_mask = token_mask.to(torch.bool).contiguous()
        return paged_attention(q, k_pages, v_pages, block_tables, token_mask)
    return paged_attention_ref(q, k_pages, v_pages, block_tables,
                               token_mask)
