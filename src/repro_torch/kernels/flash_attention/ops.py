"""Multi-head attention with GQA and backend dispatch (kernel B7,
flash_attention; the JAX package's ``kernels/flash_attention/ops.py``).

``mha`` launches ``csrc/flash_attention.cu`` for CUDA tensors on backend
"cuda", and takes the plain version, ``ref.attention_ref``, for backend
"reference" or tensors on the CPU.  The kernel takes q/k/v with any
strides whose last (head) dimension is contiguous, so the model's
transposed projections go in without a copy; the output is a new
contiguous [B, Hq, Sq, D] tensor in q's dtype.

In bf16, a launch whose row tiles would leave most of the card's block
slots idle while a few long key ranges run (at most two row tiles an SM,
``SPLIT_MIN_KEYS`` keys or more) splits each row tile's keys over two
blocks that merge their partial results through held scratch
(``_SCRATCH``, allocated only when a larger launch first needs it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import backend as backend_mod
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
ROWS_PER_BLOCK = 64     # kBR of csrc/flash_attention.cu
SPLIT_MIN_KEYS = 1024

_LIB: list = []
# device -> [ws float32 partial results, cnt int32 all 0]; the kernel
# leaves cnt so
_SCRATCH: dict = {}
_SMS: dict = {}


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = build.load("flash_attention")
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.flash_attention_launch.argtypes = (
            [p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float]
            + [i64] * 9 + [i, p, p, p])
        lib.flash_attention_launch.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def _split(dtype, b, hq, hkv, sq, sk, d, window, dev) -> tuple:
    """(blocks per row tile, ws, cnt pointers) for one launch."""
    tiles = b * hkv * -(-sq * (hq // hkv) // ROWS_PER_BLOCK)
    keys = sk if window <= 0 else min(sk, window + ROWS_PER_BLOCK)
    if dtype != torch.bfloat16 or keys < SPLIT_MIN_KEYS:
        return 1, None, None
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    if tiles > 2 * _SMS[dev]:
        return 1, None, None
    # the kernel's partial layout: per row tile and half, ROWS_PER_BLOCK
    # rows of the instance's head dim, then (m, l) per row
    dt = 64 if d <= 64 else (128 if d <= 128 else 256)
    need = tiles * 2 * ROWS_PER_BLOCK * (dt + 2)
    sc = _SCRATCH.get(dev)
    if sc is None or sc[0].numel() < need or sc[1].numel() < tiles:
        sc = _SCRATCH[dev] = [
            torch.empty(need, dtype=torch.float32, device=dev),
            torch.zeros(tiles, dtype=torch.int32, device=dev)]
    return 2, sc[0].data_ptr(), sc[1].data_ptr()


def flash_attention(q, k, v, *, causal: bool = True, window: int = -1,
                    scale: float | None = None) -> torch.Tensor:
    """Launch the flash_attention kernel: q [B, Hq, Sq, D], k/v
    [B, Hkv, Sk, D] on one card, all float32 or all bfloat16, Hq a
    multiple of Hkv, D <= 256.  Returns [B, Hq, Sq, D] in q's dtype."""
    backend_mod.refuse_grad("flash_attention", q, k, v)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"flash_attention: {name} must be on {dev} "
                             "(a CUDA device)")
        if x.dtype not in _DTYPES or x.dtype != q.dtype or x.dim() != 4 \
                or x.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} must be a 4-d "
                             "float32 or bfloat16 tensor of q's dtype with "
                             "a contiguous last dimension")
    if k.shape != (b, hkv, sk, d) or v.shape != k.shape or hkv == 0 \
            or hq % hkv or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError("flash_attention: shapes must be q [B, Hq, Sq, D],"
                         " k/v [B, Hkv, Sk, D] with Hkv | Hq and D <= "
                         f"{MAX_HEAD_DIM}")
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else d ** -0.5
    nsplit, ws, cnt = _split(q.dtype, b, hq, hkv, sq, sk, d, window, dev)
    rc = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, hq, hkv, sq, sk, d, int(causal), int(window),
        scale, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], nsplit,
        ws, cnt, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    kernels.LAUNCHES["flash_attention"] += 1
    return out


def mha(q, k, v, *, causal: bool = True, window: int = -1,
        backend: str = "reference"):
    """Multi-head attention with GQA: q [B, Hq, Sq, D], k/v
    [B, Hkv, Sk, D]; ``window`` -1 is global."""
    if backend_mod.use_kernel(backend, q):
        return flash_attention(q, k, v, causal=causal, window=int(window))
    return attention_ref(q, k, v, causal=causal, window=int(window))
