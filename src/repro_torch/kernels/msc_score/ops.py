"""approx-MSC scoring wrapper with backend dispatch (kernel B2, msc_score).

``score_candidates`` launches ``csrc/msc_score.cu`` for CUDA tensors and
takes the plain version, ``ref.msc_scores_ref``, for CPU tensors or
backend "reference".
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import backend as backend_mod
from repro_torch.kernels import build
from repro_torch.kernels.msc_score.ref import msc_scores_ref


def _lib() -> ctypes.CDLL:
    lib = build.load("msc_score")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msc_score_launch.argtypes = [p] * 8 + [i, i, i, p, p]
    lib.msc_score_launch.restype = ctypes.c_int
    return lib


def msc_scores(lo, hi, t_f, bucket_fast, bucket_slow, bucket_overlap, bhist,
               probs, *, bucket_width: int) -> torch.Tensor:
    """Launch the msc_score kernel: f32[K] scores of K <= 32 candidates."""
    k, nb = lo.shape[0], bucket_fast.shape[0]
    dev = lo.device
    args = []
    for name, x, dt, shape in (
            ("lo", lo, torch.int32, (k,)), ("hi", hi, torch.int32, (k,)),
            ("t_f", t_f, torch.int32, (k,)),
            ("bucket_fast", bucket_fast, torch.int32, (nb,)),
            ("bucket_slow", bucket_slow, torch.int32, (nb,)),
            ("bucket_overlap", bucket_overlap, torch.int32, (nb,)),
            ("bhist", bhist, torch.int32, (nb, 4)),
            ("probs", probs, torch.float32, (4,))):
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"msc_scores: {name} must be on {dev}")
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"msc_scores: {name} must be {dt}{shape}")
        args.append(x.contiguous())
    if not 0 < k <= 32 or bucket_width <= 0 or nb * bucket_width >= 2**31:
        raise ValueError("msc_scores: K must be in [1, 32] and the bucket "
                         "edges must fit int32")
    out = torch.empty(k, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().msc_score_launch(*[a.data_ptr() for a in args], k, nb,
                                 bucket_width, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"msc_score launch failed: cudaError {rc}")
    kernels.LAUNCHES["msc_score"] += 1
    return out


def score_candidates(lo, hi, t_f, bucket_fast, bucket_slow, bucket_overlap,
                     bhist, probs, *, bucket_width: int,
                     backend: str = "cuda") -> torch.Tensor:
    fn = msc_scores if backend_mod.use_kernel(backend, lo) else \
        msc_scores_ref
    return fn(lo, hi, t_f, bucket_fast, bucket_slow, bucket_overlap, bhist,
              probs, bucket_width=bucket_width)
