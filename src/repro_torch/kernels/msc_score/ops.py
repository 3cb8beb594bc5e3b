"""approx-MSC scoring wrapper with backend dispatch (kernel B2, msc_score).

``score_candidates`` launches ``csrc/msc_score.cu`` for CUDA tensors and
takes the plain version, ``ref.msc_scores_ref`` and ``torch.argmax``, for
CPU tensors or backend "reference".  Either way it returns the K scores
and the index of the best candidate: the kernel picks it itself, as
``jnp.argmax`` does (the first index among equal maxima), so a
compaction's scoring is one launch.

On the CUDA path a call costs about one launch: the arguments are
checked in one pass (or, with ``check=False``, not at all: the caller
guarantees them, as ``msc.select_range`` does), the library's argument
types are set once when it loads, and the wrapper allocates the two
outputs and makes one C call.  It reads the current stream's handle
with ``torch._C._cuda_getCurrentRawStream``, as PyTorch's generated
kernels do: ``torch.cuda.current_stream()`` builds a Stream object and
cost about as much as the launch itself on the H100's host.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import backend as backend_mod
from repro_torch.kernels import build
from repro_torch.kernels.msc_score.ref import msc_scores_ref

MAX_CANDIDATES = 32          # one warp a candidate in one block
_LIB: list = []
_NAMES = ("lo", "hi", "t_f", "bucket_fast", "bucket_slow", "bucket_overlap",
          "bhist", "probs")


def _lib() -> ctypes.CDLL:
    if not _LIB:
        lib = build.load("msc_score")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.msc_score_launch.argtypes = [p] * 8 + [i, i, i, p, p, p]
        lib.msc_score_launch.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def check_args(lo, hi, t_f, bucket_fast, bucket_slow, bucket_overlap, bhist,
               probs, *, bucket_width: int) -> None:
    """Raise ValueError unless the arguments are what the kernel reads:
    int32 [K] candidates (1 <= K <= 32), int32 [B] bucket counts, an
    int32 [B, 4] histogram (16-byte aligned), float32 [4] probabilities,
    all contiguous on one CUDA device, bucket edges within int32."""
    k, nb = lo.shape[0], bucket_fast.shape[0]
    dev = lo.device
    shapes = ((k,),) * 3 + ((nb,),) * 3 + ((nb, 4), (4,))
    for name, x, shape in zip(_NAMES, (lo, hi, t_f, bucket_fast, bucket_slow,
                                       bucket_overlap, bhist, probs), shapes):
        dt = torch.float32 if name == "probs" else torch.int32
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"msc_scores: {name} must be on {dev} "
                             "(a CUDA device)")
        if x.dtype != dt or x.shape != shape or not x.is_contiguous():
            raise ValueError(f"msc_scores: {name} must be a contiguous "
                             f"{dt}{list(shape)}")
    if not 0 < k <= MAX_CANDIDATES or bucket_width <= 0 \
            or nb * bucket_width >= 2**31 or bhist.data_ptr() % 16:
        raise ValueError("msc_scores: K must be in [1, 32], the bucket "
                         "edges must fit int32 and bhist be 16-byte aligned")


def msc_scores(lo, hi, t_f, bucket_fast, bucket_slow, bucket_overlap, bhist,
               probs, *, bucket_width: int, check: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the msc_score kernel: (f32[K] scores, the int64 index of the
    best of the K <= 32 candidates).  ``check=False`` skips
    ``check_args``: only for arguments built to its rules."""
    if check:
        check_args(lo, hi, t_f, bucket_fast, bucket_slow, bucket_overlap,
                   bhist, probs, bucket_width=bucket_width)
    dev = lo.device
    k = lo.shape[0]
    scores = torch.empty(k, dtype=torch.float32, device=dev)
    best = torch.empty((), dtype=torch.int64, device=dev)
    rc = _lib().msc_score_launch(
        lo.data_ptr(), hi.data_ptr(), t_f.data_ptr(), bucket_fast.data_ptr(),
        bucket_slow.data_ptr(), bucket_overlap.data_ptr(), bhist.data_ptr(),
        probs.data_ptr(), k, bucket_fast.shape[0], bucket_width,
        scores.data_ptr(), best.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"msc_score launch failed: cudaError {rc}")
    kernels.LAUNCHES["msc_score"] += 1
    return scores, best


def score_candidates(lo, hi, t_f, bucket_fast, bucket_slow, bucket_overlap,
                     bhist, probs, *, bucket_width: int,
                     backend: str = "cuda", check: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(f32[K] scores, int64 index of the best candidate); ``check`` as in
    ``msc_scores`` (the plain version checks nothing)."""
    if backend_mod.use_kernel(backend, lo):
        return msc_scores(lo, hi, t_f, bucket_fast, bucket_slow,
                          bucket_overlap, bhist, probs,
                          bucket_width=bucket_width, check=check)
    scores = msc_scores_ref(lo, hi, t_f, bucket_fast, bucket_slow,
                            bucket_overlap, bhist, probs,
                            bucket_width=bucket_width)
    return scores, torch.argmax(scores)
