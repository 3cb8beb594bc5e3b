"""Plain PyTorch version of the msc_score kernel: approx-MSC scoring of
K candidate ranges (Eq. 1, bucketized), a port of the JAX package's
``kernels/msc_score/ref.py``, and ``pick_best_ref``, the kernel's choice
of the best candidate."""
from __future__ import annotations

import torch

from repro_torch.core.utils import fdiv


def msc_scores_ref(lo, hi, t_f, bucket_fast, bucket_slow, bucket_overlap,
                   bhist, probs, *, bucket_width: int) -> torch.Tensor:
    """lo/hi/t_f: [K]; bucket_*: [B]; bhist: [B, 4]; probs: [4] -> f32[K]."""
    f32 = torch.float32
    nb = bucket_fast.shape[0]
    edges_lo = torch.arange(nb, dtype=torch.int32,
                            device=lo.device) * bucket_width
    edges_hi = edges_lo + bucket_width
    inter = (torch.minimum(edges_hi[None, :], hi[:, None])
             - torch.maximum(edges_lo[None, :], lo[:, None])).to(f32)
    w = fdiv(inter, float(bucket_width)).clamp(0.0, 1.0)      # [K, B]

    nf = bucket_fast.to(f32)
    ns = bucket_slow.to(f32)
    ov = bucket_overlap.to(f32)
    h = bhist.to(f32)
    untracked = (nf - h.sum(1)).clamp(min=0.0)
    inv = fdiv(1.0, torch.arange(4, dtype=f32, device=lo.device) + 1.0)

    benefit = w @ (h @ inv + untracked)
    t_n = w @ nf
    pinned = w @ (h @ probs)
    p = (pinned / t_n.clamp(min=1.0)).clamp(0.0, 0.999)
    tf_est = torch.maximum(w @ ns, t_f.to(f32))
    o = ((w @ ov) / tf_est.clamp(min=1.0)).clamp(0.0, 1.0)
    f = tf_est / t_n.clamp(min=1.0)
    cost = f * (2.0 - o) / (1.0 - p) + 1.0
    return torch.where(t_n > 0, benefit / cost, torch.zeros_like(benefit))


def pick_best_ref(scores: torch.Tensor) -> torch.Tensor:
    """The msc_score kernel's pick of the best of K <= 32 scores, in plain
    PyTorch: score k on lane k of a warp, -inf on the lanes past K, and
    the same butterfly of pairwise choices under ``jnp.argmax``'s order
    (NaN above every number, then the larger value, then the lower
    index).  The order is total, so the result is the first index among
    equal maxima, as ``jnp.argmax`` gives it.  Returns an int64 0-dim
    tensor."""
    k, dev = scores.shape[0], scores.device
    x = torch.full((32,), float("-inf"), dtype=torch.float32, device=dev)
    x[:k] = scores
    lane = torch.arange(32, device=dev)
    ix = lane.clone()                       # each lane's pick so far
    for off in (16, 8, 4, 2, 1):
        ox, oi = x[lane ^ off], ix[lane ^ off]
        na, nb = ox.isnan(), x.isnan()
        above = torch.where(na != nb, na,
                            torch.where(~na & (ox != x), ox > x, oi < ix))
        x, ix = torch.where(above, ox, x), torch.where(above, oi, ix)
    return ix[0]
