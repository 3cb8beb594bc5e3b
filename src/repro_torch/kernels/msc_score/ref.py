"""Plain PyTorch version of the msc_score kernel: approx-MSC scoring of
K candidate ranges (Eq. 1, bucketized), a port of the JAX package's
``kernels/msc_score/ref.py``."""
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
