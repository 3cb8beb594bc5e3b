"""Plain PyTorch version of the paged_attention kernel (B6): the JAX
package's ``kernels/paged_attention/ref.py`` ``paged_attention_ref``."""
from __future__ import annotations

import torch


def paged_attention_ref(q, k_pages, v_pages, block_tables, token_mask,
                        scale: float | None = None):
    """q: [B, Hq, D]; pools: [P, T, Hkv, D]; block_tables: [B, K] slots
    (-1 = absent); token_mask: [B, K, T] bool.  Returns [B, Hq, D]; a
    sequence that sees nothing gives 0."""
    b, hq, d = q.shape
    _, t, hkv, _ = k_pages.shape
    k_ = block_tables.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    slots = block_tables.clamp(min=0).to(torch.int64)
    kk = k_pages[slots]                       # [B, K, T, Hkv, D]
    vv = v_pages[slots]
    mask = token_mask.to(torch.bool) & (block_tables >= 0)[..., None]
    qf = (q.to(torch.float32) * scale).reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bkthd->bhgkt", qf, kk.to(torch.float32))
    s = torch.where(mask[:, None, None], s, -torch.inf)
    s = s.reshape(b, hkv, g, k_ * t)
    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    pr = torch.exp(s - m)
    pr = torch.where(torch.isfinite(s), pr, 0.0)
    den = torch.clamp(torch.sum(pr, dim=-1, keepdim=True), min=1e-30)
    pr = (pr / den).reshape(b, hkv, g, k_, t)
    o = torch.einsum("bhgkt,bkthd->bhgd", pr, vv.to(torch.float32))
    return o.reshape(b, hq, d).to(q.dtype)
