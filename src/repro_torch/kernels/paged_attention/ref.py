"""Plain PyTorch version of the paged_attention kernel (B6): the JAX
package's ``kernels/paged_attention/ref.py`` ``paged_attention_ref``,
and ``merge_partials_ref``, the kernel's split of the page walk over its
warps and their merge."""
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


def merge_partials_ref(q, k_pages, v_pages, block_tables, token_mask,
                       groups: int, scale: float | None = None):
    """The kernel's split of the page walk in plain PyTorch: page j goes
    to group j % ``groups`` (a warp of the block); each group runs its
    own online softmax over its pages, one page at a time (m, l and the
    output's accumulator for every query head), and the groups' states
    merge once, each rescaled by exp(m_w - m); a group that saw nothing
    (m_w = -inf) weighs 0.  Arguments and result as
    ``paged_attention_ref``; a sequence that sees nothing gives 0."""
    b, hq, d = q.shape
    _, t, hkv, _ = k_pages.shape
    k_ = block_tables.shape[1]
    g = hq // hkv
    f32 = torch.float32
    scale = scale if scale is not None else d ** -0.5
    slots = block_tables.clamp(min=0).to(torch.int64)
    vv = v_pages[slots].to(f32)                # [B, K, T, Hkv, D]
    seen = token_mask.to(torch.bool) & (block_tables >= 0)[..., None]
    qf = (q.to(f32) * scale).reshape(b, hkv, g, d)
    s_all = torch.einsum("bhgd,bkthd->bhgkt", qf, k_pages[slots].to(f32))
    s_all = torch.where(seen[:, None, None], s_all, -torch.inf)
    ms, ls, accs = [], [], []
    for w in range(groups):
        m = torch.full((b, hkv, g), -torch.inf, dtype=f32, device=q.device)
        l = torch.zeros((b, hkv, g), dtype=f32, device=q.device)
        acc = torch.zeros((b, hkv, g, d), dtype=f32, device=q.device)
        for j in range(w, k_, groups):
            s = s_all[..., j, :]                           # [B, Hkv, G, T]
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.where(torch.isfinite(m_new), torch.exp(m - m_new),
                                1.0)
            p = torch.where(torch.isfinite(s), torch.exp(s - m_new[..., None]),
                            0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgt,bthd->bhgd", p, vv[:, j])
            m = m_new
        ms.append(m), ls.append(l), accs.append(acc)
    ms, ls, accs = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    top = ms.amax(0)
    wts = torch.where(torch.isfinite(ms), torch.exp(ms - top), 0.0)
    den = torch.clamp((wts * ls).sum(0), min=1e-30)
    o = (wts[..., None] * accs).sum(0) / den[..., None]
    return o.reshape(b, hq, d).to(q.dtype)
