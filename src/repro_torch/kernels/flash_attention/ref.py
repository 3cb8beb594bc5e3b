"""Plain PyTorch version of the flash_attention kernel (B7): the JAX
package's ``kernels/flash_attention/ref.py`` ``attention_ref``."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = -1,
                  scale: float | None = None):
    """q: [B, Hq, Sq, D]; k, v: [B, Hkv, Sk, D].  window: -1 = full.

    A sliding window keeps keys with q_pos - window < k_pos <= q_pos.
    Query rows are right-aligned with the keys (q position i attends as
    absolute position i + Sk - Sq).  A row that sees no key gives NaN
    here (the kernel gives 0 there; no model path reaches such a row).
    """
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = (q.to(torch.float32) * scale).reshape(b, hkv, g, sq, d)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf)
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, -torch.inf)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    return o.reshape(b, hq, sq, d).to(q.dtype)
