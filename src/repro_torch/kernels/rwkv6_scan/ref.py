"""Plain PyTorch version of the rwkv6_scan kernel (B8): the JAX package's
``kernels/rwkv6_scan/ref.py`` ``rwkv6_ref``.

RWKV-6 (Finch) WKV recurrence with data-dependent decay, per (batch,
head) with state S in R^{D x D}:
  o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
  S_t = diag(w_t) S_{t-1} + k_t v_t^T
A loop over T in float32 with the state written out; one step is a few
[B, H, D, D] tensor ops, so on the card it costs a launch each.
``rwkv6_split_ref`` is the kernel's summation in plain PyTorch: the
bonus term as v_t times one dot per step.
"""
from __future__ import annotations

import torch


def _stack(steps: list, shape: tuple, r) -> torch.Tensor:
    """The per-step outputs [B, H, D] as [B, H, T, D] in r's dtype.  They
    are stacked, not written into a buffer, so autograd keeps one node
    for the sequence instead of one full-buffer copy a step."""
    if not steps:
        return torch.empty(shape, dtype=r.dtype, device=r.device)
    return torch.stack(steps, dim=2).to(r.dtype)


def rwkv6_ref(r, k, v, w, u):
    """r, k, v, w: [B, H, T, D] (w = decay in (0, 1)); u: [H, D].
    Returns [B, H, T, D] in r's dtype."""
    b, h, t, d = r.shape
    rf, kf, vf, wf = (x.to(torch.float32) for x in (r, k, v, w))
    uu = u.to(torch.float32)[None, :, :, None]             # [1, H, D, 1]
    s = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    out = []
    for i in range(t):
        kv = kf[:, :, i, :, None] * vf[:, :, i, None, :]   # [B, H, D, D]
        out.append((rf[:, :, i, None, :] @ (s + uu * kv))[:, :, 0])
        s = wf[:, :, i, :, None] * s + kv
    return _stack(out, (b, h, t, d), r)


def rwkv6_split_ref(r, k, v, w, u):
    """``rwkv6_ref`` summed as ``csrc/rwkv6_scan.cu`` sums it: the bonus
    term ``sum_i r_t[i] u[i] k_t[i] v_t[j]`` is ``v_t[j] * beta_t`` with
    ``beta_t = sum_i r_t[i] u[i] k_t[i]``, so
    o_t = S_{t-1}^T r_t + v_t beta_t, read before S is updated.  Same
    arguments and result as ``rwkv6_ref``."""
    b, h, t, d = r.shape
    rf, kf, vf, wf = (x.to(torch.float32) for x in (r, k, v, w))
    beta = (rf * u.to(torch.float32)[None, :, None, :] * kf).sum(-1)
    s = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    out = []
    for i in range(t):
        out.append((rf[:, :, i, None, :] @ s)[:, :, 0]
                   + vf[:, :, i] * beta[:, :, i, None])
        s = wf[:, :, i, :, None] * s + kf[:, :, i, :, None] \
            * vf[:, :, i, None, :]
    return _stack(out, (b, h, t, d), r)
