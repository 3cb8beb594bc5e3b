"""Plain PyTorch version of the mamba_scan kernel (B9): the JAX package's
``kernels/mamba_scan/ref.py`` ``mamba_ref``.

Mamba selective-SSM recurrence (S6), per batch row and channel c (d_inner
channels) with state size N, from a zero state:
  h_t = exp(dt_t[c] * A[c]) * h_{t-1} + dt_t[c] * B_t * x_t[c]
  y_t[c] = C_t . h_t + D[c] * x_t[c]
A loop over T in float32 with the state [B, Di, N] written out; one step
is a few tensor ops, so on the card it costs a launch each.
"""
from __future__ import annotations

import torch


def mamba_ref(x, dt, A, B, C, D):
    """x, dt: [Bb, T, Di]; A: [Di, N]; B, C: [Bb, T, N]; D: [Di].
    Returns y: [Bb, T, Di] in x's dtype."""
    bb, t, di = x.shape
    f32 = torch.float32
    xf, dtf, bf, cf = (a.to(f32) for a in (x, dt, B, C))
    af, df = A.to(f32), D.to(f32)
    h = torch.zeros((bb, di, af.shape[1]), dtype=f32, device=x.device)
    if t == 0:
        return torch.empty((bb, 0, di), dtype=x.dtype, device=x.device)
    # stacked, not written into a buffer: autograd then keeps one node for
    # the sequence instead of one full-buffer copy a step
    y = []
    for i in range(t):
        xt, dtt = xf[:, i], dtf[:, i]                        # [Bb, Di]
        da = torch.exp(dtt[..., None] * af)                  # [Bb, Di, N]
        h = da * h + (dtt * xt)[..., None] * bf[:, i, None, :]
        y.append(torch.sum(h * cf[:, i, None, :], dim=-1) + df * xt)
    return torch.stack(y, dim=1).to(x.dtype)
