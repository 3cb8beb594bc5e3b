"""Mamba selective-SSM block (arXiv:2312.00752; the port's copy of the JAX
package's ``models/mamba.py``), used by Jamba's 7 of 8 layers.

in_proj -> (x, z); short causal conv; SiLU; data-dependent (dt, B, C);
selective scan (``kernels/mamba_scan``: the mamba_scan kernel, B9, on
backend "cuda"); gate by SiLU(z); out_proj.  Decode is the one-token
update of the state, plain tensor code in both packages.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, on_row_shards
from repro_torch.kernels.mamba_scan.ops import selective_scan
from repro_torch.models.common import ParamInit


def init_mamba_layer(pi: ParamInit, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    dt_rank = max(d // 16, 8)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32))
    return {
        "in_proj": pi.dense((d, 2 * di), ("embed", "mlp")),
        "conv_w": pi.dense((cfg.ssm_conv, di), (None, "mlp"), scale=0.5),
        "conv_b": pi.zeros((di,), ("mlp",)),
        "x_proj": pi.dense((di, dt_rank + 2 * n), ("mlp", None)),
        "dt_proj_w": pi.dense((dt_rank, di), (None, "mlp")),
        "dt_proj_b": pi.full((di,), -4.6, ("mlp",)),   # softplus ~ 0.01
        "a_log": pi.const(a_log.expand(di, n), ("mlp", None)),
        "d": pi.ones((di,), ("mlp",)),
        "out_proj": pi.dense((di, d), ("mlp", "embed")),
    }


def _causal_conv(x, w, b, state=None):
    """x: [B, S, Di]; w: [K, Di] depthwise causal conv (the taps summed in
    the JAX package's order).  state: [B, K-1, Di], the last K-1 inputs,
    carried for decode.  Returns (out, new_state)."""
    k = w.shape[0]
    s = x.shape[1]
    pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                      device=x.device) if state is None \
        else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + s] * w[i][None, None] for i in range(k))
    return out + b[None, None], xp[:, s:]


def softplus(x):
    """``jax.nn.softplus``: log(1 + exp(x)) with no linear cut-off (torch's
    ``softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba_layer(params, cfg: ModelConfig, x, *, backend: str = "reference",
                state=None):
    """x: [B, S, D].  ``state`` = (ssm_h [B, Di, N] float32, conv
    [B, K-1, Di]) for decode (one token); None for prefill, which runs
    the whole sequence through ``selective_scan`` from a zero state.
    Returns (out, (new_h, new_conv)); new_h is None for prefill."""
    p = params
    d = x.shape[-1]
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    dt_rank = p["dt_proj_w"].shape[0]
    f32 = torch.float32

    xz = x @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    xi, new_conv = _causal_conv(xi, p["conv_w"], p["conv_b"],
                                None if state is None else state[1])
    # the layout anchors of a DTensor run (a plain tensor passes): the
    # scan's channels sharded as in_proj's, its (dt, B, C) projection
    # reduced whole
    xi = constrain(F.silu(xi), ("batch", "seq", "mlp"))

    proj = constrain(xi @ p["x_proj"], ("batch", "seq", None))
    dt = softplus(proj[..., :dt_rank] @ p["dt_proj_w"]
                  + p["dt_proj_b"][None, None])
    bmat = proj[..., dt_rank:dt_rank + n]
    cmat = proj[..., dt_rank + n:]
    a = -torch.exp(p["a_log"].to(f32))

    if state is None:
        y = on_row_shards(lambda *t: selective_scan(*t, backend=backend),
                          (0, 0, None, 0, 0, None), (2, 2, 0, None, None, 0),
                          xi, dt, a, bmat, cmat, p["d"])
        new_h = None
    else:
        h = state[0]
        da = torch.exp(dt[:, 0, :, None].to(f32) * a[None])
        h = da * h + (dt[:, 0] * xi[:, 0])[..., None] \
            * bmat[:, 0, None, :].to(f32)
        y = (torch.sum(h * cmat[:, 0, None, :].to(f32), dim=-1)
             + p["d"] * xi[:, 0])[:, None].to(x.dtype)
        new_h = h
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, (new_h, new_conv)
