"""RWKV-6 "Finch" block (arXiv:2404.05892; the port's copy of the JAX
package's ``models/rwkv6.py``): token-shift time mix with data-dependent
decay, and the channel mix.  Attention-free; O(1) state per layer.

Per-channel lerp token shift with LoRA-produced mix coefficients, r/k/v/
gate projections, decay w_t = exp(-exp(w0 + lora(x))), the per-head WKV
recurrence (``kernels/rwkv6_scan``: the rwkv6_scan kernel, B8, on
backend "cuda"), group norm over heads, squared-ReLU channel mix.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import on_row_shards
from repro_torch.kernels.rwkv6_scan.ops import wkv
from repro_torch.models.common import ParamInit, group_norm

LORA_R = 64          # rank of the decay LoRA
MIX_LORA_R = 32      # rank of each of the 5 token-shift streams' LoRA


def init_rwkv_layer(pi: ParamInit, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    f = int(3.5 * d) // 32 * 32
    return {
        "time_mix": {
            # token-shift base mix per stream (r, k, v, w, g)
            "mix_base": pi.zeros((5, d), ("stack", "embed")),
            "mix_lora_a": pi.dense((d, 5 * MIX_LORA_R), ("embed", None),
                                   scale=0.01),
            "mix_lora_b": pi.dense((5 * MIX_LORA_R, 5 * d), (None, None),
                                   scale=0.01),
            "wr": pi.dense((d, d), ("embed", "heads")),
            "wk": pi.dense((d, d), ("embed", "heads")),
            "wv": pi.dense((d, d), ("embed", "heads")),
            "wg": pi.dense((d, d), ("embed", "heads")),
            "wo": pi.dense((d, d), ("heads", "embed")),
            "w0": pi.full((d,), -4.0, ("embed",)),
            "w_lora_a": pi.dense((d, LORA_R), ("embed", None), scale=0.01),
            "w_lora_b": pi.dense((LORA_R, d), (None, "embed"), scale=0.01),
            "u": pi.zeros((h, hd), ("heads", "head_dim")),
            "ln_w": pi.ones((d,), ("embed",)),
            "ln_b": pi.zeros((d,), ("embed",)),
        },
        "channel_mix": {
            "mix_k": pi.zeros((d,), ("embed",)),
            "wk": pi.dense((d, f), ("embed", "mlp")),
            "wv": pi.dense((f, d), ("mlp", "embed")),
            "wr": pi.dense((d, d), ("embed", "embed")),
        },
    }


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros, or the ``last`` carry, at t = 0)."""
    pad = torch.zeros_like(x[:, :1]) if last is None \
        else last[:, None].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def time_mix(params, cfg: ModelConfig, x, *, backend: str = "reference",
             state=None, last_x=None):
    """x: [B, S, D].  Returns (out, (new_state, new_last_x)); ``state`` is
    the [B, H, hd, hd] float32 WKV state of decode (None: the whole
    sequence through ``wkv`` from a zero state, new_state None)."""
    p = params
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    xs = _shift(x, last_x)
    dx = xs - x
    # data-dependent per-stream mix (5 streams: r k v w g)
    lora = torch.tanh(x @ p["mix_lora_a"]) @ p["mix_lora_b"]
    lora = lora.reshape(b, s, 5, d)
    mix = torch.sigmoid(p["mix_base"][None, None] + lora)
    xr, xk, xv, xw, xg = [x + dx * mix[:, :, i] for i in range(5)]

    def heads(y):                     # [B, S, D] -> [B, H, S, hd], a view
        return y.reshape(b, s, h, hd).transpose(1, 2)

    r, k, v = heads(xr @ p["wr"]), heads(xk @ p["wk"]), heads(xv @ p["wv"])
    g = F.silu(xg @ p["wg"])
    logw = p["w0"][None, None] + torch.tanh(xw @ p["w_lora_a"]) \
        @ p["w_lora_b"]
    w = heads(torch.exp(-torch.exp(logw.to(torch.float32))))

    if state is None:
        o = on_row_shards(lambda *a: wkv(*a, backend=backend),  # [B,H,S,hd]
                          (0, 0, 0, 0, None), (1, 1, 1, 1, 0),
                          r, k, v, w, p["u"])
        new_state = None
    else:
        o, new_state = on_row_shards(_wkv_step, (0, 0, 0, 0, None, 0),
                                     (1, 1, 1, 1, 0, 1), r, k, v, w, p["u"],
                                     state, n_out=2)
    o = o.transpose(1, 2).reshape(b, s, d)
    o = group_norm(o, p["ln_w"], p["ln_b"], groups=h, eps=64e-5)
    out = (o * g) @ p["wo"]
    return out, (new_state, x[:, -1])


def _wkv_step(r, k, v, w, u, state):
    """Single-token recurrence for decode: state [B, H, hd, hd]."""
    f32 = torch.float32
    rt, kt, vt, wt = (a[:, :, 0].to(f32) for a in (r, k, v, w))
    kv = kt[..., :, None] * vt[..., None, :]              # [B, H, hd, hd]
    o = torch.einsum("bhij,bhi->bhj", state + u[None, :, :, None] * kv, rt)
    new_state = wt[..., :, None] * state + kv
    return o[:, :, None].to(r.dtype), new_state


def channel_mix(params, x, last_x=None):
    p = params
    xs = _shift(x, last_x)
    xk = x + (xs - x) * torch.sigmoid(p["mix_k"])[None, None]
    k = torch.square(torch.relu(xk @ p["wk"]))
    return torch.sigmoid(x @ p["wr"]) * (k @ p["wv"]), x[:, -1]
