"""Shared model building blocks: norms, RoPE, FFN and parameter init (the
port's own copy of the JAX package's ``models/common.py``).

Parameters are plain nested dicts of tensors in the JAX package's layouts
(``wq`` [D, Hq, hd], ``wo`` [Hq, hd, D], ``w_gate`` [D, F], ...), so the
tests can carry the JAX package's parameters across (``model.
params_from_numpy``).  Every init call names its leaf's logical axes, as
the JAX ``ParamFactory`` does: ``ParamInit`` draws the tensor and drops
them, ``SpecInit`` returns them instead, so one init function gives both
the parameters (``model.init_params``) and their logical-axis specs
(``model.param_specs``), which ``distributed/sharding.py`` maps onto a
mesh.  ``init_params`` draws from an explicit ``torch.Generator`` with
the JAX ``ParamFactory``'s shapes and scales; the draws are not
``jax.random``'s bits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# ------------------------------------------------------------------- init


class ParamInit:
    """Draws parameters on ``device`` from ``generator`` (which must live
    on that device; None on the meta device): dense weights N(0, 1) /
    sqrt(fan_in) unless a scale is given, embeddings N(0, 1) * 0.02,
    norms one, biases zero.  ``logical`` (the leaf's logical axis names)
    is not read: ``SpecInit`` returns it."""

    def __init__(self, generator: torch.Generator | None,
                 device: torch.device, dtype=torch.float32):
        self.gen, self.device, self.dtype = generator, device, dtype

    def _normal(self, shape, scale: float) -> torch.Tensor:
        w = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=self.dtype)
        return w.mul_(scale)

    def dense(self, shape, logical, scale: float | None = None):
        return self._normal(shape, scale if scale is not None
                            else 1.0 / math.sqrt(shape[0]))

    def embed(self, shape, logical, scale: float = 0.02):
        return self._normal(shape, scale)

    def zeros(self, shape, logical):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, shape, logical):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def full(self, shape, value: float, logical):
        return torch.full(shape, value, device=self.device, dtype=self.dtype)

    def const(self, value: torch.Tensor, logical):
        """A copy of ``value`` in the init's dtype, on its device."""
        return value.to(device=self.device, dtype=self.dtype).clone()


class SpecInit:
    """``ParamInit``'s interface, returning each leaf's logical axis names
    (a tuple of str or None, one per dimension) instead of a tensor."""

    def dense(self, shape, logical, scale=None):
        return tuple(logical)

    def embed(self, shape, logical, scale=None):
        return tuple(logical)

    def zeros(self, shape, logical):
        return tuple(logical)

    ones = zeros

    def full(self, shape, value, logical):
        return tuple(logical)

    def const(self, value, logical):
        return tuple(logical)


def init_ffn(pi: ParamInit, d_model: int, d_ff: int, kind: str) -> dict:
    if kind == "swiglu":
        return {"w_gate": pi.dense((d_model, d_ff), ("embed", "mlp")),
                "w_up": pi.dense((d_model, d_ff), ("embed", "mlp")),
                "w_down": pi.dense((d_ff, d_model), ("mlp", "embed"))}
    return {"w_up": pi.dense((d_model, d_ff), ("embed", "mlp")),
            "b_up": pi.zeros((d_ff,), ("mlp",)),
            "w_down": pi.dense((d_ff, d_model), ("mlp", "embed")),
            "b_down": pi.zeros((d_model,), ("embed",))}


def init_norm(pi: ParamInit, d: int, kind: str) -> dict:
    if kind == "rms":
        return {"w": pi.ones((d,), ("embed",))}
    return {"w": pi.ones((d,), ("embed",)), "b": pi.zeros((d,), ("embed",))}


# ------------------------------------------------------------------- norms

def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * weight.to(torch.float32)).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.to(torch.float32) + bias.to(torch.float32)).to(dt)


def group_norm(x, weight, bias, groups: int, eps: float = 1e-5):
    """x: [..., d]; normalise within ``groups`` channel groups (float32
    statistics, biased variance), output in x's dtype."""
    dt = x.dtype
    *lead, d = x.shape
    x = x.to(torch.float32).reshape(*lead, groups, d // groups)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = ((x - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    return (y * weight.to(torch.float32) + bias.to(torch.float32)).to(dt)


def norm(params, x, kind: str, eps: float):
    if kind == "rms":
        return rms_norm(x, params["w"], eps)
    return layer_norm(x, params["w"], params["b"], eps)


# -------------------------------------------------------------------- rope

def rope_freqs(d_head: int, theta: float = 10000.0, device=None):
    exp = torch.arange(0, d_head, 2, dtype=torch.float32,
                       device=device) / d_head
    return 1.0 / (theta ** exp)


def _rotate(x, ang):
    """Rotate the pairs (even, odd) of x [B, H, S, D] by ang [B, 1, S,
    D/2]."""
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [B, H, S, D]; positions: [B, S] (int).  Rotates the pairs
    (even, odd)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)             # [D/2]
    return _rotate(x, positions[:, None, :, None].to(torch.float32) * inv)


def apply_m_rope(x, positions3, sections, theta: float = 10000.0):
    """Qwen2-VL's M-RoPE: x [B, H, S, D]; positions3 [B, S, 3], the (t, h,
    w) ids.  The rotary pairs split into ``sections`` (t, h, w), each
    rotated by its own position stream."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                       # [D/2]
    s0, s1, _ = sections
    idx = torch.arange(d // 2, device=x.device)
    sec = torch.where(idx < s0, 0, torch.where(idx < s0 + s1, 1, 2))
    pos = positions3.to(torch.float32)[..., sec]               # [B,S,D/2]
    return _rotate(x, pos[:, None] * inv)


# --------------------------------------------------------------------- ffn

def ffn(params, x, kind: str, act: str = "silu"):
    actf = F.silu if act == "silu" else (
        lambda h: F.gelu(h, approximate="tanh"))   # jax.nn.gelu's default
    if kind == "swiglu":
        h = actf(x @ params["w_gate"]) * (x @ params["w_up"])
        return h @ params["w_down"]
    h = actf(x @ params["w_up"] + params["b_up"])
    return h @ params["w_down"] + params["b_down"]
