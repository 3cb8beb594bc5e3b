"""GQA attention layers: the train/prefill path and the decode path with a
dense KV cache (the port's copy of the JAX package's
``models/attention.py``, for the dense family).

Sharding constraints (``constrain``) have no counterpart: the port runs
on one device.  ``attention`` takes its window as a Python int, so
backend "cuda" runs the flash_attention kernel (B7) in every layer,
windowed or global.  The banded and cross-attention paths wait for the
families that use them (ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models.common import ParamInit, apply_rope


def init_attention(pi: ParamInit, cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    tree = {
        "wq": pi.dense((d, cfg.n_heads, hd)),
        "wk": pi.dense((d, cfg.n_kv_heads, hd)),
        "wv": pi.dense((d, cfg.n_kv_heads, hd)),
        "wo": pi.dense((cfg.n_heads, hd, d),
                       scale=1.0 / (cfg.n_heads * hd) ** 0.5),
    }
    if cfg.qkv_bias:
        tree["bq"] = pi.zeros((cfg.n_heads, hd))
        tree["bk"] = pi.zeros((cfg.n_kv_heads, hd))
        tree["bv"] = pi.zeros((cfg.n_kv_heads, hd))
    return tree


def _proj(x, w):
    """einsum("bsd,dhk->bhsk", x, w) as one matmul: [B, H, S, hd] (a
    transposed view)."""
    b, s, _ = x.shape
    _, h, hd = w.shape
    return (x @ w.reshape(w.shape[0], h * hd)).view(b, s, h, hd) \
        .transpose(1, 2)


def _out(o, wo):
    """einsum("bhsk,hkd->bsd", o, wo) as one matmul."""
    b, h, s, hd = o.shape
    return o.transpose(1, 2).reshape(b, s, h * hd) @ wo.reshape(h * hd, -1)


def _qkv(params, cfg: ModelConfig, x, positions):
    """x: [B, S, D] -> q [B, Hq, S, hd], k/v [B, Hkv, S, hd], RoPE
    applied."""
    if cfg.m_rope:
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP Queue "
                                  "1, item 12: the vlm family)")
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"][None, :, None, :]
        k = k + params["bk"][None, :, None, :]
        v = v + params["bv"][None, :, None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(params, cfg: ModelConfig, x, positions, window: int, *,
              causal: bool = True, backend: str = "reference"):
    """Train/prefill self-attention; ``window`` -1 is global.  Backend
    "reference" is the masked softmax over ``positions``; any other
    backend goes through ``flash_attention.ops.mha`` (B7), which, as in
    the JAX package, takes the rows as right-aligned contiguous
    positions."""
    q, k, v = _qkv(params, cfg, x, positions)
    if backend == "reference":
        o = _masked_attention(q, k, v, positions, window, causal)
    else:
        o = mha(q, k, v, causal=causal, window=int(window), backend=backend)
    return _out(o, params["wo"])


def _masked_attention(q, k, v, positions, window: int, causal: bool):
    """Reference attention (fills with -1e30, then softmax)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qf = (q.to(torch.float32) * (d ** -0.5)).reshape(b, hkv, g, sq, d)
    s = qf @ k.to(torch.float32)[:, :, None].transpose(-1, -2)
    qpos = positions[:, None, None, :, None]
    kpos = positions[:, None, None, None, :]
    mask = torch.ones((b, 1, 1, sq, sq), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window >= 0:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = p @ v.to(torch.float32)[:, :, None]
    return o.reshape(b, hq, sq, d).to(q.dtype)


def decode_attention_dense(params, cfg: ModelConfig, x, cache_k, cache_v,
                           pos, window: int):
    """One-token decode against a dense KV cache.

    x: [B, 1, D]; cache_k/v: [B, Hkv, S_max, hd]; pos: [B] current
    length.  Writes the new token's K/V into the caches IN PLACE and
    returns (out [B, 1, D], cache_k, cache_v)."""
    b = x.shape[0]
    hkv, s_max, hd = cache_k.shape[1], cache_k.shape[2], cache_k.shape[3]
    q, k, v = _qkv(params, cfg, x, pos[:, None])
    bidx = torch.arange(b, device=x.device)
    pl = pos.to(torch.int64)
    cache_k[bidx, :, pl] = k[:, :, 0].to(cache_k.dtype)
    cache_v[bidx, :, pl] = v[:, :, 0].to(cache_v.dtype)
    g = cfg.n_heads // hkv
    qf = (q.to(torch.float32) * (hd ** -0.5)).reshape(b, hkv, g, hd)
    s = qf @ cache_k.to(torch.float32).transpose(-1, -2)   # [B,Hkv,G,S]
    kpos = torch.arange(s_max, device=x.device)[None, None, None, :]
    pp = pos[:, None, None, None]
    ok = kpos <= pp
    if window >= 0:
        ok &= kpos > (pp - window)
    s = torch.where(ok, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = p @ cache_v.to(torch.float32)                       # [B,Hkv,G,hd]
    o = o.reshape(b, cfg.n_heads, 1, hd).to(x.dtype)
    return _out(o, params["wo"]), cache_k, cache_v
