"""GQA attention layers: the train/prefill path, the decode path with a
dense KV cache, and whisper's cross-attention (the port's copy of the
JAX package's ``models/attention.py``).

Sharding constraints (``constrain``) have no counterpart: the port runs
on one device.  ``attention`` takes its window as a Python int, so
backend "cuda" runs the flash_attention kernel (B7) in every layer,
windowed or global, causal or not.  Cross-attention is plain PyTorch, as
the JAX package computes it outside any kernel.  Banded attention waits
for the dry run that uses it (ROADMAP Queue 1, G).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models.common import ParamInit, apply_m_rope, apply_rope


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
    """x: [B, S, D] -> q [B, Hq, S, hd], k/v [B, Hkv, S, hd], RoPE (or
    M-RoPE) applied.  With M-RoPE, ``positions`` is [B, S, 3], or [B, S]
    for text-only decode (t = h = w = pos)."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"][None, :, None, :]
        k = k + params["bk"][None, :, None, :]
        v = v + params["bv"][None, :, None, :]
    if cfg.m_rope:
        if positions.dim() == 2:
            positions = positions[..., None].expand(*positions.shape, 3)
        q = apply_m_rope(q, positions, cfg.m_rope_sections, cfg.rope_theta)
        k = apply_m_rope(k, positions, cfg.m_rope_sections, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(params, cfg: ModelConfig, x, positions, window: int, *,
              causal: bool = True, backend: str = "reference"):
    """Train/prefill self-attention; ``window`` -1 is global.  Backend
    "reference" is the masked softmax over ``positions`` (the temporal
    stream ``positions[..., 0]`` when they are M-RoPE's [B, S, 3]); any
    other backend goes through ``flash_attention.ops.mha`` (B7), which,
    as in the JAX package, takes the rows as right-aligned contiguous
    positions.  The two agree while the positions are contiguous."""
    q, k, v = _qkv(params, cfg, x, positions)
    if backend == "reference":
        pos1d = positions[..., 0] if positions.dim() == 3 else positions
        o = _masked_attention(q, k, v, pos1d, window, causal)
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


def init_cross_attention(pi: ParamInit, cfg: ModelConfig) -> dict:
    return init_attention(pi, cfg)


def _softmax_attend(q, k, v):
    """Unmasked GQA softmax attention in float32: q [B, Hq, Sq, hd], k/v
    [B, Hkv, Sk, hd] -> [B, Hq, Sq, hd] in q's dtype."""
    b, hq, sq, hd = q.shape
    hkv = k.shape[1]
    qf = (q.to(torch.float32) * hd ** -0.5).reshape(b, hkv, hq // hkv, sq,
                                                    hd)
    s = qf @ k.to(torch.float32)[:, :, None].transpose(-1, -2)
    p = torch.softmax(s, dim=-1)
    o = p @ v.to(torch.float32)[:, :, None]
    return o.reshape(b, hq, sq, hd).to(q.dtype)


def cross_attention_cached(params, cfg: ModelConfig, x, xk, xv):
    """Decode-step cross-attention: q from x [B, 1, D]; xk/xv the encoder's
    precomputed projections [B, Hkv, S_enc, hd] (read-only once written:
    the classic cold KV of a tiered cache).  No bias, no RoPE."""
    q = _proj(x, params["wq"])
    o = _softmax_attend(q, xk, xv).to(x.dtype)
    return _out(o, params["wo"])


def cross_attention(params, cfg: ModelConfig, x, enc_out):
    """Decoder cross-attention (whisper): queries from x [B, S, D], keys
    and values from the encoder's output [B, S_enc, D].  No bias, no
    RoPE."""
    q = _proj(x, params["wq"])
    k = _proj(enc_out, params["wk"])
    v = _proj(enc_out, params["wv"])
    return _out(_softmax_attend(q, k, v).to(x.dtype), params["wo"])
