"""GQA attention layers: the train/prefill path, the decode path with a
dense KV cache, and whisper's cross-attention (the port's copy of the
JAX package's ``models/attention.py``).

The sharding constraints (``distributed/sharding.constrain``) sit where
the JAX package puts them; they change nothing but a DTensor on the
ambient mesh.  ``attention`` takes its window as a Python int, so
backend "cuda" runs the flash_attention kernel (B7) in every layer,
windowed or global, causal or not.  Cross-attention is plain PyTorch, as
the JAX package computes it outside any kernel, and so is
``banded_attention``, the S x 2w band that the banded forward gives the
local layers (``model._forward_banded``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models.common import ParamInit, apply_m_rope, apply_rope


def init_attention(pi: ParamInit, cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    tree = {
        "wq": pi.dense((d, cfg.n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": pi.dense((d, cfg.n_kv_heads, hd),
                       ("embed", "kv_heads", "head_dim")),
        "wv": pi.dense((d, cfg.n_kv_heads, hd),
                       ("embed", "kv_heads", "head_dim")),
        "wo": pi.dense((cfg.n_heads, hd, d), ("heads", "head_dim", "embed"),
                       scale=1.0 / (cfg.n_heads * hd) ** 0.5),
    }
    if cfg.qkv_bias:
        tree["bq"] = pi.zeros((cfg.n_heads, hd), ("heads", "head_dim"))
        tree["bk"] = pi.zeros((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"))
        tree["bv"] = pi.zeros((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"))
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
    q = constrain(q, ("batch", "heads", "seq", "head_dim"))
    k = constrain(k, ("batch", "kv_heads", "seq", "head_dim"))
    if backend == "reference":
        pos1d = positions[..., 0] if positions.dim() == 3 else positions
        o = _masked_attention(q, k, v, pos1d, window, causal)
    else:
        o = mha(q, k, v, causal=causal, window=int(window), backend=backend)
    o = constrain(o, ("batch", "heads", "seq", "head_dim"))
    return _out(o, params["wo"])


def banded_attention(params, cfg: ModelConfig, x, positions, window: int):
    """Causal local attention computed in a 2w band (the JAX package's
    ``banded_attention``): the rows padded to a multiple of w, query
    block i attends key blocks {i-1, i}, masked to the w keys at or
    before each query, so the scores are S x 2w instead of S x S.  Plain
    PyTorch, float32 scores.  Assumes contiguous positions (0, 1, ...,
    S - 1 in every row): the mask reads row offsets, not ``positions``,
    which only rotate q and k."""
    q, k, v = _qkv(params, cfg, x, positions)
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    w = int(window)
    pad = (-s) % w
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    nb = (s + pad) // w
    qb = (q.to(torch.float32) * hd ** -0.5) \
        .reshape(b, hkv, hq // hkv, nb, w, hd)

    def band(t):                      # [b, hkv, nb, 2w, hd]: blocks i-1, i
        t = t.to(torch.float32).reshape(b, hkv, nb, w, hd)
        prev = torch.cat([torch.zeros_like(t[:, :, :1]), t[:, :, :-1]], 2)
        return torch.cat([prev, t], dim=3)

    sc = qb @ band(k)[:, :, None].transpose(-1, -2)   # [b,hkv,g,nb,w,2w]
    r = torch.arange(w, device=x.device)[:, None]
    j = torch.arange(2 * w, device=x.device)[None, :]
    rel = j - (r + w)                                  # kpos - qpos
    mask = (rel <= 0) & (rel > -w)
    first = torch.arange(nb, device=x.device)[:, None, None] == 0
    mask = mask[None] & ~(first & (j[None] < w))       # block 0: no prev
    sc = torch.where(mask, sc, -1e30)
    o = torch.softmax(sc, dim=-1) @ band(v)[:, :, None]
    o = o.reshape(b, hq, s + pad, hd)[:, :, :s].to(x.dtype)
    o = constrain(o, ("batch", "heads", "seq", "head_dim"))
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
