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

On DTensors (the dry run's SPMD half) the query heads may be sharded
over more ranks than there are KV heads (64 query heads over a 16-way
"model" axis, 4 KV heads replicated): grouping the query heads by KV head
would split the sharded head dimension, which DTensor cannot, so there
the keys and values are repeated to the query heads first
(``_kv_at_query_heads``), each rank keeping the heads it holds.  Plain
tensors take the grouped layout.  ``write_rows`` writes a decode token
into the cache, on DTensors into each rank's own shard.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (constrain, group_sum,
                                              is_dtensor, on_local_shards,
                                              on_row_shards)
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


def _kv_at_query_heads(q, k, v):
    """(k, v) as the GQA layout of ``q`` [B, Hq, ...] can take them: as
    they are, unless ``q`` is a DTensor whose head dimension is sharded
    over a number of ranks that does not divide the KV heads; then
    repeated to Hq heads ([B, Hkv, ...] -> [B, Hq, ...], each KV head
    once per query head of its group)."""
    hq, hkv = q.shape[1], k.shape[1]
    if not is_dtensor(q) or hq == hkv:
        return k, v
    mesh = q.device_mesh
    ranks = 1
    for i, p in enumerate(q.placements):
        if p.is_shard(1):
            ranks *= mesh.size(i)
    if hkv % ranks == 0:
        return k, v
    rep = lambda t: t[:, :, None].expand(
        t.shape[0], hkv, hq // hkv, *t.shape[2:]).reshape(
        t.shape[0], hq, *t.shape[2:])
    return rep(k), rep(v)


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
    k, v = _kv_at_query_heads(q, k, v)
    o = on_row_shards(functools.partial(_band, int(window)), (0, 0, 0),
                      (1, 1, 1), q, k, v)
    o = constrain(o, ("batch", "heads", "seq", "head_dim"))
    return _out(o, params["wo"])


def _band(w: int, q, k, v):
    """``banded_attention``'s scores and softmax: q [B, Hq, S, hd], k/v
    [B, Hkv, S, hd] -> [B, Hq, S, hd] in q's dtype."""
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
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
    r = torch.arange(w, device=q.device)[:, None]
    j = torch.arange(2 * w, device=q.device)[None, :]
    rel = j - (r + w)                                  # kpos - qpos
    mask = (rel <= 0) & (rel > -w)
    first = torch.arange(nb, device=q.device)[:, None, None] == 0
    mask = mask[None] & ~(first & (j[None] < w))       # block 0: no prev
    sc = torch.where(mask, sc, -1e30)
    o = torch.softmax(sc, dim=-1) @ band(v)[:, :, None]
    return o.reshape(b, hq, s + pad, hd)[:, :, :s].to(q.dtype)


def _masked_attention(q, k, v, positions, window: int, causal: bool):
    """Reference attention (fills with -1e30, then softmax); on DTensors
    each rank's own rows and heads (``sharding.on_row_shards``)."""
    k, v = _kv_at_query_heads(q, k, v)
    return on_row_shards(functools.partial(_masked_local, window, causal),
                         (0, 0, 0, 0), (1, 1, 1, None), q, k, v, positions)


def _masked_local(window: int, causal: bool, q, k, v, positions):
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qf = (q.to(torch.float32) * (d ** -0.5)).reshape(b, hkv, g, sq, d)
    s = qf @ k.to(torch.float32)[:, :, None].transpose(-1, -2)
    qpos = positions[:, None, None, :, None]
    kpos = positions[:, None, None, None, :]
    mask = kpos <= qpos if causal else None
    if window >= 0:
        inside = kpos > qpos - window
        mask = inside if mask is None else mask & inside
    if mask is not None:
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
    q, k, v = _qkv(params, cfg, x, pos[:, None])
    write_rows(cache_k, pos, k[:, :, 0].to(cache_k.dtype))
    write_rows(cache_v, pos, v[:, :, 0].to(cache_v.dtype))
    o = _decode_attend(q, cache_k, cache_v, pos, window)
    # the cache's head dim may be sharded; the output projection takes
    # the heads' layout (on DTensors; a plain tensor passes)
    o = constrain(o, ("batch", "heads", "seq", "head_dim"))
    return _out(o, params["wo"]), cache_k, cache_v


def _decode_attend(q, cache_k, cache_v, pos, window: int):
    """The decode token's attention over the caches: q [B, Hq, 1, hd]
    -> [B, Hq, 1, hd].  On DTensors each rank attends with its own
    shards (``sharding.on_local_shards``): q and ``pos`` laid out as the
    cache's rows, heads and head dim, and where the head dim is sharded
    the scores are summed over its ranks (``sharding.group_sum``)."""
    hd = cache_k.shape[3]
    if not is_dtensor(cache_k):
        return _decode_local((), hd, window, q, cache_k, cache_v, pos)
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache_k.device_mesh
    q_pl, pos_pl, groups = [], [], []
    for i, p in enumerate(cache_k.placements):
        q_pl.append(Shard(p.dim) if p.is_shard() and p.dim in (0, 1, 3)
                    else Replicate())
        pos_pl.append(Shard(0) if p.is_shard(0) else Replicate())
        if p.is_shard(3):
            groups.append(mesh.get_group(i))
        elif p.is_shard(2):
            raise ValueError("decode attention: the cache's sequence is "
                             "sharded")
    return on_local_shards(
        functools.partial(_decode_local, tuple(groups), hd, window),
        [q_pl, None, None, pos_pl], [q_pl], q, cache_k, cache_v, pos)


def _decode_local(groups, hd: int, window: int, q, cache_k, cache_v, pos):
    """``_decode_attend`` on local tensors; ``hd`` is the whole head dim
    (the scale), the scores summed over the process ``groups``."""
    b, hq = q.shape[0], q.shape[1]
    hkv, s_max, hd_l = cache_k.shape[1], cache_k.shape[2], cache_k.shape[3]
    g = hq // hkv
    qf = (q.to(torch.float32) * (hd ** -0.5)).reshape(b, hkv, g, hd_l)
    s = qf @ cache_k.to(torch.float32).transpose(-1, -2)   # [B,Hkv,G,S]
    for grp in groups:
        s = group_sum(s, grp)
    kpos = torch.arange(s_max, device=q.device)[None, None, None, :]
    pp = pos[:, None, None, None]
    ok = kpos <= pp
    if window >= 0:
        ok &= kpos > (pp - window)
    s = torch.where(ok, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = p @ cache_v.to(torch.float32)                       # [B,Hkv,G,hd]
    return o.reshape(b, hq, 1, hd_l).to(q.dtype)


def write_rows(cache, pos, val) -> None:
    """``cache[b, :, pos[b]] = val[b]`` for every row b, IN PLACE: cache
    [B, H, S_max, hd], pos [B], val [B, H, hd].  On DTensors each rank
    writes its own shard (``sharding.on_local_shards``), ``pos`` and
    ``val`` laid out as the cache's rows and columns first."""
    if not is_dtensor(cache):
        cache[torch.arange(cache.shape[0], device=cache.device), :,
              pos.to(torch.int64)] = val
        return
    from torch.distributed.tensor import Replicate, Shard
    if any(p.is_shard(2) for p in cache.placements):
        raise ValueError("write_rows: the cache's sequence is sharded")
    row = [Shard(0) if p.is_shard(0) else Replicate()
           for p in cache.placements]
    col = [Shard(p.dim - 1) if p.is_shard() and p.dim > 0 else r
           for p, r in zip(cache.placements, row)]

    def local(c, p, v):
        c[torch.arange(c.shape[0], device=c.device), :,
          p.to(torch.int64)] = v
        return c

    on_local_shards(local, [cache.placements, row, col],
                    [cache.placements], cache, pos, val)


def init_cross_attention(pi: ParamInit, cfg: ModelConfig) -> dict:
    return init_attention(pi, cfg)


def _softmax_attend(q, k, v):
    """Unmasked GQA softmax attention in float32: q [B, Hq, Sq, hd], k/v
    [B, Hkv, Sk, hd] -> [B, Hq, Sq, hd] in q's dtype."""
    k, v = _kv_at_query_heads(q, k, v)
    return on_row_shards(_softmax_local, (0, 0, 0), (1, 1, 1), q, k, v)


def _softmax_local(q, k, v):
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
