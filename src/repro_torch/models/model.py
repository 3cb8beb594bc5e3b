"""The model: init / forward / loss / decode for the dense, moe, ssm
(rwkv6), hybrid (jamba), vlm (qwen2-vl, M-RoPE) and audio (whisper,
encoder-decoder) families (the port's copy of the JAX package's
``models/model.py``).

Parameters are a dict: ``embed`` [V, D], ``final_norm``, ``lm_head`` when
embeddings are untied, and ``blocks``, a list with one dict per layer in
the JAX package's layouts: ``mixer`` (attention wq/wk/wv/wo, mamba's
in_proj ... out_proj, or rwkv's ``time_mix`` and ``channel_mix``: the
channel mix is its ffn), ``ffn`` (SwiGLU, or the MoE router and
experts), ``ln1``, ``ln2``.  ``params_from_numpy`` carries a JAX
parameter pytree across: stacked [L, ...] blocks, or the hybrid
family's superblocks ``blocks["pos{i}"]`` stacked [L / period, ...].
The audio family adds ``enc_blocks`` (stacked [L_enc, ...] in JAX),
``enc_final_norm``, and in each decoder block ``cross`` (wq/wk/wv/wo)
and ``ln_cross``.  The JAX package scans its layers (the hybrid family
by superblocks of its 8-layer pattern); here the layers are a Python
loop and each window is a Python int (``cfg.layer_windows``; -1 in the
hybrid and audio families, as there), so backend "cuda" runs the
flash_attention kernel (B7) in every attention layer (whisper's
encoder layers non-causal), the rwkv6_scan kernel (B8) in every rwkv
layer and the mamba_scan kernel (B9) in every mamba layer.

``forward`` and ``loss_fn`` are differentiable (the trainer takes its
gradients through them with ``torch.autograd``); with ``remat`` each
block runs under ``torch.utils.checkpoint``, as the JAX package wraps
its scanned blocks in ``jax.checkpoint``.  The decode paths run under
``torch.no_grad``.

With ``banded_local`` (the dry run's opt variant) and a window pattern
that mixes windows, the uniform families take ``_forward_banded``: the
layers in superblocks of ``len(window_pattern)`` (each recomputed whole
with ``remat``, as JAX checkpoints its scanned superblock) plus the
tail; each local layer takes ``attention.banded_attention``, the S x 2w
band, plain PyTorch as in the JAX package, which assumes contiguous
positions; each global layer takes ``attention.attention`` on the
backend (B7 on "cuda").  The hybrid family ignores ``banded_local``, as
in JAX.

The sharding constraints (``distributed/sharding.constrain``) sit where
the JAX package puts them, on the embeddings and the logits; they change
nothing but a DTensor on the ambient mesh.  On DTensors (the dry run's
SPMD half) the activations stay DTensors from the embedding lookup to
the logits, and the positions the forward makes are laid out as the
batch (``sharding.batch_like``).

``param_specs`` and ``cache_specs`` give the logical-axis specs of the
parameters and the decode cache without a tensor: the specs JAX's
``init_params`` and ``init_cache`` return beside their arrays, the
parameters' in the port's per-layer tree (no "layers" axis).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.core.tree import leaves
from repro_torch.distributed.sharding import (batch_like, constrain,
                                              embedding_lookup, vocab_gather,
                                              vocab_logsumexp)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import (ParamInit, SpecInit, ffn, init_ffn,
                                       init_norm, norm)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run: an unknown family."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.name}: unknown family "
                                  f"{cfg.family!r}")


def layer_plan(cfg: ModelConfig) -> list:
    """(kind, use_moe, window) of every layer, as the JAX package's scans
    give them: the hybrid family tiles its pattern, with MoE at the
    pattern positions i where i % moe_every == moe_every - 1 and the
    window -1; the uniform families use one kind, MoE in every layer when
    moe_every is 1, and ``cfg.layer_windows``."""
    if cfg.family == "hybrid":
        period = len(cfg.pattern)
        return [(cfg.pattern[l % period], cfg.moe and (
            (l % period) % cfg.moe_every == cfg.moe_every - 1), -1)
            for l in range(cfg.n_layers)]
    kind = "rwkv" if cfg.family == "ssm" else "attn"
    use_moe = cfg.moe and cfg.moe_every == 1
    return [(kind, use_moe, int(w)) for w in cfg.layer_windows]


# ------------------------------------------------------------------- init

def _init_block(pi: ParamInit, cfg: ModelConfig, kind: str,
                use_moe: bool) -> dict:
    init_mixer = {"attn": attn_mod.init_attention,
                  "mamba": mamba_mod.init_mamba_layer,
                  "rwkv": rwkv_mod.init_rwkv_layer}[kind]
    tree = {"mixer": init_mixer(pi, cfg)}
    if use_moe:
        tree["ffn"] = moe_mod.init_moe(pi, cfg)
    elif kind != "rwkv":              # rwkv's channel mix is its ffn
        tree["ffn"] = init_ffn(pi, cfg.d_model, cfg.d_ff, cfg.ffn_kind)
    tree["ln1"] = init_norm(pi, cfg.d_model, cfg.norm_kind)
    tree["ln2"] = init_norm(pi, cfg.d_model, cfg.norm_kind)
    return tree


def _build_params(cfg: ModelConfig, pi) -> dict:
    """The parameter tree, each leaf from ``pi`` (a ``ParamInit``: tensors;
    a ``SpecInit``: logical specs)."""
    params = {"embed": pi.embed((cfg.vocab, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        params["lm_head"] = pi.dense((cfg.d_model, cfg.vocab),
                                     ("embed", "vocab"))
    params["final_norm"] = init_norm(pi, cfg.d_model, cfg.norm_kind)
    params["blocks"] = [_init_block(pi, cfg, kind, use_moe)
                        for kind, use_moe, _ in layer_plan(cfg)]
    if cfg.family == "audio":
        params["enc_blocks"] = [_init_block(pi, cfg, "attn", False)
                                for _ in range(cfg.enc_layers)]
        for blk in params["blocks"]:
            blk["cross"] = attn_mod.init_cross_attention(pi, cfg)
            blk["ln_cross"] = init_norm(pi, cfg.d_model, cfg.norm_kind)
        params["enc_final_norm"] = init_norm(pi, cfg.d_model, cfg.norm_kind)
    return params


def init_params(cfg: ModelConfig, generator: torch.Generator | None,
                dtype=torch.float32, device=None) -> dict:
    """Random parameters with the JAX ``init_params``'s shapes and scales,
    drawn from ``generator`` on ``device`` (None: the card; raises without
    one).  The generator must live on that device (None on "meta", where
    the tensors hold no values)."""
    check_supported(cfg)
    return _build_params(cfg, ParamInit(generator, resolve_device(device),
                                        dtype))


def param_specs(cfg: ModelConfig) -> dict:
    """The logical-axis spec of every parameter, in the tree
    ``init_params`` returns (each block its own dict, so no "layers"
    axis: JAX stacks the blocks and puts "layers" first)."""
    check_supported(cfg)
    return _build_params(cfg, SpecInit())


def params_from_numpy(cfg: ModelConfig, tree, device=None) -> dict:
    """A JAX parameter pytree (numpy leaves; ``blocks`` stacked [L, ...]
    and the audio family's ``enc_blocks`` stacked [L_enc, ...], or for
    the hybrid family ``blocks["pos{i}"]`` stacked [L / period, ...]) ->
    the port's parameters on ``device`` (None: the card), one dict per
    layer (layer ``blk * period + i`` from ``pos{i}[blk]``).  Copies
    every leaf."""
    check_supported(cfg)
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    def layer(x, i):
        if isinstance(x, dict):
            return {k: layer(v, i) for k, v in x.items()}
        return torch.from_numpy(np.array(x[i], copy=True)).to(dev)

    out = {k: conv(v) for k, v in tree.items()
           if k not in ("blocks", "enc_blocks")}
    if cfg.family == "audio":
        out["enc_blocks"] = [layer(tree["enc_blocks"], i)
                             for i in range(cfg.enc_layers)]
    if cfg.family == "hybrid":
        period = len(cfg.pattern)
        out["blocks"] = [layer(tree["blocks"][f"pos{l % period}"],
                               l // period) for l in range(cfg.n_layers)]
    else:
        out["blocks"] = [layer(tree["blocks"], i)
                         for i in range(cfg.n_layers)]
    return out


# ---------------------------------------------------------------- forward

def _block_apply(cfg: ModelConfig, p, x, positions, window: int,
                 kind: str, use_moe: bool, backend: str,
                 banded: bool = False):
    """One block.  Returns (x, extras): the MoE layer's ``aux_loss``,
    ``dropped`` and ``experts`` (each token's top-k) when ``use_moe``,
    else {}.  ``banded``: a windowed attention layer takes the S x 2w
    band (``attention.banded_attention``)."""
    h = norm(p["ln1"], x, cfg.norm_kind, cfg.norm_eps)
    if kind == "attn" and banded and window > 0:
        mix = attn_mod.banded_attention(p["mixer"], cfg, h, positions,
                                        window)
    elif kind == "attn":
        mix = attn_mod.attention(p["mixer"], cfg, h, positions, window,
                                 backend=backend)
    elif kind == "mamba":
        mix, _ = mamba_mod.mamba_layer(p["mixer"], cfg, h, backend=backend)
    else:                             # rwkv time mix
        mix, _ = rwkv_mod.time_mix(p["mixer"]["time_mix"], cfg, h,
                                   backend=backend)
    x = _residual(x, mix)
    h = norm(p["ln2"], x, cfg.norm_kind, cfg.norm_eps)
    extras = {}
    if kind == "rwkv":
        out, _ = rwkv_mod.channel_mix(p["mixer"]["channel_mix"], h)
    elif use_moe:
        out, extras = moe_mod.moe_ffn(p["ffn"], cfg, h)
    else:
        out = ffn(p["ffn"], h, cfg.ffn_kind, cfg.act)
    return _residual(x, out), extras


def _residual(x, y):
    """x + y, held to the embeddings' layout (a DTensor's only)."""
    return constrain(x + y, ("batch", "seq", "embed"))


def _arange_positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _positions_of(x) -> torch.Tensor:
    """Positions 0 .. S - 1 of every row of x [B, S, ...], laid out as
    x's batch."""
    return batch_like(_arange_positions(*x.shape[:2], x.device), x)


def _embed(params, tokens):
    """The embedding rows of ``tokens`` (``sharding.embedding_lookup``)."""
    return embedding_lookup(params["embed"], tokens.to(torch.int64))


def _lm_logits(cfg: ModelConfig, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return constrain(x @ head, ("batch", "seq", "vocab"))


def _tracks_grad(*trees) -> bool:
    """True when autograd records a graph of these inputs: grad mode is
    on and a leaf requires grad."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for tree in trees for t in leaves(tree))


def _remat(on: bool, fn, *args):
    """``fn(*args)``; with ``on``, its activations are recomputed in the
    backward pass instead of kept (the JAX package's ``jax.checkpoint`` of
    each scanned block).  The model draws no random numbers, so no RNG
    state is saved."""
    if on:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def forward(cfg: ModelConfig, params, batch: dict, *,
            backend: str = "reference", remat: bool = True):
    """batch: ``tokens`` [B, S], or ``embeds`` [B, S, D] (the vlm stub
    frontend's patch embeddings), and optionally ``positions`` [B, S]
    (M-RoPE: [B, S, 3]; the mamba and rwkv layers read none); the audio
    family takes ``enc_embeds`` [B, S_enc, D] and decoder ``tokens``.
    Returns (logits [B, S, V], aux), aux the float32 sum of the MoE
    layers' load-balancing losses (zero without MoE).  Differentiable:
    with ``remat`` and a graph being recorded (grad mode on and a
    parameter or input that requires grad), each block is recomputed in
    the backward pass; otherwise no block is wrapped."""
    check_supported(cfg)
    remat = remat and _tracks_grad(params, batch)
    if cfg.family == "audio":
        return _forward_encdec(cfg, params, batch, backend, remat)
    if "embeds" in batch:
        x = batch["embeds"].to(params["embed"].dtype)
    else:
        x = _embed(params, batch["tokens"])
    x = constrain(x, ("batch", "seq", "embed"))
    positions = batch.get("positions")
    if positions is None:
        positions = _positions_of(x)
    if (cfg.family != "hybrid" and cfg.banded_local
            and len(set(cfg.window_pattern)) > 1):
        return _forward_banded(cfg, params, x, positions, backend, remat)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, (kind, use_moe, window) in zip(params["blocks"],
                                          layer_plan(cfg)):
        x, extras = _remat(remat, _block_apply, cfg, p, x, positions,
                           window, kind, use_moe, backend)
        if use_moe:
            aux = aux + extras["aux_loss"].to(torch.float32)
    x = norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return _lm_logits(cfg, params, x), aux


def _banded_layers(cfg: ModelConfig, blocks, x, positions, lo: int,
                   backend: str):
    """Layers lo, lo + 1, ... (one per block of ``blocks``) of the banded
    forward.  Returns (x, the float32 sum of their MoE aux losses)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    plan = layer_plan(cfg)
    for l, p in enumerate(blocks, lo):
        kind, use_moe, window = plan[l]
        x, extras = _block_apply(cfg, p, x, positions, window, kind,
                                 use_moe, backend, banded=True)
        if use_moe:
            aux = aux + extras["aux_loss"].to(torch.float32)
    return x, aux


def _forward_banded(cfg: ModelConfig, params, x, positions, backend: str,
                    remat: bool):
    """JAX's ``_forward_banded``: n_full superblocks of
    ``len(window_pattern)`` layers (each recomputed whole in the backward
    pass with ``remat``), then the tail layers; local layers take the
    band (contiguous positions assumed), global ones ``attention`` on the
    backend.  Returns (logits, aux)."""
    period = len(cfg.window_pattern)
    n_full = cfg.n_layers // period
    blocks = params["blocks"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for sb in range(n_full):
        lo = sb * period
        x, a = _remat(remat, _banded_layers, cfg, blocks[lo:lo + period], x,
                      positions, lo, backend)
        aux = aux + a
    x, a = _banded_layers(cfg, blocks[n_full * period:], x, positions,
                          n_full * period, backend)
    x = norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return _lm_logits(cfg, params, x), aux + a


def _enc_block(cfg: ModelConfig, blk, x, pos, backend: str):
    """One whisper encoder block: non-causal self-attention (B7 on
    backend "cuda"), then the MLP."""
    h = norm(blk["ln1"], x, cfg.norm_kind, cfg.norm_eps)
    x = _residual(x, attn_mod.attention(blk["mixer"], cfg, h, pos, -1,
                                        causal=False, backend=backend))
    h = norm(blk["ln2"], x, cfg.norm_kind, cfg.norm_eps)
    return _residual(x, ffn(blk["ffn"], h, cfg.ffn_kind, cfg.act))


def _dec_block(cfg: ModelConfig, blk, x, pos, enc, backend: str):
    """One whisper decoder block: causal self-attention (B7 on backend
    "cuda"), cross-attention to the encoder's output ``enc``, the MLP."""
    h = norm(blk["ln1"], x, cfg.norm_kind, cfg.norm_eps)
    x = _residual(x, attn_mod.attention(blk["mixer"], cfg, h, pos, -1,
                                        backend=backend))
    h = norm(blk["ln_cross"], x, cfg.norm_kind, cfg.norm_eps)
    x = _residual(x, attn_mod.cross_attention(blk["cross"], cfg, h, enc))
    h = norm(blk["ln2"], x, cfg.norm_kind, cfg.norm_eps)
    return _residual(x, ffn(blk["ffn"], h, cfg.ffn_kind, cfg.act))


def _encode(cfg: ModelConfig, params, enc_embeds, backend: str,
            remat: bool = False):
    """Whisper's encoder over the stub frontend's frame embeddings
    [B, S_enc, D]: every encoder block (each recomputed in the backward
    pass with ``remat``), then ``enc_final_norm``."""
    x = enc_embeds.to(params["embed"].dtype)
    pos = _positions_of(x)
    for blk in params["enc_blocks"]:
        x = _remat(remat, _enc_block, cfg, blk, x, pos, backend)
    return norm(params["enc_final_norm"], x, cfg.norm_kind, cfg.norm_eps)


def _forward_encdec(cfg: ModelConfig, params, batch, backend: str,
                    remat: bool = False):
    """Whisper: the encoder (``_encode``), then the causal decoder over
    ``batch["tokens"]`` with cross-attention to the encoder's output in
    every block (each recomputed in the backward pass with ``remat``).
    aux is zero."""
    enc = _encode(cfg, params, batch["enc_embeds"], backend, remat)
    x = constrain(_embed(params, batch["tokens"]), ("batch", "seq", "embed"))
    pos = _positions_of(x)
    for blk in params["blocks"]:
        x = _remat(remat, _dec_block, cfg, blk, x, pos, enc, backend)
    x = norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return _lm_logits(cfg, params, x), torch.zeros(
        (), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ModelConfig, params, batch, *, backend: str = "reference",
            remat: bool = True):
    """Mean next-token NLL over labels >= 0 (plus 0.01 * aux);
    differentiable (``forward``'s ``remat``)."""
    logits, aux = forward(cfg, params, batch, backend=backend, remat=remat)
    labels = batch["labels"].to(torch.int64)
    logits = logits.to(torch.float32)
    # on vocab-sharded DTensors each rank reduces and gathers its own
    # columns (the gold logit [B, S, 1]), and the gradients stay there
    logz = vocab_logsumexp(logits)
    gold = vocab_gather(logits, labels.clamp(min=0)[..., None])
    mask = (labels >= 0).to(torch.float32)
    nll = torch.sum((logz[..., None] - gold)[..., 0] * mask) \
        / torch.clamp(torch.sum(mask), min=1.0)
    return nll + 0.01 * aux


# ----------------------------------------------------------------- decode

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Decode cache on ``device`` (None: the card), in the JAX package's
    layouts.  Dense, moe and vlm: {"k", "v"} [L, B, Hkv, S_max, hd];
    audio: those of its decoder and {"cross_k", "cross_v"} [L, B, Hkv,
    enc_seq, hd], zeros, which nothing in the package fills (as in the
    JAX package: the caller writes each layer's encoder projections);
    ssm:
    {"wkv"} [L, B, H, hd, hd] float32 and {"last_tm", "last_cm"} [L, B, D]
    in ``dtype`` (``max_seq`` unused); hybrid, per superblock of the
    pattern (nb = L / period): {"k", "v"} [nb, n_attn, B, Hkv, S_max,
    hd], {"ssm_h"} [nb, n_mamba, B, Di, N] float32 and {"conv"}
    [nb, n_mamba, B, K-1, Di] in ``dtype``."""
    check_supported(cfg)
    dev = resolve_device(device)
    zeros = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
    if cfg.family == "ssm":
        d, h = cfg.d_model, cfg.n_heads
        return {"wkv": zeros((cfg.n_layers, batch, h, d // h, d // h),
                             torch.float32),
                "last_tm": zeros((cfg.n_layers, batch, d)),
                "last_cm": zeros((cfg.n_layers, batch, d))}
    kv = (batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    if cfg.family == "hybrid":
        period = len(cfg.pattern)
        nb = cfg.n_layers // period
        n_attn = sum(1 for k in cfg.pattern if k == "attn")
        n_mamba = period - n_attn
        di = cfg.ssm_expand * cfg.d_model
        return {"k": zeros((nb, n_attn, *kv)), "v": zeros((nb, n_attn, *kv)),
                "ssm_h": zeros((nb, n_mamba, batch, di, cfg.ssm_state),
                               torch.float32),
                "conv": zeros((nb, n_mamba, batch, cfg.ssm_conv - 1, di))}
    cache = {"k": zeros((cfg.n_layers, *kv)),
             "v": zeros((cfg.n_layers, *kv))}
    if cfg.family == "audio":
        xkv = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.enc_seq,
               cfg.head_dim)
        cache["cross_k"], cache["cross_v"] = zeros(xkv), zeros(xkv)
    return cache


def cache_specs(cfg: ModelConfig) -> dict:
    """The logical-axis specs of ``init_cache``'s tree (JAX's, as its
    ``init_cache`` returns them)."""
    check_supported(cfg)
    kv = ("layers", "batch", "kv_heads", "cache_seq", "cache_head_dim")
    if cfg.family == "ssm":
        return {"wkv": ("layers", "batch", "heads", None, None),
                "last_tm": ("layers", "batch", "embed"),
                "last_cm": ("layers", "batch", "embed")}
    if cfg.family == "hybrid":
        hkv = ("layers", None, *kv[1:])
        return {"k": hkv, "v": hkv,
                "ssm_h": ("layers", None, "batch", "mlp", None),
                "conv": ("layers", None, "batch", None, "mlp")}
    specs = {"k": kv, "v": kv}
    if cfg.family == "audio":
        cross = ("layers", "batch", "kv_heads", None, "cache_head_dim")
        specs["cross_k"] = specs["cross_v"] = cross
    return specs


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, *,
                backend: str = "reference"):
    """One decode token: tokens [B] int32, pos [B] current lengths (the
    ssm family ignores ``pos``, as the JAX package does).  Returns
    (logits [B, V], cache); the cache is updated IN PLACE, its carried
    values stored in the cache's dtype (the JAX package returns the ssm
    family's ``last_tm``/``last_cm`` and the hybrid family's ``conv`` in
    the activations' dtype).  No kernel runs in decode: ``backend`` is
    not read."""
    check_supported(cfg)
    if cfg.family == "ssm":
        return _decode_rwkv(cfg, params, cache, tokens)
    if cfg.family == "hybrid":
        return _decode_hybrid(cfg, params, cache, tokens, pos)
    return _decode_dense(cfg, params, cache, tokens, pos)


def _ffn_or_moe(cfg: ModelConfig, p, h, use_moe: bool):
    if use_moe:
        out, _ = moe_mod.moe_ffn(p["ffn"], cfg, h)
        return out
    return ffn(p["ffn"], h, cfg.ffn_kind, cfg.act)


def _decode_dense(cfg: ModelConfig, params, cache, tokens, pos):
    with torch.no_grad():
        x = constrain(_embed(params, tokens)[:, None],          # [B, 1, D]
                          ("batch", "seq", "embed"))
        for i, (blk, (_, use_moe, window)) in enumerate(
                zip(params["blocks"], layer_plan(cfg))):
            h = norm(blk["ln1"], x, cfg.norm_kind, cfg.norm_eps)
            mix, _, _ = attn_mod.decode_attention_dense(
                blk["mixer"], cfg, h, cache["k"][i], cache["v"][i], pos,
                window)
            x = _residual(x, mix)
            if cfg.family == "audio":    # against the encoder's K/V
                h = norm(blk["ln_cross"], x, cfg.norm_kind, cfg.norm_eps)
                x = _residual(x, attn_mod.cross_attention_cached(
                    blk["cross"], cfg, h, cache["cross_k"][i],
                    cache["cross_v"][i]))
            h = norm(blk["ln2"], x, cfg.norm_kind, cfg.norm_eps)
            x = _residual(x, _ffn_or_moe(cfg, blk, h, use_moe))
        x = norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
        return _lm_logits(cfg, params, x)[:, 0], cache


def _decode_rwkv(cfg: ModelConfig, params, cache, tokens):
    with torch.no_grad():
        x = constrain(_embed(params, tokens)[:, None],          # [B, 1, D]
                          ("batch", "seq", "embed"))
        for i, blk in enumerate(params["blocks"]):
            h = norm(blk["ln1"], x, cfg.norm_kind, cfg.norm_eps)
            mix, (wkv_s, ltm) = rwkv_mod.time_mix(
                blk["mixer"]["time_mix"], cfg, h, state=cache["wkv"][i],
                last_x=cache["last_tm"][i])
            x = _residual(x, mix)
            h = norm(blk["ln2"], x, cfg.norm_kind, cfg.norm_eps)
            out, lcm = rwkv_mod.channel_mix(blk["mixer"]["channel_mix"], h,
                                            last_x=cache["last_cm"][i])
            x = _residual(x, out)
            cache["wkv"][i].copy_(wkv_s)
            cache["last_tm"][i].copy_(ltm)
            cache["last_cm"][i].copy_(lcm)
        x = norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
        return _lm_logits(cfg, params, x)[:, 0], cache


def _decode_hybrid(cfg: ModelConfig, params, cache, tokens, pos):
    """The hybrid decode: layer ``blk * period + i`` reads and writes its
    superblock's slot of the cache (the attention layers' K/V, the mamba
    layers' state and conv carry, numbered within the superblock)."""
    period = len(cfg.pattern)
    with torch.no_grad():
        x = constrain(_embed(params, tokens)[:, None],          # [B, 1, D]
                          ("batch", "seq", "embed"))
        for l, (blk, (kind, use_moe, _)) in enumerate(
                zip(params["blocks"], layer_plan(cfg))):
            sb, i = divmod(l, period)
            slot = sum(1 for k in cfg.pattern[:i] if k == kind)
            h = norm(blk["ln1"], x, cfg.norm_kind, cfg.norm_eps)
            if kind == "attn":
                mix, _, _ = attn_mod.decode_attention_dense(
                    blk["mixer"], cfg, h, cache["k"][sb, slot],
                    cache["v"][sb, slot], pos, -1)
            else:
                mix, (h2, c2) = mamba_mod.mamba_layer(
                    blk["mixer"], cfg, h, state=(cache["ssm_h"][sb, slot],
                                                 cache["conv"][sb, slot]))
                cache["ssm_h"][sb, slot].copy_(h2)
                cache["conv"][sb, slot].copy_(c2)
            x = _residual(x, mix)
            h = norm(blk["ln2"], x, cfg.norm_kind, cfg.norm_eps)
            x = _residual(x, _ffn_or_moe(cfg, blk, h, use_moe))
        x = norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
        return _lm_logits(cfg, params, x)[:, 0], cache
