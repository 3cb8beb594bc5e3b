"""The model: init / forward / loss / decode for the dense and ssm
(rwkv6) families (the port's copy of the JAX package's
``models/model.py``).

Parameters are a dict: ``embed`` [V, D], ``final_norm``, ``lm_head`` when
embeddings are untied, and ``blocks``, a list with one dict per layer in
the JAX package's layouts: dense ``mixer`` (wq/wk/wv/wo), ``ffn``,
``ln1``, ``ln2``; ssm ``mixer`` (``time_mix``, ``channel_mix``: the
channel mix is its ffn), ``ln1``, ``ln2``.  ``params_from_numpy`` carries
a JAX parameter pytree (stacked [L, ...] blocks) across.  The JAX package
scans its layers with the per-layer window as a traced scan input; here
the layers are a Python loop and each window is a Python int
(``cfg.layer_windows``), so backend "cuda" runs the flash_attention
kernel (B7) in every dense layer, and the rwkv6_scan kernel (B8) in
every ssm layer.

The MoE, hybrid (jamba), vlm and audio families raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import (ParamInit, ffn, init_ffn, init_norm,
                                       norm)

_TODO = {
    "moe": "ROADMAP Queue 1 item 12 / slice 5: moe.py with jamba",
    "hybrid": "ROADMAP Queue 1 item 12 / slice 5: jamba forward (B9)",
    "vlm": "ROADMAP Queue 1 item 12: M-RoPE (qwen2-vl)",
    "audio": "ROADMAP Queue 1 item 12: encoder-decoder (whisper)",
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the families this slice of the port does not run."""
    fam = "moe" if cfg.moe else cfg.family
    if fam not in ("dense", "ssm") or cfg.m_rope or cfg.embed_inputs:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported yet: "
            f"{_TODO.get(fam, _TODO['vlm'])}")


# ------------------------------------------------------------------- init

def _init_block(pi: ParamInit, cfg: ModelConfig) -> dict:
    if cfg.family == "ssm":           # rwkv's channel mix is its ffn
        return {"mixer": rwkv_mod.init_rwkv_layer(pi, cfg),
                "ln1": init_norm(pi, cfg.d_model, cfg.norm_kind),
                "ln2": init_norm(pi, cfg.d_model, cfg.norm_kind)}
    return {"mixer": attn_mod.init_attention(pi, cfg),
            "ffn": init_ffn(pi, cfg.d_model, cfg.d_ff, cfg.ffn_kind),
            "ln1": init_norm(pi, cfg.d_model, cfg.norm_kind),
            "ln2": init_norm(pi, cfg.d_model, cfg.norm_kind)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> dict:
    """Random parameters with the JAX ``init_params``'s shapes and scales,
    drawn from ``generator`` on ``device`` (None: the card; raises without
    one).  The generator must live on that device."""
    check_supported(cfg)
    pi = ParamInit(generator, resolve_device(device), dtype)
    params = {"embed": pi.embed((cfg.vocab, cfg.d_model))}
    if not cfg.tie_embeddings:
        params["lm_head"] = pi.dense((cfg.d_model, cfg.vocab))
    params["final_norm"] = init_norm(pi, cfg.d_model, cfg.norm_kind)
    params["blocks"] = [_init_block(pi, cfg) for _ in range(cfg.n_layers)]
    return params


def params_from_numpy(cfg: ModelConfig, tree, device=None) -> dict:
    """A JAX parameter pytree (numpy leaves; ``blocks`` stacked [L, ...])
    -> the port's parameters on ``device`` (None: the card), one dict per
    layer.  Copies every leaf."""
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

    out = {k: conv(v) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [layer(tree["blocks"], i) for i in range(cfg.n_layers)]
    return out


# ---------------------------------------------------------------- forward

def _block_apply(cfg: ModelConfig, p, x, positions, window: int,
                 backend: str):
    h = norm(p["ln1"], x, cfg.norm_kind, cfg.norm_eps)
    if cfg.family == "ssm":
        mix, _ = rwkv_mod.time_mix(p["mixer"]["time_mix"], cfg, h,
                                   backend=backend)
    else:
        mix = attn_mod.attention(p["mixer"], cfg, h, positions, window,
                                 backend=backend)
    x = x + mix
    h = norm(p["ln2"], x, cfg.norm_kind, cfg.norm_eps)
    if cfg.family == "ssm":
        out, _ = rwkv_mod.channel_mix(p["mixer"]["channel_mix"], h)
        return x + out
    return x + ffn(p["ffn"], h, cfg.ffn_kind, cfg.act)


def _lm_logits(cfg: ModelConfig, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def forward(cfg: ModelConfig, params, batch: dict, *,
            backend: str = "reference"):
    """batch: ``tokens`` [B, S] (and optionally ``positions`` [B, S]; the
    ssm family reads none).  Returns (logits [B, S, V], aux), aux a
    float32 zero for these families.  Evaluation only: no gradient is
    kept."""
    check_supported(cfg)
    with torch.no_grad():
        x = params["embed"][batch["tokens"].to(torch.int64)]
        b, s = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        for p, window in zip(params["blocks"], cfg.layer_windows):
            x = _block_apply(cfg, p, x, positions, int(window), backend)
        x = norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
        logits = _lm_logits(cfg, params, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(cfg: ModelConfig, params, batch, *, backend: str = "reference"):
    """Mean next-token NLL over labels >= 0 (plus 0.01 * aux), evaluated
    under ``torch.no_grad``."""
    logits, aux = forward(cfg, params, batch, backend=backend)
    with torch.no_grad():
        labels = batch["labels"].to(torch.int64)
        logits = logits.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[
            ..., 0]
        mask = (labels >= 0).to(torch.float32)
        nll = torch.sum((logz - gold) * mask) / torch.clamp(
            torch.sum(mask), min=1.0)
        return nll + 0.01 * aux


# ----------------------------------------------------------------- decode

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Decode cache on ``device`` (None: the card).  Dense: {"k", "v"}
    [L, B, Hkv, S_max, hd]; ssm: {"wkv"} [L, B, H, hd, hd] float32 and
    {"last_tm", "last_cm"} [L, B, D] in ``dtype`` (``max_seq`` unused)."""
    check_supported(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        d, h = cfg.d_model, cfg.n_heads
        return {"wkv": torch.zeros((cfg.n_layers, batch, h, d // h, d // h),
                                   dtype=torch.float32, device=dev),
                "last_tm": torch.zeros((cfg.n_layers, batch, d), dtype=dtype,
                                       device=dev),
                "last_cm": torch.zeros((cfg.n_layers, batch, d), dtype=dtype,
                                       device=dev)}
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_step(cfg: ModelConfig, params, cache, tokens, pos, *,
                backend: str = "reference"):
    """One decode token: tokens [B] int32, pos [B] current lengths (the
    ssm family ignores ``pos``, as the JAX package does).  Returns
    (logits [B, V], cache); the cache is updated IN PLACE, its carried
    values stored in the cache's dtype (the JAX package returns the ssm
    family's ``last_tm``/``last_cm`` in the activations' dtype).  No
    kernel runs in decode: ``backend`` is not read."""
    check_supported(cfg)
    if cfg.family == "ssm":
        return _decode_rwkv(cfg, params, cache, tokens)
    return _decode_dense(cfg, params, cache, tokens, pos)


def _decode_dense(cfg: ModelConfig, params, cache, tokens, pos):
    with torch.no_grad():
        x = params["embed"][tokens.to(torch.int64)][:, None]   # [B, 1, D]
        for i, (blk, window) in enumerate(zip(params["blocks"],
                                              cfg.layer_windows)):
            h = norm(blk["ln1"], x, cfg.norm_kind, cfg.norm_eps)
            mix, _, _ = attn_mod.decode_attention_dense(
                blk["mixer"], cfg, h, cache["k"][i], cache["v"][i], pos,
                int(window))
            x = x + mix
            h = norm(blk["ln2"], x, cfg.norm_kind, cfg.norm_eps)
            x = x + ffn(blk["ffn"], h, cfg.ffn_kind, cfg.act)
        x = norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
        return _lm_logits(cfg, params, x)[:, 0], cache


def _decode_rwkv(cfg: ModelConfig, params, cache, tokens):
    with torch.no_grad():
        x = params["embed"][tokens.to(torch.int64)][:, None]   # [B, 1, D]
        for i, blk in enumerate(params["blocks"]):
            h = norm(blk["ln1"], x, cfg.norm_kind, cfg.norm_eps)
            mix, (wkv_s, ltm) = rwkv_mod.time_mix(
                blk["mixer"]["time_mix"], cfg, h, state=cache["wkv"][i],
                last_x=cache["last_tm"][i])
            x = x + mix
            h = norm(blk["ln2"], x, cfg.norm_kind, cfg.norm_eps)
            out, lcm = rwkv_mod.channel_mix(blk["mixer"]["channel_mix"], h,
                                            last_x=cache["last_cm"][i])
            x = x + out
            cache["wkv"][i].copy_(wkv_s)
            cache["last_tm"][i].copy_(ltm)
            cache["last_cm"][i].copy_(lcm)
        x = norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
        return _lm_logits(cfg, params, x)[:, 0], cache
