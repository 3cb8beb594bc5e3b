"""Model configuration schema and registry (the port's own copy of the
JAX package's ``configs/base.py``): ``ModelConfig``, ``get_arch`` and
``reduced``, the tiny same-family config of the CPU tests, and the dry
run's cells: ``ShapeConfig``, ``SHAPES`` and ``applicable_shapes``.

All ten of the JAX package's architectures are registered: the dense
phi4-mini-3.8b, gemma3-1b, stablelm-12b and starcoder2-15b; the moe
granite-moe-3b-a800m and qwen3-moe-235b-a22b; rwkv6-7b (ssm);
jamba-v0.1-52b (hybrid); qwen2-vl-2b (vlm, M-RoPE) and whisper-small
(audio, encoder-decoder).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 -> d_model // n_heads
    # layer pattern: entries in {"attn", "mamba", "rwkv"}; tiles to n_layers
    pattern: tuple = ("attn",)
    # sliding-window schedule: window per pattern position (-1 = global)
    window_pattern: tuple = (-1,)
    rope_theta: float = 10000.0
    m_rope: bool = False
    m_rope_sections: tuple = (16, 24, 24)
    # ffn / moe
    ffn_kind: str = "swiglu"    # swiglu | mlp
    act: str = "silu"
    norm_kind: str = "rms"      # rms | ln
    norm_eps: float = 1e-6
    moe: bool = False
    n_experts: int = 0
    n_experts_padded: int = 0
    top_k: int = 0
    moe_every: int = 1
    capacity_factor: float = 1.25
    moe_dispatch: str = "global"
    banded_local: bool = False
    # ssm (mamba / rwkv)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_seq: int = 1500
    embed_inputs: bool = False
    tie_embeddings: bool = True
    qkv_bias: bool = False
    long_context_ok: bool = False
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def layer_types(self) -> tuple:
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]

    @property
    def layer_windows(self) -> tuple:
        reps = -(-self.n_layers // len(self.window_pattern))
        return (self.window_pattern * reps)[: self.n_layers]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> dict:
    _ensure_loaded()
    return dict(_REGISTRY)


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        gemma3_1b, granite_moe_3b_a800m, jamba_v0_1_52b, phi4_mini_3_8b,
        qwen2_vl_2b, qwen3_moe_235b_a22b, rwkv6_7b, stablelm_12b,
        starcoder2_15b, whisper_small)


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU tests (the JAX package's
    ``reduced``, field for field)."""
    period = len(cfg.pattern)
    n_layers = period if cfg.family == "hybrid" else min(
        2 * period, max(period, 2))
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads, 2))
    if cfg.n_kv_heads == cfg.n_heads:
        kv = heads
    return cfg.replace(
        n_layers=n_layers, d_model=64, n_heads=heads, n_kv_heads=kv,
        d_head=16, d_ff=128, vocab=512,
        n_experts=min(cfg.n_experts, 8) if cfg.moe else 0,
        n_experts_padded=min(cfg.n_experts_padded or cfg.n_experts, 8)
        if cfg.moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.moe else 0,
        ssm_state=8, ssm_expand=2,
        enc_layers=min(cfg.enc_layers, 2), enc_seq=32,
        m_rope_sections=(4, 2, 2) if cfg.m_rope else cfg.m_rope_sections,
        window_pattern=tuple(min(w, 8) if w > 0 else w
                             for w in cfg.window_pattern),
    )


def applicable_shapes(cfg: ModelConfig) -> list:
    """The (arch x shape) cells this arch runs: every shape, but
    ``long_500k`` only for the sub-quadratic archs
    (``long_context_ok``)."""
    return [s for s in SHAPES.values()
            if s.name != "long_500k" or cfg.long_context_ok]
