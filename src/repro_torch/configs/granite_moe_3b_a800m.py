"""Granite-MoE-3B-A800M [hf:ibm-granite]: 40-expert top-8 MoE.

32L d_model=1536 24H (GQA kv=8) d_ff(expert)=512 vocab=49155, tied
embeddings.  Experts padded 40 -> 48, as the JAX package pads them for
its 16-way expert axis; the router masks the pads, so they never win.
The uniform MoE family: every layer is attention + MoE.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, pattern=("attn",), window_pattern=(-1,),
    ffn_kind="swiglu", act="silu", norm_kind="rms",
    moe=True, n_experts=40, n_experts_padded=48, top_k=8, moe_every=1,
    tie_embeddings=True,
    long_context_ok=False, source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
