"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-235B-A22B]: 128-expert top-8 MoE.

94L d_model=4096 64H (GQA kv=4, head dim 128) d_ff (an expert)=1536
vocab=151936, untied embeddings, MoE in every layer.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab=151936, d_head=128, pattern=("attn",), window_pattern=(-1,),
    rope_theta=1000000.0, ffn_kind="swiglu", act="silu", norm_kind="rms",
    moe=True, n_experts=128, n_experts_padded=128, top_k=8, moe_every=1,
    tie_embeddings=False,
    long_context_ok=False, source="hf:Qwen/Qwen3-30B-A3B; hf",
))
