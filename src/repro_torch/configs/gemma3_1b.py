"""Gemma-3-1B [hf:google/gemma-3-1b-pt]: dense GQA with 5:1 local:global.

26L d_model=1152 4H (GQA kv=1) d_head=256 d_ff=6912 vocab=262144, sliding
window 512 on local layers.  In the port it carries the windowed-attention
tests and the head dim 256 of the flash_attention kernel's shapes.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
    vocab=262144, d_head=256,
    pattern=("attn",) * 6,
    window_pattern=(512, 512, 512, 512, 512, -1),   # 5 local : 1 global
    rope_theta=1000000.0, ffn_kind="swiglu", act="silu", norm_kind="rms",
    tie_embeddings=True,
    long_context_ok=False, source="hf:google/gemma-3-1b-pt",
))
