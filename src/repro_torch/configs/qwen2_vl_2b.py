"""Qwen2-VL-2B [arXiv:2409.12191; hf]: VLM backbone with M-RoPE.

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, tied embeddings,
biases on q/k/v.  The vision frontend is a stub, as in the JAX package:
the caller supplies patch embeddings (``batch["embeds"]``) and (t, h, w)
position ids; the backbone applies M-RoPE over 3 head-dim sections.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, pattern=("attn",), window_pattern=(-1,),
    rope_theta=1000000.0, m_rope=True, m_rope_sections=(16, 24, 24),
    ffn_kind="swiglu", act="silu", norm_kind="rms", qkv_bias=True,
    embed_inputs=True, tie_embeddings=True,
    long_context_ok=False, source="arXiv:2409.12191; hf",
))
