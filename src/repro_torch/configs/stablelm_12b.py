"""StableLM-2-12B [hf:stabilityai/stablelm-2-12b]: dense GQA.

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.  SwiGLU, RoPE,
LayerNorm, untied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824,
    vocab=100352, pattern=("attn",), window_pattern=(-1,),
    rope_theta=10000.0, ffn_kind="swiglu", act="silu", norm_kind="ln",
    norm_eps=1e-5, tie_embeddings=False,
    long_context_ok=False, source="hf:stabilityai/stablelm-2-1_6b; hf",
))
