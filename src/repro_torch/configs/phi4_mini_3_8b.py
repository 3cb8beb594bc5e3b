"""Phi-4-mini-3.8B [arXiv:2412.08905; hf]: dense GQA, RoPE, SwiGLU.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064, tied embeddings.
The model of the serving surfaces (the JAX package's ``launch/serve.py``,
``examples/serve_tiered.py`` and ``tests/test_serve.py`` default to it).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab=200064, pattern=("attn",), window_pattern=(-1,),
    rope_theta=10000.0, ffn_kind="swiglu", act="silu", norm_kind="rms",
    tie_embeddings=True,
    long_context_ok=False, source="arXiv:2412.08905; hf",
))
