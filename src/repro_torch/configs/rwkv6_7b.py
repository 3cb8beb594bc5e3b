"""RWKV-6 "Finch" 7B [arXiv:2404.05892; hf]: attention-free, data-dependent
decay linear recurrence.

32L d_model=4096 d_ff=14336 vocab=65536, untied embeddings, LayerNorm.
The one ssm configuration of the JAX package; its forward runs the
rwkv6_scan kernel (B8) in every layer, its decode the recurrent step.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336,
    vocab=65536, pattern=("rwkv",), window_pattern=(-1,),
    norm_kind="ln", norm_eps=1e-5, tie_embeddings=False,
    long_context_ok=True, source="arXiv:2404.05892; hf",
))
