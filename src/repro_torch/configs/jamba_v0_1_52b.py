"""Jamba-v0.1-52B [arXiv:2403.19887; hf]: hybrid Mamba + attention 1:7
interleave with MoE every other layer (16 experts, top-2).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, untied
embeddings.  The hybrid family: its forward runs the mamba_scan kernel
(B9) in the 7 mamba layers of each 8-layer period and the
flash_attention kernel (B7) in the attention layer.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=65536,
    # 8-layer period: attention at position 4, mamba elsewhere (1:7)
    pattern=("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba",
             "mamba"),
    window_pattern=(-1,),
    moe=True, n_experts=16, n_experts_padded=16, top_k=2, moe_every=2,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    ffn_kind="swiglu", act="silu", norm_kind="rms", tie_embeddings=False,
    long_context_ok=True, source="arXiv:2403.19887; hf",
))
