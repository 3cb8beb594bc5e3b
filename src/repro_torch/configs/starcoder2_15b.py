"""StarCoder2-15B [arXiv:2402.19173; hf]: dense GQA, RoPE, LayerNorm and
biases.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152, GELU MLP, biases
on q/k/v, untied embeddings; the released full-attention config.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, d_ff=24576,
    vocab=49152, pattern=("attn",), window_pattern=(-1,),
    rope_theta=100000.0, ffn_kind="mlp", act="gelu", norm_kind="ln",
    norm_eps=1e-5, qkv_bias=True, tie_embeddings=False,
    long_context_ok=False, source="arXiv:2402.19173; hf",
))
