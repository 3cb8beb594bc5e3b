"""Whisper-small [arXiv:2212.04356]: encoder-decoder.

12L encoder + 12L decoder, d_model=768 12H d_ff=3072 vocab=51865,
LayerNorm, GELU MLP, tied embeddings.  The conv frontend is a stub, as in
the JAX package: the caller supplies mel-frame embeddings
(``batch["enc_embeds"]`` [B, 1500, 768]).  The encoder has no decode.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, pattern=("attn",), window_pattern=(-1,),
    ffn_kind="mlp", act="gelu", norm_kind="ln", norm_eps=1e-5,
    enc_layers=12, enc_seq=1500, embed_inputs=True, tie_embeddings=True,
    long_context_ok=False, source="arXiv:2212.04356",
))
