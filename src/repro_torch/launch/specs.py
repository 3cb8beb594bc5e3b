"""Inputs of every (arch x shape) cell (the port's copy of the JAX
package's ``launch/specs.py``): meta tensors at the shapes and dtypes of
the JAX ``ShapeDtypeStruct``s, for the dry run, and small concrete
batches drawn from a ``torch.Generator``."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta inputs of a train step or a prefill; decode takes
    ``decode_specs``.  The frontend-stub archs (vlm, audio) take
    embeddings in bfloat16."""
    b, s = shape.global_batch, shape.seq_len
    out: dict = {}
    if cfg.family == "audio":
        out["enc_embeds"] = _meta((b, cfg.enc_seq, cfg.d_model),
                                  torch.bfloat16)
        out["tokens"] = _meta((b, s), torch.int32)
    elif cfg.embed_inputs:
        out["embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        if cfg.m_rope:
            out["positions"] = _meta((b, s, 3), torch.int32)
    else:
        out["tokens"] = _meta((b, s), torch.int32)
    if shape.kind == "train":
        out["labels"] = _meta((b, s), torch.int32)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b = shape.global_batch
    return {"tokens": _meta((b,), torch.int32),
            "pos": _meta((b,), torch.int32)}


def concrete_batch(cfg: ModelConfig, shape_kind: str, batch: int, seq: int,
                   generator: torch.Generator, device=None) -> dict:
    """A small batch drawn from ``generator`` on ``device`` (default: the
    generator's): token ids uniform over the vocabulary, embeddings
    N(0, 1) * 0.02 in float32, M-RoPE positions (t, t % 7, t % 5), and
    labels for a train step."""
    dev = generator.device if device is None else torch.device(device)
    g = dict(generator=generator, device=dev)
    tokens = lambda: torch.randint(0, cfg.vocab, (batch, seq), **g)
    out: dict = {}
    if cfg.family == "audio":
        out["enc_embeds"] = torch.randn(batch, cfg.enc_seq, cfg.d_model,
                                        **g) * 0.02
        out["tokens"] = tokens()
    elif cfg.embed_inputs:
        out["embeds"] = torch.randn(batch, seq, cfg.d_model, **g) * 0.02
        if cfg.m_rope:
            t = torch.arange(seq, device=dev)[None].repeat(batch, 1)
            out["positions"] = torch.stack([t, t % 7, t % 5], dim=-1)
    else:
        out["tokens"] = tokens()
    if shape_kind == "train":
        out["labels"] = tokens()
    return out
