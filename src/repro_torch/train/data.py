"""Deterministic synthetic LM data, sharded per host (the port's copy of
the JAX package's ``train/data.py``).

Batch i is a pure function of (seed, step, host): numpy draws it exactly
as the JAX package does (``SeedSequence([seed, step, host_id])``, a
zipfian token stream), so restart-after-failure resumes exactly and the
two packages see the same tokens, labels, embeddings and positions bit
for bit.  The draw happens on the host; ``device`` says where the
tensors go (None: the card).  ``Prefetcher`` draws on a thread and hands
over host batches, which the consumer moves (``to_device``).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device


class DataConfig(NamedTuple):
    seed: int = 0
    batch: int = 8
    seq_len: int = 128
    vocab: int = 512
    zipf_a: float = 1.2        # token frequencies are zipfian (drives the
                               # tiered embedding store's popularity skew)


def to_device(batch: dict, device=None) -> dict:
    """A batch's tensors on ``device`` (None: the card)."""
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in batch.items()}


def _host_batch_at(cfg: DataConfig, step: int, host_id: int = 0,
                   n_hosts: int = 1) -> dict:
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host_id]))
    b = cfg.batch // n_hosts
    toks = (rng.zipf(cfg.zipf_a, size=(b, cfg.seq_len + 1)) - 1) % cfg.vocab
    toks = toks.astype(np.int32)
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(toks[:, 1:].copy())}


def batch_at(cfg: DataConfig, step: int, host_id: int = 0,
             n_hosts: int = 1, *, device=None) -> dict:
    """Batch for ``step``, host-sharded along the batch dim: ``tokens``
    and ``labels`` int32 [batch / n_hosts, seq_len] on ``device``.  Pure
    in (seed, step, host)."""
    return to_device(_host_batch_at(cfg, step, host_id, n_hosts), device)


def _host_model_batch(cfg: DataConfig, mcfg: ModelConfig, step: int) -> dict:
    base = _host_batch_at(cfg, step)
    if mcfg.family == "audio":
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step,
                                                            7]))
        enc = rng.normal(size=(cfg.batch, mcfg.enc_seq, mcfg.d_model)) * 0.02
        return {"enc_embeds": torch.from_numpy(enc.astype(np.float32)),
                "tokens": base["tokens"], "labels": base["labels"]}
    if mcfg.embed_inputs:
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step,
                                                            8]))
        emb = rng.normal(size=(cfg.batch, cfg.seq_len, mcfg.d_model)) * 0.02
        out = {"embeds": torch.from_numpy(emb.astype(np.float32)),
               "labels": base["labels"]}
        if mcfg.m_rope:
            t = np.arange(cfg.seq_len)[None].repeat(cfg.batch, 0)
            out["positions"] = torch.from_numpy(
                np.stack([t, t % 7, t % 5], -1).astype(np.int32))
        return out
    return base


def model_batch(cfg: DataConfig, mcfg: ModelConfig, step: int, *,
                device=None) -> dict:
    """The token stream adapted to the arch's input modality, on
    ``device`` (None: the card): the audio family gets ``enc_embeds``
    [batch, enc_seq, d_model] float32 N(0, 0.02^2) from (seed, step, 7)
    beside its tokens; a family with ``embed_inputs`` gets ``embeds``
    [batch, seq_len, d_model] from (seed, step, 8) in place of tokens,
    and with M-RoPE the stub frontend's ``positions`` (t, t % 7, t % 5)
    [batch, seq_len, 3] int32."""
    return to_device(_host_model_batch(cfg, mcfg, step), device)


class Prefetcher:
    """Draws ``model_batch`` for start_step, start_step + 1, ... on a
    background thread, ``depth`` ahead.  Iterating yields host (CPU)
    batches; the consumer moves each to its device (``to_device``).
    ``close`` stops the thread."""

    def __init__(self, cfg: DataConfig, mcfg: ModelConfig,
                 start_step: int = 0, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def work():
            step = start_step
            while not self._stop.is_set():
                try:
                    self.q.put(_host_model_batch(cfg, mcfg, step),
                               timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        self.t = threading.Thread(target=work, daemon=True)
        self.t.start()

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.q.get()

    def close(self):
        self._stop.set()
        self.t.join(timeout=5.0)
