"""Tiered embedding store: PrismDB's core applied to a huge-vocab table
(the JAX package's ``core/embedding_store.py``).

object = one embedding row; key = vocab id.  The fast tier is a row pool
on the card that the training step gathers and updates in place; the slow
tier holds every row in key-sorted runs.  ``prepare_batch`` promotes a
batch's missing rows into the fast pool before the step; MSC compactions
demote cold rows when the pool fills, and every compaction's Movement is
replayed on the two row pools through the tier_compact movers (B3, B5
and B4 on backend "cuda").  The token stream drives the clock tracker.

``prepare_step`` is the engine-driven form: ``engine.maintain`` makes
headroom for the batch (mirroring the row pools through each
compaction), then the promotion.  The row pools are updated in place:
the engine state passed in is consumed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bloom, compaction, engine, prng, tiers
from repro_torch.core.backend import resolve_device
from repro_torch.core.compaction import Movement
from repro_torch.core.tiers import TierConfig, TierState
from repro_torch.core.utils import (PADKEY, build_sorted_index, count_into,
                                    set_where, sorted_lookup)
from repro_torch.kernels.tier_compact.ops import apply_movement_rows

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class EmbedStoreConfig(NamedTuple):
    vocab: int = 65536
    dim: int = 512
    fast_rows: int = 8192
    dtype: str = "float32"

    def tier(self) -> TierConfig:
        return TierConfig(
            key_space=self.vocab,
            fast_slots=self.fast_rows,
            slow_slots=self.vocab,          # the slow tier holds every row
            value_width=1,
            value_bytes=self.dim * 4,
            max_runs=max(self.vocab // 4096, 16),
            run_size=4096,
            bloom_bits_per_run=1 << 14,
            tracker_slots=max(self.fast_rows * 2, 1024),
            n_buckets=256,
            pin_threshold=0.5,
        )


class EmbedStoreState(NamedTuple):
    tier: TierState | None
    rows_fast: torch.Tensor    # [fast_rows, dim]
    rows_slow: torch.Tensor    # [vocab, dim]


def init(cfg: EmbedStoreConfig, rng: torch.Tensor, device=None
         ) -> EmbedStoreState:
    """Every row starts in the slow tier as consecutive full runs, drawn
    N(0, 0.02^2) from ``rng`` (``prng.normal``: a few ULP from the JAX
    package's draw).  ``device`` None means the card."""
    dev = resolve_device(device)
    tcfg = cfg.tier()
    tier = tiers.init(tcfg, dev)
    i32 = torch.int32
    vocab, rs = cfg.vocab, tcfg.run_size
    keys = torch.arange(vocab, dtype=i32, device=dev)
    run_of = torch.div(keys, rs, rounding_mode="floor")
    n_runs = (vocab + rs - 1) // rs
    slow_keys = torch.full((tcfg.slow_slots,), -1, dtype=i32, device=dev)
    slow_keys[:vocab] = keys
    slow_run = torch.full((tcfg.slow_slots,), -1, dtype=i32, device=dev)
    slow_run[:vocab] = run_of
    sidx_keys, sidx_slots = build_sorted_index(slow_keys)
    run_ids = torch.arange(tcfg.max_runs, dtype=i32, device=dev)
    have = run_ids < n_runs
    run_lo = torch.where(have, run_ids * rs, PADKEY)
    run_hi = torch.where(have, torch.clamp((run_ids + 1) * rs, max=vocab),
                         PADKEY)
    run_count = torch.where(have, run_hi - run_lo, 0).to(i32)
    blooms = tier.dir_blooms[0]
    blooms[:n_runs] = bloom.make_rows(keys, run_of, torch.ones_like(
        keys, dtype=torch.bool), n_runs, blooms.shape[1])
    bucket_slow = count_into(tiers.bucket_of(tcfg, keys),
                             tcfg.n_buckets).to(i32)
    tier = tier._replace(
        keys=(tier.keys[0], slow_keys), runs=(slow_run,),
        idx_keys=(tier.idx_keys[0], sidx_keys),
        idx_slots=(tier.idx_slots[0], sidx_slots),
        dir_lo=(run_lo.to(i32),), dir_hi=(run_hi.to(i32),),
        dir_count=(run_count,), dir_active=(have,), dir_blooms=(blooms,),
        bucket_slow=bucket_slow)
    dtype = _DTYPES[cfg.dtype]
    rows_slow = (prng.normal(rng, (tcfg.slow_slots, cfg.dim), dev)
                 * 0.02).to(dtype)
    rows_fast = torch.zeros((cfg.fast_rows, cfg.dim), dtype=dtype,
                            device=dev)
    return EmbedStoreState(tier=tier, rows_fast=rows_fast,
                           rows_slow=rows_slow)


def _unique_padded(x: torch.Tensor) -> torch.Tensor:
    """``jnp.unique(x, size=len(x), fill_value=-1)``: the sorted distinct
    values, then -1 to the end.  No host read (``torch.unique`` sizes its
    output from the data)."""
    s = torch.sort(x).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(first, 0) - 1     # distinct for the first lanes
    return set_where(torch.full_like(s, -1), first, rank, s)


def prepare_batch(state: EmbedStoreState, cfg: EmbedStoreConfig,
                  token_ids: torch.Tensor
                  ) -> tuple[EmbedStoreState, torch.Tensor]:
    """Promote any batch token's row into the fast pool (a slow read and a
    fast write, counted); return the fast-pool slot of every token."""
    tcfg = cfg.tier()
    tier = state.tier
    tok = token_ids.to(torch.int32)
    keys = _unique_padded(tok)
    valid = keys >= 0
    _, ffound = sorted_lookup(tier.idx_keys[0], tier.idx_slots[0], keys)
    missing = valid & ~ffound
    sslot, sfound = sorted_lookup(tier.idx_keys[1], tier.idx_slots[1], keys)
    fetch = missing & sfound
    src = sslot.to(torch.int64).clamp(0, state.rows_slow.shape[0] - 1)
    fetched = state.rows_slow[src]

    # install the missing rows into fast slots through the tier store
    vals = fetched[:, :1].to(tier.vals[0].dtype)
    tier, _, _, _ = tiers.apply_point_ops(tier, tcfg, keys, vals, fetch,
                                          is_put=True, is_get=False,
                                          is_del=False)
    new_slot, nf = sorted_lookup(tier.idx_keys[0], tier.idx_slots[0], keys)
    moved = fetch & nf
    # keys are distinct (_unique_padded), so their fast slots are too
    rows_fast = set_where(state.rows_fast, moved, new_slot.to(torch.int64),
                          fetched)
    # the promotion fetch is a slow read
    n_moved = moved.sum(dtype=torch.int32)
    ctr = tier.ctr._replace(reads=tier.ctr.reads + torch.stack(
        [torch.zeros_like(n_moved), n_moved]))
    tier = tier._replace(ctr=ctr)
    state = state._replace(tier=tier, rows_fast=rows_fast)
    slot, found = sorted_lookup(tier.idx_keys[0], tier.idx_slots[0], tok)
    return state, torch.where(found, slot, 0)


def lookup(state: EmbedStoreState, token_ids: torch.Tensor) -> torch.Tensor:
    """Embeddings of a prepared batch (fast pool only; 0 where absent)."""
    slot, found = sorted_lookup(state.tier.idx_keys[0],
                                state.tier.idx_slots[0],
                                token_ids.to(torch.int32))
    rows = state.rows_fast[slot.to(torch.int64).clamp(
        0, state.rows_fast.shape[0] - 1)]
    return torch.where(found[..., None], rows, torch.zeros_like(rows))


def apply_grad(state: EmbedStoreState, token_slots: torch.Tensor,
               grads: torch.Tensor, lr: float) -> EmbedStoreState:
    """In-place slab update of fast rows.  Duplicate slots sum in an
    order the CUDA ``index_add_`` does not fix: equal to the JAX package
    within float rounding, not bit for bit."""
    step = (grads.to(torch.float32) * (-lr)).to(state.rows_fast.dtype)
    state.rows_fast.index_add_(0, token_slots.to(torch.int64), step)
    return state


def _apply_movement(state: EmbedStoreState, cfg: EmbedStoreConfig,
                    mv: Movement, backend: str = "reference"
                    ) -> EmbedStoreState:
    """Replay a Movement on the row pools (kernels B3, B5, B4 on backend
    "cuda" with CUDA tensors; their plain versions otherwise)."""
    rows_fast, rows_slow = apply_movement_rows(
        state.rows_fast, state.rows_slow, mv, backend=backend)
    return state._replace(rows_fast=rows_fast, rows_slow=rows_slow)


def compact(state: EmbedStoreState, cfg: EmbedStoreConfig,
            rng: torch.Tensor, backend: str = "reference"):
    """One compaction of the store, its Movement mirrored on the rows."""
    tier, stats, mv = compaction.compact_once(
        state.tier, cfg.tier(), rng, promote=True, with_movement=True,
        backend=backend)
    state = _apply_movement(state, cfg, mv, backend=backend)
    return state._replace(tier=tier), stats


def needs_compaction(state: EmbedStoreState, cfg: EmbedStoreConfig
                     ) -> torch.Tensor:
    return compaction.needs_compaction(state.tier, cfg.tier())


# ----------------------------------------------------- engine-driven store

def movement_mirror(cfg: EmbedStoreConfig, backend: str = "reference"):
    """Engine mirror: replay each compaction's Movement on the row pools."""
    def mirror(payload: EmbedStoreState, mv: Movement) -> EmbedStoreState:
        return _apply_movement(payload, cfg, mv, backend=backend)
    return mirror


def engine_config(cfg: EmbedStoreConfig, **kw) -> engine.EngineConfig:
    return engine.EngineConfig(tier=cfg.tier(), **kw)


def engine_init(cfg: EmbedStoreConfig, rng: torch.Tensor,
                ecfg: engine.EngineConfig | None = None, device=None
                ) -> engine.EngineState:
    """Engine state whose payload is the row store (its tier stripped:
    the engine owns the TierState).  ``device`` None means the card."""
    dev = resolve_device(device)
    r_rows, r_eng = prng.split(rng, 2)
    state = init(cfg, r_rows, dev)
    return engine.init(ecfg or engine_config(cfg), r_eng,
                       payload=state._replace(tier=None), tier=state.tier,
                       device=dev)


def prepare_step(est: engine.EngineState, cfg: EmbedStoreConfig,
                 ecfg: engine.EngineConfig, token_ids: torch.Tensor
                 ) -> tuple[engine.EngineState, torch.Tensor]:
    """A training batch's prepare: compaction headroom (the row pools
    mirrored through every compaction), then the row promotion.  Returns
    the fast-pool slot of every token."""
    mirror = movement_mirror(cfg, backend=ecfg.backend)
    est = engine.maintain(est, ecfg, need=token_ids.shape[0], mirror=mirror)
    state = est.payload._replace(tier=est.tier)
    state, slots = prepare_batch(state, cfg, token_ids)
    return est._replace(tier=state.tier,
                        payload=state._replace(tier=None)), slots
