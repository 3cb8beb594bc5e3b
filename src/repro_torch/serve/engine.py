"""Serving engine: continuous batching over the PrismDB tiered KV cache
(the port's copy of the JAX package's ``serve/engine.py``).

Every decode tick selects the top-k pages of each sequence from Quest
summaries (the page accesses feed the clock tracker: B1 on backend
"cuda"), gathers them from whichever pool holds them (pages demoted to
the slow pool are charged slow reads), attends with the dense einsum the
JAX package uses, and appends the new token's K/V.  Before the decode the
engine's maintenance plane runs rate-limit, watermark and §5.3 policy
compactions (approx-MSC scoring: B2; each compaction's Movement replayed
on the page pools: B3/B5/B4), and after it one quantum drains when
``compaction_quantum > 0``.  One page pool serves all attention layers.
Uniform-attention families only (dense, moe and vlm: qwen2-vl's decode
rotates by M-RoPE with t = h = w = pos), as the JAX package's docstring
names them.  The JAX engine would also take whisper and skip its
cross-attention without a word; the port refuses the audio family.

The JAX package fuses a tick into one jitted dispatch; here it is eager
PyTorch, and its host reads are counted in ``engine.HOST_READS``: the
maintenance loop's (one at entry, one per compaction), plus the JAX
tick's own three (the sequence lengths before and after, the argmax).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import compaction
from repro_torch.core import engine as engine_core
from repro_torch.core import paged_kv, policy, prng
from repro_torch.core.backend import resolve_device
from repro_torch.core.paged_kv import PagedKVConfig, PagedKVState
from repro_torch.core.tiers import counters_dict
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as model_mod
from repro_torch.models.common import norm
from repro_torch.obs import export as obs_export
from repro_torch.obs import state as obs_plane

# ------------------------------------------------------------ model step


def paged_decode_step(mcfg: ModelConfig, cfg: PagedKVConfig, params,
                      kv: PagedKVState, tokens, seq_ids, pos, valid, *,
                      backend: str = "reference"):
    """One decode token through the tiered paged KV cache.

    tokens/seq_ids/pos/valid: [B].  Returns (logits [B, V], kv'); ``kv``
    is consumed (its pools are updated in place)."""
    f32 = torch.float32
    with torch.no_grad():
        x = params["embed"][tokens.to(torch.int64)][:, None]     # [B, 1, D]
        b = tokens.shape[0]
        hd = mcfg.head_dim
        hkv = mcfg.n_kv_heads
        g = mcfg.n_heads // hkv
        use_moe = mcfg.moe and mcfg.moe_every == 1

        # page selection shared across layers (summaries summed over L)
        q_proxy = x.reshape(1, b, 1, -1)[..., :hd].to(f32).expand(
            cfg.n_layers, b, cfg.kv_heads, hd)
        pidx, pmask = paged_kv.select_pages(kv, cfg, seq_ids, q_proxy)
        kv, kk, vv, tok_ok = paged_kv.gather_pages(kv, cfg, seq_ids, pidx,
                                                   pmask, backend=backend)
        # kk/vv: [L, B, K*T, Hkv, hd]
        ok = torch.cat([tok_ok, torch.ones((b, 1), dtype=torch.bool,
                                           device=x.device)], dim=1)
        k_stack, v_stack = [], []
        for i, blk in enumerate(params["blocks"]):
            h = norm(blk["ln1"], x, mcfg.norm_kind, mcfg.norm_eps)
            q, k_new, v_new = attn_mod._qkv(blk["mixer"], mcfg, h,
                                            pos[:, None])
            # JAX concatenates the pool dtype with the projections' and
            # then casts to float32: both widen exactly
            kcat = torch.cat([kk[i].transpose(1, 2).to(f32),
                              k_new.to(f32)], dim=2)
            vcat = torch.cat([vv[i].transpose(1, 2).to(f32),
                              v_new.to(f32)], dim=2)
            qf = (q[:, :, 0].to(f32) * hd ** -0.5).reshape(b, hkv, g, hd)
            s = qf @ kcat.transpose(-1, -2)                  # [B,Hkv,G,KT+1]
            s = torch.where(ok[:, None, None, :], s, -1e30)
            p = torch.softmax(s, dim=-1)
            o = (p @ vcat).reshape(b, mcfg.n_heads, 1, hd).to(x.dtype)
            x = x + attn_mod._out(o, blk["mixer"]["wo"])
            h = norm(blk["ln2"], x, mcfg.norm_kind, mcfg.norm_eps)
            x = x + model_mod._ffn_or_moe(mcfg, blk, h, use_moe)
            k_stack.append(k_new[:, :, 0])
            v_stack.append(v_new[:, :, 0])
        kv = paged_kv.append_tokens(kv, cfg, seq_ids, torch.stack(k_stack),
                                    torch.stack(v_stack), valid,
                                    backend=backend)
        x = norm(params["final_norm"], x, mcfg.norm_kind, mcfg.norm_eps)
        head = params["embed"].T if mcfg.tie_embeddings \
            else params["lm_head"]
        return x[:, 0] @ head, kv


# ----------------------------------------------------------------- engine

@dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    out: list = field(default_factory=list)
    seq_slot: int = -1
    done: bool = False


def _tick(est: engine_core.EngineState, params, tokens, valid,
          mcfg: ModelConfig, kv_cfg: PagedKVConfig,
          ecfg: engine_core.EngineConfig):
    """One engine tick: tier maintenance (rate-limit and watermark
    compactions with the page-pool mirror, and the §5.3 policy) as one
    bounded loop, then the decode step, the drain quantum and the obs
    TICK record.  ``est.payload`` is the PagedKVState with its ``tier``
    stripped (the engine owns the TierState)."""
    mirror = paged_kv.movement_mirror(kv_cfg, backend=ecfg.backend)
    ctr0 = est.tier.ctr
    comp0 = est.comp
    kv = est.payload._replace(tier=est.tier)
    fpk = paged_kv.tail_page_keys(kv, kv_cfg)
    need = valid.sum(dtype=torch.int32)
    est = engine_core.maintenance(est, ecfg, need=need, mirror=mirror,
                                  force_pin_keys=fpk)

    kv = est.payload._replace(tier=est.tier)
    seq_ids = torch.arange(kv_cfg.max_seqs, dtype=torch.int32,
                           device=tokens.device)
    logits, kv = paged_decode_step(mcfg, kv_cfg, params, kv, tokens,
                                   seq_ids, kv.seq_len.clone(), valid,
                                   backend=ecfg.backend)
    est = est._replace(tier=kv.tier, payload=kv._replace(tier=None))
    # quantized compaction: drain one micro-step behind the decode
    est = engine_core.drain_tick(est, ecfg)
    if ecfg.obs.enabled:
        # the tick is one op-kind row: its counter delta spans the
        # maintenance AND the decode's paged gather/append
        delta = obs_plane.counter_delta(est.tier.ctr, ctr0)
        if ecfg.compaction_quantum > 0:
            delta = compaction.defer_adjust(delta, comp0, est.comp)
        est = est._replace(obs=obs_plane.record_step(
            est.obs, ecfg.obs, kind=obs_plane.TICK, n_ops=need,
            delta=delta))
    return est, logits


def _host(t: torch.Tensor) -> np.ndarray:
    """One counted device-to-host read."""
    engine_core.HOST_READS.n += 1
    return t.cpu().numpy()


class ServeEngine:
    """Continuous batching + tiered-KV maintenance loop.

    Request orchestration (admission, prompt feeding, retirement) is host
    Python; the device work of a tick is ``_tick``.  ``device`` None means
    the card (raises without one); ``params`` must lie on that device.
    Serves the uniform-attention families (dense, moe, vlm), as the JAX
    package's engine does; raises for the others (ssm, hybrid, and audio,
    whose cross-attention a paged decode step has no place for)."""

    def __init__(self, mcfg: ModelConfig, kv_cfg: PagedKVConfig, params,
                 seed: int = 0, pol_cfg: policy.PolicyConfig | None = None,
                 backend: str = "reference", compaction_quantum: int = 0,
                 device=None):
        model_mod.check_supported(mcfg)
        if mcfg.family not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                f"ServeEngine serves uniform-attention families (dense, "
                f"moe, vlm); {mcfg.name} is {mcfg.family}")
        self.device = resolve_device(device)
        self.mcfg = mcfg
        self.cfg = kv_cfg
        self.params = params
        self.pol_cfg = pol_cfg or policy.PolicyConfig(
            epoch_ops=512, cooldown_ops=2048, read_heavy_frac=0.05,
            slow_tracked_frac=0.05)
        self.ecfg = engine_core.EngineConfig(
            tier=kv_cfg.tier(), pol=self.pol_cfg, backend=backend,
            compaction_quantum=compaction_quantum)
        kv = paged_kv.init(kv_cfg, self.device)
        self.est = engine_core.init(self.ecfg, prng.PRNGKey(seed),
                                    payload=kv._replace(tier=None),
                                    tier=kv.tier, device=self.device)
        self.queue: list[Request] = []
        self.active: dict[int, Request] = {}     # seq_slot -> request
        self.free_slots = list(range(kv_cfg.max_seqs))
        self._stats = {"steps": 0, "retired": 0}
        self.dispatches = 0

    @property
    def kv(self) -> PagedKVState:
        """A copy of the paged-KV state (ticks update the live one in
        place)."""
        return engine_core.dealias(
            self.est.payload._replace(tier=self.est.tier))

    @property
    def stats(self) -> dict:
        return {**self._stats,
                "compactions": int(self.est.tier.ctr.compactions)}

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        while self.queue and self.free_slots:
            req = self.queue.pop(0)
            slot = self.free_slots.pop(0)
            req.seq_slot = slot
            self.est.payload.seq_len[slot] = 0     # reset the slot
            self.active[slot] = req

    def step(self) -> bool:
        """One engine tick: admit, then tier maintenance + decode for every
        active sequence (prompts feed token by token: prefill and decode
        share the paged write path)."""
        self._admit()
        if not self.active:
            return False
        b = self.cfg.max_seqs
        sl = _host(self.est.payload.seq_len)
        tokens = np.zeros((b,), np.int32)
        valid = np.zeros((b,), bool)
        for slot, req in self.active.items():
            n_out = int(sl[slot])
            tok = req.prompt[n_out] if n_out < len(req.prompt) else \
                (req.out[-1] if req.out else 0)
            tokens[slot] = int(tok)
            valid[slot] = True

        self.est, logits = _tick(
            self.est, self.params,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(valid).to(self.device),
            mcfg=self.mcfg, kv_cfg=self.cfg, ecfg=self.ecfg)
        self.dispatches += 1
        self._stats["steps"] += 1

        nxt = _host(torch.argmax(logits, dim=-1))
        sl = _host(self.est.payload.seq_len)
        retired = []
        for slot, req in self.active.items():
            if int(sl[slot]) > len(req.prompt):     # generating
                req.out.append(int(nxt[slot]))
            if len(req.out) >= req.max_new:
                req.done = True
                retired.append(slot)
        for slot in retired:
            # retired sequences' pages go cold; MSC demotes them later
            self.active.pop(slot)
            self.free_slots.append(slot)
            self._stats["retired"] += 1
        return True

    def run(self, max_ticks: int = 10000) -> int:
        t = 0
        while (self.queue or self.active) and t < max_ticks:
            self.step()
            t += 1
        return t

    @property
    def counters(self) -> dict:
        return counters_dict(self.est.tier.ctr)

    def obs_snapshot(self) -> dict:
        """Host-side snapshot of the observability plane (tick-cost
        histogram, counter timeline, compaction events)."""
        return obs_export.snapshot(self.est.obs)
