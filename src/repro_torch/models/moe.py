"""Mixture-of-Experts FFN with top-k routing (the port's copy of the JAX
package's ``models/moe.py``).

Sort-based dropping dispatch: tokens are sorted by assigned expert,
packed into an [E, C, d] buffer (capacity C from ``capacity_factor``;
overflow dropped and counted), run through the experts as batched
matmuls, and combined with their router probabilities.  Experts padded
to ``n_experts_padded`` (granite 40 -> 48) are masked to -1e30 in the
router, so they never win.

The global dispatch is the rowwise one over a single row of all B * S
tokens.  Parity rules with the JAX package: ``lax.top_k`` breaks ties by the
lower index, so the top-k is a stable descending sort; the dispatch
sort is stable and the rank in a group comes from ``searchsorted``
(left); the dispatch write targets distinct kept slots, with every
dropped token sent to one spare row past the buffer; the combine adds a
token's k contributions in a fixed order (choice 0, 1, ...) with no
atomics, so the card's result does not depend on launch order (JAX adds
them into zeros in expert order: the same sum for k = 2).  The JAX
package's expert-parallel dispatch (``moe_dispatch`` "ep_local") needs
a mesh, which the port does not have yet: it raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamInit


def init_moe(pi: ParamInit, cfg: ModelConfig) -> dict:
    """The JAX package's ``init_moe``, quirk included: ``dense`` takes its
    scale from ``shape[0]``, so the expert weights [E, d, f] and
    [E, f, d] are drawn with std 1/sqrt(E) (ROADMAP Queue 3)."""
    e = cfg.n_experts_padded or cfg.n_experts
    d, f = cfg.d_model, cfg.d_ff
    return {
        "router": pi.dense((d, e), ("embed", "expert"), scale=0.02),
        "w_gate": pi.dense((e, d, f), ("expert", "embed", "mlp")),
        "w_up": pi.dense((e, d, f), ("expert", "embed", "mlp")),
        "w_down": pi.dense((e, f, d), ("expert", "mlp", "embed")),
    }


def moe_ffn(params, cfg: ModelConfig, x):
    if cfg.moe_dispatch == "rowwise":
        return moe_ffn_rowwise(params, cfg, x)
    if cfg.moe_dispatch != "global":
        raise NotImplementedError(
            f"moe_dispatch {cfg.moe_dispatch!r} is not ported (ROADMAP "
            "Queue 1: the expert-parallel dispatch needs a mesh)")
    return moe_ffn_global(params, cfg, x)


def moe_ffn_global(params, cfg: ModelConfig, x):
    """x: [B, S, D] -> ([B, S, D], {"aux_loss", "dropped", "experts"}):
    the JAX package's two extras and each token's top-k experts
    [B, S, k].  One dispatch over all B * S tokens: the rowwise dispatch
    of a single row of B * S tokens, whose capacity, sort, drops and
    aux loss are the global ones."""
    b, s, d = x.shape
    out, extras = moe_ffn_rowwise(params, cfg, x.reshape(1, b * s, d))
    return out.reshape(b, s, d), {
        **extras, "experts": extras["experts"].reshape(b, s, -1)}


def moe_ffn_rowwise(params, cfg: ModelConfig, x):
    """Row-local dispatch: each batch row sorts its own S * k choices into
    its own [E, C_row, d] buffer (capacity and drops per row).  Returns
    ([B, S, D], {"aux_loss", "dropped", "experts" [B, S, k]})."""
    b, s, d = x.shape
    e = cfg.n_experts_padded or cfg.n_experts
    k = cfg.top_k
    dev = x.device

    # ---- routing: padded experts masked, top-k by a stable sort
    logits = (x @ params["router"]).to(torch.float32)          # [B, S, E]
    if e != cfg.n_experts:
        pad = torch.arange(e, device=dev) >= cfg.n_experts
        logits = torch.where(pad, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = srt.values[..., :k], srt.indices[..., :k]  # [B, S, k]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)

    # load-balancing aux loss (Switch-style)
    me = torch.mean(probs.reshape(-1, e), dim=0)
    # one-hot by comparison: F.one_hot reads the indices' range back to
    # the host on the CPU, and cannot on the meta device
    first = top_e[..., 0].reshape(-1, 1)
    ce = torch.mean((first == torch.arange(e, device=dev))
                    .to(torch.float32), dim=0)
    aux = torch.sum(me * ce) * e

    # ---- sort-based dispatch
    c = int(cfg.capacity_factor * s * k / e) + 1
    fe = top_e.reshape(b, s * k)
    order = torch.sort(fe, dim=1, stable=True).indices
    se = torch.gather(fe, 1, order)
    st_ = order // k                     # token of each sorted choice
    rank = torch.arange(s * k, device=dev)[None] \
        - torch.searchsorted(se, se)
    keep = rank < c
    dropped = torch.sum(1.0 - keep.to(torch.float32))
    slot = torch.where(keep, se * c + rank, e * c)
    rows = torch.arange(b, device=dev)[:, None].expand(b, s * k)
    # kept slots are distinct; every dropped choice lands in the spare row
    buf = torch.zeros((b, e * c + 1, d), dtype=x.dtype, device=dev)
    buf[rows, slot] = torch.gather(x, 1, st_[..., None].expand(b, s * k, d))
    buf = buf[:, :e * c].reshape(b, e, c, d)
    h = F.silu(torch.einsum("becd,edf->becf", buf, params["w_gate"])) \
        * torch.einsum("becd,edf->becf", buf, params["w_up"])
    out_flat = torch.einsum("becf,efd->becd", h, params["w_down"]) \
        .reshape(b, e * c, d)

    # ---- combine, in (token, choice) order
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(s * k, device=dev)[None].expand(b, s * k))
    keep_u = torch.gather(keep, 1, inv)
    slot_u = torch.gather(slot, 1, inv)
    g = out_flat[rows, torch.where(keep_u, slot_u, 0)]
    g = torch.where(keep_u[..., None], g, 0) \
        * top_p.reshape(b, s * k)[..., None].to(x.dtype)
    g = g.reshape(b, s, k, d)
    out = g[:, :, 0]
    for j in range(1, k):
        out = out + g[:, :, j]
    return out, {"aux_loss": aux, "dropped": dropped, "experts": top_e}
