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
them into zeros in expert order: the same sum for k = 2).  The
expert-parallel dispatch (``moe_dispatch`` "ep_local",
``moe_ffn_ep_local``) runs each "model" rank's experts over its batch
shard of the ambient mesh (``sharding.use_mesh``) and sums the parts.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
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
    if cfg.moe_dispatch == "ep_local":
        return moe_ffn_ep_local(params, cfg, x)
    if cfg.moe_dispatch != "global":
        raise ValueError(f"unknown moe_dispatch {cfg.moe_dispatch!r}")
    return moe_ffn_global(params, cfg, x)


def moe_ffn_global(params, cfg: ModelConfig, x):
    """x: [B, S, D] -> ([B, S, D], {"aux_loss", "dropped", "experts",
    "kept"}): the JAX package's two extras, each token's top-k experts
    [B, S, k] and whether each of those choices was kept [B, S, k] (not
    dropped at capacity).  One dispatch over all B * S tokens: the
    rowwise dispatch of a single row of B * S tokens, whose capacity,
    sort, drops and aux loss are the global ones."""
    b, s, d = x.shape
    top_p, top_e, aux = _route(params, cfg, x)                # [B, S, k]
    row = lambda t: t.reshape(1, b * s, -1)
    out, extras = _dispatch_rows(params, cfg, row(x), None,
                                 (row(top_p), row(top_e), aux))
    return out.reshape(b, s, d), {
        **extras, "experts": top_e, "kept": extras["kept"].reshape(b, s, -1)}


def moe_ffn_rowwise(params, cfg: ModelConfig, x):
    """Row-local dispatch: each batch row sorts its own S * k choices into
    its own [E, C_row, d] buffer (capacity and drops per row).  Returns
    ([B, S, D], {"aux_loss", "dropped", "experts" [B, S, k], "kept"
    [B, S, k]})."""
    return _dispatch_rows(params, cfg, x, "batch")


def _route(params, cfg: ModelConfig, x):
    """Router logits (padded experts masked), the softmax, each token's
    top-k experts by a stable descending sort and their renormalised
    weights, and the Switch-style load-balancing aux loss.  x: [..., D]
    -> (top_p [..., k], top_e [..., k], aux)."""
    e = cfg.n_experts_padded or cfg.n_experts
    k = cfg.top_k
    dev = x.device
    logits = (x @ params["router"]).to(torch.float32)         # [..., E]
    if x.dim() == 3:      # a DTensor's tokens stay laid out as x's
        logits = constrain(logits, ("batch", "seq", None))
    if e != cfg.n_experts:
        pad = torch.arange(e, device=dev) >= cfg.n_experts
        logits = torch.where(pad, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = srt.values[..., :k], srt.indices[..., :k]
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    me = torch.mean(probs.reshape(-1, e), dim=0)
    # one-hot by comparison: F.one_hot reads the indices' range back to
    # the host on the CPU, and cannot on the meta device
    first = top_e[..., 0].reshape(-1, 1)
    ce = torch.mean((first == torch.arange(e, device=dev))
                    .to(torch.float32), dim=0)
    return top_p, top_e, torch.sum(me * ce) * e


def _dispatch_rows(params, cfg: ModelConfig, x, row_axis, routed=None):
    """The rowwise dispatch; ``row_axis`` is the logical axis of the
    buffers' row dimension in their sharding constraints ("batch"; None
    for the global dispatch's single row, whose buffers JAX constrains
    as [E, C, d]); ``routed`` is ``_route``'s result for ``x`` where the
    caller has it.

    On DTensors the packing (sort, ranks, buffer) runs on each rank's
    rows, gathered whole where a row is sharded (the global dispatch's
    one row of all tokens), the experts run as DTensor einsums on the
    expert-sharded buffer, and the combine reads each rank's own
    experts' slots and leaves a partial sum over the ranks that shard
    the experts (``sharding.on_local_shards``)."""
    b, s, d = x.shape
    e = cfg.n_experts_padded or cfg.n_experts
    k = cfg.top_k
    top_p, top_e, aux = routed or _route(params, cfg, x)      # [B, S, k]

    # ---- sort-based dispatch
    c = int(cfg.capacity_factor * s * k / e) + 1
    rows, dropped_pl = _row_layouts(x)
    buf, keep_u, slot_u, dropped = sharding.on_local_shards(
        functools.partial(_pack, e, c, k), [rows, rows],
        [rows, rows, rows, dropped_pl], x, top_e)
    axes = (row_axis, "expert", "capacity", "embed")
    buf = constrain(buf, axes)
    h = F.silu(torch.einsum("becd,edf->becf", buf, params["w_gate"])) \
        * torch.einsum("becd,edf->becf", buf, params["w_up"])
    out_flat = constrain(torch.einsum("becf,efd->becd", h,
                                      params["w_down"]), axes) \
        .reshape(b, e * c, d)
    out = _combine_on_shards(out_flat, keep_u, slot_u, top_p)
    return out, {"aux_loss": aux, "dropped": dropped, "experts": top_e,
                 "kept": keep_u.reshape(b, s, k)}


def _row_layouts(x):
    """(the placements of ``x``'s rows: sharded on dimension 0 where x
    is, whole elsewhere; a count summed over those rows: partial over
    the ranks that shard them), or (None, None) for a plain tensor."""
    if not sharding.is_dtensor(x):
        return None, None
    from torch.distributed.tensor import Partial, Replicate, Shard
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in x.placements]
    return rows, [Partial() if p.is_shard() else p for p in rows]


def _pack(e: int, c: int, k: int, x, top_e):
    """The sort-based packing of rows ``x`` [b, s, d] by their top-k
    experts ``top_e`` [b, s, k]: (buf [b, e, c, d], each choice's kept
    flag and slot in (token, choice) order [b, s k], the dropped count).
    Kept slots are distinct; every dropped choice lands in a spare row
    past the buffer, which is cut off."""
    b, s, d = x.shape
    dev = x.device
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
    buf = torch.zeros((b, e * c + 1, d), dtype=x.dtype, device=dev)
    buf[rows, slot] = torch.gather(x, 1, st_[..., None].expand(b, s * k, d))
    buf = buf[:, :e * c].reshape(b, e, c, d)
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(s * k, device=dev)[None].expand(b, s * k))
    return (buf, torch.gather(keep, 1, inv), torch.gather(slot, 1, inv),
            dropped)


def _combine_on_shards(out_flat, keep_u, slot_u, top_p):
    """``_combine`` on DTensors: each rank reads the slots of its own
    experts (out_flat's dimension 1 sharded over the "model" ranks), so
    the output [b, s, d] is a partial sum over those ranks."""
    full = out_flat.shape[1]
    if not sharding.is_dtensor(out_flat):
        return _combine(0, full, out_flat, keep_u, slot_u, top_p)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    pl = out_flat.placements
    _, offset = compute_local_shape_and_global_offset(
        out_flat.shape, out_flat.device_mesh, pl)
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in pl]
    out_pl = [Partial() if p.is_shard(1) else p for p in pl]
    return sharding.on_local_shards(
        functools.partial(_combine, offset[1], full),
        [None, rows, rows, rows], [out_pl], out_flat, keep_u, slot_u, top_p)


def _combine(lo: int, full: int, out_flat, keep_u, slot_u, top_p):
    """Each token's k expert outputs from ``out_flat`` [b, n, d], the
    buffer's slots lo .. lo + n - 1 of ``full``, weighted by ``top_p``
    [b, s, k] and added in a fixed order (choice 0, 1, ...); a choice
    whose slot lies elsewhere (dropped, or another rank's) adds
    nothing.  Returns [b, s, d]."""
    b, n, d = out_flat.shape
    s, k = top_p.shape[1], top_p.shape[2]
    valid, slot = keep_u, slot_u
    if n != full:
        valid = keep_u & (slot_u >= lo) & (slot_u < lo + n)
        slot = slot_u - lo
    rows = torch.arange(b, device=out_flat.device)[:, None].expand(b, s * k)
    g = out_flat[rows, torch.where(valid, slot, 0)]
    g = torch.where(valid[..., None], g, 0) \
        * top_p.reshape(b, s * k)[..., None].to(out_flat.dtype)
    g = g.reshape(b, s, k, d)
    out = g[:, :, 0]
    for j in range(1, k):
        out = out + g[:, :, j]
    return out


def moe_ffn_ep_local(params, cfg: ModelConfig, x):
    """Expert parallelism over the ambient mesh's "model" axis (the JAX
    package's ``moe_ffn_ep_local``, its ``shard_map`` body ``local``).

    Each "model" rank routes its batch shard over all E experts, runs
    its own E / ep experts (rank r: experts [r E/ep, (r+1) E/ep)), each
    over the first ``cap_l = min(max(int(cf bl s k / E) + 1, 1), bl s)``
    tokens that picked it, in position order, and the partial outputs
    are summed over the ranks; ``aux_loss`` is their mean.  ``dropped``
    is 0, as the JAX package returns it whatever the capacity drops
    (ROADMAP Queue 3, F8); ``experts`` [B, S, k] is each token's top-k,
    from which ``ep_local_kept`` tells the choices the capacity kept.

    The mesh decides where the parts run:

    * none ambient, or one without a "model" axis: the rowwise dispatch,
      as in the JAX package;
    * a stand-in (``launch/mesh.MeshShape``): the batch cut into the
      shards of its ("pod", "data") axes that each divide B, and every
      (shard, rank) part run in turn in this process, the parts of a
      shard added (what the psum gives); ``aux_loss`` is shard 0's, the
      value JAX's unchecked replicated output holds (PERF.md);
    * a named ``DeviceMesh``: ``x`` is this rank's batch shard (plain
      tensors, every expert's weights), and the sums run over the
      "model" group (``all_reduce``); ``aux_loss`` is this rank's own
      shard's, so ranks of different data shards hold different values,
      as each device does under JAX's unchecked output (PERF.md); ``x``
      a DTensor (the dry run's SPMD half): ``_ep_on_dtensors``;
    * meta tensors: one part, counted once per part
      (``roofline/op_cost.counted_times``): every part has the same
      shapes, so the count is exact.
    """
    mesh = sharding.current_mesh()
    axes = sharding.mesh_axes(mesh) if mesh is not None else {}
    if "model" not in axes:
        return moe_ffn_rowwise(params, cfg, x)
    e = cfg.n_experts_padded or cfg.n_experts
    ep = axes["model"]
    if e % ep:
        raise ValueError(f"{e} experts over a model axis of {ep}")
    e_loc = e // ep
    b, s, d = x.shape
    if not hasattr(mesh, "axis_sizes"):          # a DeviceMesh
        return _ep_on_mesh(params, cfg, x, mesh, e_loc)
    n_data = math.prod(axes[a] for a in ("pod", "data")
                       if a in axes and b % axes[a] == 0)
    if b % n_data:
        raise ValueError(f"a batch of {b} over {n_data} data shards")
    bl = b // n_data
    if x.device.type == "meta":
        from repro_torch.roofline.op_cost import counted_times
        out, aux, top_e = counted_times(
            n_data * ep, functools.partial(_ep_experts, cfg, 0), x[:bl],
            params["router"], *_expert_slice(params, 0, e_loc))
        cat = lambda t: torch.cat([t] * n_data)
        return cat(out), {"aux_loss": aux, "dropped": _no_drops(x),
                          "experts": cat(top_e)}
    outs, tops, auxs = [], [], []
    for i in range(n_data):
        xs = x[i * bl:(i + 1) * bl]
        parts = [_ep_part(params, cfg, xs, r * e_loc, e_loc)
                 for r in range(ep)]
        out = parts[0][0]
        for p in parts[1:]:
            out = out + p[0]
        outs.append(out)
        auxs.append(sum(p[1] for p in parts) / ep)
        tops.append(parts[0][2])
    return torch.cat(outs), {"aux_loss": auxs[0], "dropped": _no_drops(x),
                             "experts": torch.cat(tops)}


def ep_local_kept(cfg: ModelConfig, experts, n_data: int = 1):
    """The top-k choices ``moe_ffn_ep_local`` keeps, from its ``experts``
    extra [B, S, k] and its capacity rule: in each of ``n_data`` batch
    shards and for each expert, the first ``cap_l`` tokens that chose it,
    in position order (a token chooses an expert at most once, and every
    choice's router weight is positive).  Returns [B, S, k] bool; the
    dispatch itself never computes it."""
    b, s, k = experts.shape
    e = cfg.n_experts_padded or cfg.n_experts
    t = b // n_data * s
    cap = min(max(int(cfg.capacity_factor * t * k / e) + 1, 1), t)
    fe = experts.reshape(n_data, t, k)
    chose = (fe[..., None] == torch.arange(e, device=experts.device)) \
        .any(2).to(torch.int32)                                 # [n, T, E]
    before = torch.cumsum(chose, 1) - chose
    return (torch.gather(before, 2, fe) < cap).reshape(b, s, k)


def _no_drops(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _ep_on_mesh(params, cfg: ModelConfig, x, mesh, e_loc: int):
    """``moe_ffn_ep_local`` on a named ``DeviceMesh``: this rank's part
    of its batch shard ``x``, summed over the "model" group.  ``x`` a
    DTensor: ``_ep_on_dtensors``."""
    if sharding.is_dtensor(x):
        return _ep_on_dtensors(params, cfg, x, mesh, e_loc)
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce
    group = mesh.get_group("model")
    ep = dist.get_world_size(group)
    out, aux, top_e = _ep_part(
        params, cfg, x, mesh.get_local_rank("model") * e_loc, e_loc)
    if ep > 1:
        out = all_reduce(out, group=group)
        aux = all_reduce(aux, group=group) / ep
    return out, {"aux_loss": aux, "dropped": _no_drops(x), "experts": top_e}


def _ep_on_dtensors(params, cfg: ModelConfig, x, mesh, e_loc: int):
    """JAX's ``shard_map`` of the expert-parallel part over DTensors
    (``sharding.on_local_shards``): ``x`` sharded on its batch over the
    ("pod", "data") axes that divide it, the router whole, the experts
    sharded over "model"; each rank runs its part (``_ep_experts``) and
    the parts are summed over the "model" group, ``aux_loss`` averaged
    (an all-reduce each, forward and backward: JAX's psum and pmean).
    The output and ``experts`` are laid out as ``x``'s batch,
    ``aux_loss`` replicated."""
    from torch.distributed.tensor import Replicate, Shard
    b = x.shape[0]
    names = mesh.mesh_dim_names
    rows = [Shard(0) if n in ("pod", "data") and b % mesh.size(i) == 0
            else Replicate() for i, n in enumerate(names)]
    experts = [Shard(0) if n == "model" else Replicate() for n in names]
    whole = [Replicate()] * len(names)
    group = mesh.get_group("model")
    ep = mesh.size(names.index("model"))
    lo = mesh.get_local_rank("model") * e_loc

    def part(xs, router, w_gate, w_up, w_down):
        out, aux, top_e = _ep_experts(cfg, lo, xs, router, w_gate, w_up,
                                      w_down)
        return (sharding.group_sum(out, group, backward_sums=True),
                sharding.group_sum(aux, group, backward_sums=True) / ep,
                top_e)

    out, aux, top_e = sharding.on_local_shards(
        part, [rows, whole, experts, experts, experts], [rows, whole, rows],
        x, params["router"], params["w_gate"], params["w_up"],
        params["w_down"])
    return out, {"aux_loss": aux, "dropped": _no_drops(x),
                 "experts": top_e}


def _expert_slice(params, lo: int, e_loc: int) -> list:
    return [params[n][lo:lo + e_loc] for n in ("w_gate", "w_up", "w_down")]


def _ep_part(params, cfg: ModelConfig, xs, lo: int, e_loc: int):
    """One rank's part: its batch shard ``xs`` [bl, S, D] routed over
    all experts, experts [lo, lo + e_loc) run.  Returns (partial out
    [bl, S, D], aux, top_e [bl, S, k])."""
    return _ep_experts(cfg, lo, xs, params["router"],
                       *_expert_slice(params, lo, e_loc))


def _ep_experts(cfg: ModelConfig, lo: int, xs, router, w_gate, w_up,
                w_down):
    """``_ep_part`` on the part's expert weights ([e_loc, ...]), whose
    first expert is global expert ``lo``."""
    bl, s, d = xs.shape
    e = router.shape[-1]
    k = cfg.top_k
    t = bl * s
    dev = xs.device
    xt = xs.reshape(t, d)
    top_p, top_e, aux = _route({"router": router}, cfg, xt)     # [T, k]
    cap = min(max(int(cfg.capacity_factor * t * k / e) + 1, 1), t)
    out = torch.zeros((t, d), dtype=xs.dtype, device=dev)
    for j in range(w_gate.shape[0]):
        hit = top_e == lo + j                                   # [T, k]
        w_tok = torch.sum(torch.where(hit, top_p, 0.0), dim=-1)
        sel = w_tok > 0
        # the first cap selected tokens in position order, then the
        # others in position order: JAX's lax.top_k of the scores
        # -arange (selected) and -1e30 - arange, which float32 rounds to
        # one value, its ties broken by the lower index
        idx = torch.sort((~sel).to(torch.int8), stable=True).indices[:cap]
        keep = sel[idx]
        xe = torch.where(keep[:, None], xt[idx], 0)             # [C, D]
        h = F.silu(xe @ w_gate[j]) * (xe @ w_up[j])
        oe = (h @ w_down[j]) * w_tok[idx][:, None].to(xs.dtype)
        out = out.index_add(0, idx, torch.where(keep[:, None], oe, 0))
    return out.reshape(bl, s, d), aux, top_e.reshape(bl, s, k)
