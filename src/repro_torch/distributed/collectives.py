"""The partition-routing batch exchange of a ``PartitionedDB`` spread over
a ``torch.distributed`` process group (the JAX package's
``distributed/collectives.py``, its mesh half).

Each of D ranks owns ``local_parts`` consecutive partitions and holds a
slice of the client batch.  It hash-routes its slice into
fixed-capacity per-destination buckets (``utils.pack_buckets``, overflow
counted per destination), and one ``all_to_all_single`` swaps them, so
that every rank ends up with exactly the keys its partitions own.
Empty bucket slots hold -1, so the keys carry their own mask: one
exchange of keys gives ``valid = routed >= 0``.

Gloo carries CPU tensors and NCCL CUDA tensors; a tensor on a device
that the group's backend cannot carry raises.

The file's other half is training's int8 gradient compression with error
feedback (``EFState``, ``quantize_int8``, ``compress_tree``,
``compressed_all_reduce``), bit-equal to the JAX package's: symmetric
per-tensor int8, rounding half to even in both, and the residual ``x -
dequantize(quantize(x))`` carried to the next step.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.tree import map_tree
from repro_torch.core.utils import pack_buckets, part_of_key

_CARRIES = {"gloo": "cpu", "nccl": "cuda"}


def check_device(t: torch.Tensor, group) -> None:
    """Raise unless the group's backend carries tensors on ``t``'s
    device."""
    backend = str(dist.get_backend(group))
    want = _CARRIES.get(backend)
    if want is None or t.device.type != want:
        raise RuntimeError(f"a {backend} process group does not carry "
                           f"tensors on {t.device}")


def _swap(x: torch.Tensor, group, local_parts: int) -> torch.Tensor:
    """[n_parts, cap] rows by destination partition -> [local_parts,
    D * cap]: row j holds what every source sent to this rank's j-th
    partition, the sources in rank order."""
    check_device(x, group)
    d = dist.get_world_size(group)
    n_parts, cap = x.shape
    if n_parts != d * local_parts:
        raise ValueError(f"{n_parts} buckets for {d} ranks of "
                         f"{local_parts} partitions")
    send = x.reshape(d, local_parts * cap).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.view(d, local_parts, cap).transpose(0, 1).reshape(
        local_parts, d * cap)


def ragged_all_to_all(buckets: torch.Tensor, valid: torch.Tensor, group,
                      local_parts: int = 1
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exchange per-destination buckets across the ranks of ``group``.

    Each rank holds ``buckets`` int32[n_parts, cap] and its ``valid``
    mask, row p destined for global partition p (rows grouped by owning
    rank, ``n_parts = D * local_parts``).  Returns ``(routed, valid)`` of
    shape [local_parts, D * cap], the sources concatenated in rank
    order: each source packs its buckets in batch order and owns a
    consecutive slice of the batch, so batch order is kept."""
    routed = _swap(buckets, group, local_parts)
    ok = _swap(valid.to(torch.uint8), group, local_parts)
    return routed, ok.bool()


def exchange_keys(keys: torch.Tensor, n_parts: int, cap: int, group,
                  local_parts: int = 1, valid: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hash-route this rank's slice of a client batch: bucket by owning
    partition, exchange, account.  Returns ``(routed, valid, dropped)``:
    the owned keys [local_parts, D * cap] with their mask, and the
    global per-partition overflow int32[n_parts] (summed over the ranks,
    the same on every rank).  One exchange of keys carries the mask."""
    buckets, _, over = pack_buckets(keys, part_of_key(keys, n_parts),
                                    n_parts, cap, valid=valid)
    routed = _swap(buckets, group, local_parts)
    dist.all_reduce(over, group=group)
    return routed, routed >= 0, over


def all_gather_stack(tree, group, device: torch.device):
    """Every rank's tree of [lp, ...] leaves -> the tree of [D * lp, ...]
    leaves in rank order (the global stacked layout).  Leaves that lie
    elsewhere (the engines' host rng keys) travel on ``device`` and come
    back to where they were; bool leaves travel as uint8."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[all_gather_stack(x, group, device)
                            for x in tree])
    if isinstance(tree, tuple):
        return tuple(all_gather_stack(x, group, device) for x in tree)
    if not torch.is_tensor(tree):
        return tree
    x = tree.to(device)
    x = x.view(torch.uint8) if x.dtype == torch.bool else x
    check_device(x, group)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    out = torch.cat(parts)
    out = out.view(torch.bool) if tree.dtype == torch.bool else out
    return out.to(tree.device)


# ------------------------------------------- int8 error-feedback compression

class EFState(NamedTuple):
    residual: Any      # same tree as the gradients, float32


def init_error_feedback(grads_shape) -> EFState:
    """Zero residuals beside every leaf of ``grads_shape``."""
    return EFState(residual=map_tree(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_shape))


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8: returns (q int8, scale float32 [])."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _compress(g: torch.Tensor, r: torch.Tensor):
    """(q, scale, dequantized, new residual) of g + r."""
    x = g.to(torch.float32) + r
    q, scale = quantize_int8(x)
    deq = dequantize_int8(q, scale)
    return q, scale, deq, x - deq


def compress_tree(grads, ef: EFState):
    """Quantize and dequantize each leaf of ``grads`` plus its residual,
    so that what is reduced has int8 precision.  Returns (dequantized
    grads, EFState of the new residuals)."""
    residuals = []

    def one(g, r):
        *_, deq, res = _compress(g, r)
        residuals.append(res)
        return deq

    deq = map_tree(one, grads, ef.residual)
    left = iter(residuals)            # map_tree visits leaves in order
    return deq, EFState(map_tree(lambda _: next(left), grads))


def compressed_all_reduce(g: torch.Tensor, ef: torch.Tensor, group=None):
    """The JAX package's ``compressed_psum`` over a ``torch.distributed``
    group: g + ef quantized to int8, the int8 tensors and their scales
    gathered from every rank (the wire carries int8), and the ranks'
    dequantized values summed in rank order, so that every rank holds the
    same sum.  ``group=None`` is the one-process case.  Returns (sum
    float32, new residual)."""
    q, scale, deq, new_ef = _compress(g, ef)
    if group is None:
        return deq, new_ef
    check_device(q, group)
    world = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(world)]
    scales = torch.empty(world, dtype=scale.dtype, device=scale.device)
    dist.all_gather(qs, q.contiguous(), group=group)
    dist.all_gather(list(scales.chunk(world)), scale.reshape(1),
                    group=group)
    red = dequantize_int8(qs[0], scales[0])
    for qr, sr in zip(qs[1:], scales[1:]):
        red = red + dequantize_int8(qr, sr)
    return red, new_ef
