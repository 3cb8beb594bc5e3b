"""What one rank of a mesh computes and communicates: the port's
counterpart of the collective accounting of the JAX package's
``launch/dryrun.collective_bytes`` and ``roofline/hlo_cost.py``.

JAX reads a cell's collectives from the compiled, partitioned HLO: each
collective op once, its result shape's bytes on one device, by kind.
The port runs the cell on DTensors (``torch.distributed.tensor``) as
rank 0 of the mesh, each local shard a meta tensor, and ``SpmdCost``
watches what rank 0 runs:

* an operation on DTensors is not counted itself: DTensor redistributes
  its inputs as its sharding strategy asks, then runs the operation on
  the local shards, and those local operations are what ``SpmdCost``
  counts (``flops``, ``bytes``, ``by_op``, as ``op_cost.OpCost`` counts
  them): sharded work once, replicated work in full;
* every collective that rank 0 issues (a functional collective of
  ``torch.distributed._functional_collectives``, whichever path issued
  it) is tallied under JAX's kind names in ``collectives``: the result's
  bytes summed, and ``count_<kind>`` the number of ops, JAX's
  convention;
* what DTensor runs only to learn an output's shape and dtype (its
  sharding propagation on fake tensors of the global shapes) is not
  counted;
* DTensor on a CPU mesh swaps each Shard -> Shard all-to-all for an
  all-gather and a chunk, because gloo has no all-to-all; on NCCL it is
  one all-to-all.  The count records what the program issues on NCCL:
  one ``all-to-all`` of the chunk's bytes, and nothing of the stand-in.

Counts scale with ``op_cost.counted_times`` and ``StepCounted``, as
FLOPs do.  Beside them ``SpmdCost`` follows rank 0's live local bytes
(``buffer_cost.LiveBytes``: what each counted operation allocates, and
its peak), from which ``spmd_cost`` gives XLA's buffer sizes of the
function's results.  ``counting`` installs the two hooks into DTensor
for the duration of a block; ``spmd_cost`` runs a function under both.
"""
from __future__ import annotations

import contextlib
import itertools

from repro_torch.roofline.buffer_cost import LiveBytes, nbytes
from repro_torch.roofline.op_cost import OpCost, _active_cost

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# functional collectives (``_c10d_functional``) and DTensor's own
# all-to-all, by JAX's kind names
_KIND = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
         "all_reduce_coalesced": "all-reduce",
         "all_reduce_coalesced_": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_out": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         "shard_dim_alltoall": "all-to-all"}
# bookkeeping of the functional collectives: no data moves
_NOT_COUNTED = {"wait_tensor", "_wrap_tensor_autograd"}


def _results(out) -> list:
    return list(out) if isinstance(out, (list, tuple)) else [out]


class SpmdCost(OpCost):
    """``OpCost`` of one rank's local operations, with its collectives:
    ``collectives`` {kind: result bytes, "count_" + kind: ops}, and
    ``by_group`` {process group name: result bytes}, and ``buffers``,
    rank 0's live local bytes."""

    def __init__(self):
        super().__init__()
        self.collectives: dict = {}
        self.by_group: dict = {}
        self.buffers = LiveBytes()
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented       # DTensor runs it on local shards
        name = func.overloadpacket.__name__
        if name in _NOT_COUNTED:
            return func(*args, **(kwargs or {}))
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.scale:
            self.buffers.allocated((*args, *(kwargs or {}).values()), out)
        kind = _KIND.get(name)
        if kind is not None:
            group = [a for a in args if isinstance(a, str)]
            self.add_collective(kind, out, group[-1] if group else None)
        return out

    def add_collective(self, kind: str, out, group: str | None) -> None:
        """Count one collective of ``kind`` over the process group named
        ``group`` whose result is ``out`` (a tensor, or the list of a
        coalesced op's results)."""
        if not self.scale:
            return
        nbytes = sum(t.numel() * t.element_size() for t in _results(out))
        c = self.collectives
        c[kind] = c.get(kind, 0) + self.scale * nbytes
        c["count_" + kind] = c.get("count_" + kind, 0) + self.scale * len(
            _results(out))
        self.by_group[group] = self.by_group.get(group, 0) \
            + self.scale * nbytes

    def result(self) -> dict:
        return {**super().result(), "collectives": dict(self.collectives),
                "collective_bytes": collective_bytes(self.collectives),
                "by_group": dict(self.by_group)}


def collective_bytes(coll: dict) -> int:
    """The bytes of every kind together (the ``count_`` entries left
    out), as ``hlo_cost.analyze`` sums them."""
    return sum(v for k, v in coll.items() if not k.startswith("count_"))


def collective_axes(by_group: dict, mesh) -> dict:
    """``by_group`` ({process group name: bytes}) by the axes of ``mesh``
    (a named ``DeviceMesh`` whose process group is up) that each group
    spans: {"pod+data": bytes, ...}, the axes in the mesh's order."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    where = {int(r): c for c, r in zip(
        itertools.product(*map(range, mesh.mesh.shape)),
        mesh.mesh.flatten().tolist())}
    out: dict = {}
    for name, nbytes in by_group.items():
        coords = [where[r] for r in dist.get_process_group_ranks(
            _resolve_process_group(name))]
        axes = "+".join(n for d, n in enumerate(mesh.mesh_dim_names)
                        if len({c[d] for c in coords}) > 1)
        out[axes] = out.get(axes, 0) + nbytes
    return out


def _spmd_mode() -> SpmdCost | None:
    mode = _active_cost()
    return mode if isinstance(mode, SpmdCost) else None


def _strided(spec) -> bool:
    return any(type(p).__name__ == "_StridedShard" for p in spec.placements)


@contextlib.contextmanager
def counting():
    """While the block runs: DTensor's shape propagation is not counted,
    and its Shard -> Shard redistribution counts as one all-to-all of
    its result (the CPU mesh's all-gather and chunk that stand in for it
    are not counted).  DTensor's strategy choice costs a redistribution
    into a strided shard as unaffordable (and one out of it as dear, the
    same for every candidate): costing one searches a graph of layouts,
    seconds each on a 2 x 16 x 16 mesh (torch 2.13), and the layouts
    left are the plain ones the models ask for.  Leaves DTensor as it was
    on exit."""
    import importlib
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    propagate = ShardingPropagator._propagate_tensor_meta_non_cached
    alltoall = placement_types.shard_dim_alltoall
    costing = [m for m in map(importlib.import_module, (
        "torch.distributed.tensor._collective_utils",
        "torch.distributed.tensor._ops.utils",
        "torch.distributed.tensor._utils"))
        if hasattr(m, "redistribute_cost")]
    cost = costing[0].redistribute_cost

    def plain_cost(current, target):
        if _strided(current):
            return 1e9
        if _strided(target):
            return float("inf")
        return cost(current, target)

    def quiet_propagate(self, op_schema):
        mode = _spmd_mode()
        if mode is None:
            return propagate(self, op_schema)
        with mode.uncounted():
            return propagate(self, op_schema)

    def one_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        mode = _spmd_mode()
        if mode is None:
            return alltoall(input, gather_dim, shard_dim, mesh, mesh_dim)
        with mode.uncounted():
            out = alltoall(input, gather_dim, shard_dim, mesh, mesh_dim)
        mode.add_collective("all-to-all", out,
                            mesh.get_group(mesh_dim).group_name)
        if mode.scale:
            # the stand-in's chunk is a view of its gathered storage; the
            # all-to-all allocates its result alone
            mode.buffers.hold(out, nbytes(out))
            moved = mode.scale * (input.numel() * input.element_size()
                                  + out.numel() * out.element_size())
            mode.bytes += moved
            rec = mode.by_op.setdefault("all-to-all", {
                "count": 0, "flops": 0, "bytes": 0})
            rec["count"] += mode.scale
            rec["bytes"] += moved
        return out

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet_propagate
    placement_types.shard_dim_alltoall = one_alltoall
    for m in costing:
        m.redistribute_cost = plain_cost
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        placement_types.shard_dim_alltoall = alltoall
        for m in costing:
            m.redistribute_cost = cost


def spmd_cost(fn, *args, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` (on DTensors) under ``SpmdCost`` and
    ``counting``.  Returns (its result, {"flops", "bytes", "by_op",
    "collectives", "collective_bytes", "by_group", "buffers"}):
    ``buffers`` is ``LiveBytes.sizes`` of the result, the arguments'
    local shards held from the start, with "unseen", the functions whose
    live bytes the peak does not see (``StepCounted``'s, run at 2-4
    steps)."""
    with counting(), SpmdCost() as mode:
        mode.buffers.hold_arguments((args, kwargs))
        try:
            out = fn(*args, **kwargs)
            buffers = mode.buffers.sizes(out)
        finally:
            mode.buffers.close()
    buffers["unseen"] = sorted(mode.step_counted)
    return out, {**mode.result(), "buffers": buffers}
