"""Logical-axis sharding rules (MaxText-style; the port's copy of the JAX
package's ``distributed/sharding.py``).

Model code names each parameter's and cache's dimensions with *logical*
axes (``models/common.ParamInit``, ``model.param_specs``,
``model.cache_specs``); the rules map them to mesh axes.  The mapping is
size-aware: a mesh axis is applied only where it divides the dimension
(4 KV heads on a 16-way model axis stay replicated instead of padded 4x),
and no mesh axis is used twice in one spec.

A spec is a plain tuple with one entry per dimension: a mesh-axis name,
a tuple of names, or None (replicated) -- what a
``jax.sharding.PartitionSpec`` holds.  A mesh is anything with
``axis_names`` and ``axis_sizes`` (``launch/mesh.make_production_mesh``'s
stand-in for the 256- and 512-chip meshes), or a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions.
``placements`` turns a spec into the DTensor placements of a
``DeviceMesh``, the port's counterpart of ``NamedSharding``
(``named_sharding_tree`` for a tree, ``leading_axis_sharding`` for a
stacked per-partition state).

``distribute_tree`` lays a tree of tensors out as DTensors by their
logical specs, each leaf's local shard cut from it (meta tensors give
meta shards, so a full-width cell costs no memory); ``batch_like`` lays
a tensor the model makes (positions) out over the mesh axes that shard
an activation's batch; ``on_local_shards`` runs a function on the local
shards of its DTensor arguments, as JAX's ``shard_map`` runs its body,
after redistributing each to the placements it needs (so every gather
that needs is issued, and counted by ``roofline/comm_cost``).
``register_strategies`` gives DTensor the sharding strategies it lacks
for operations the models run (``aten.searchsorted``, batched over its
leading dimensions).  ``vocab_logsumexp`` and ``vocab_gather`` are the
loss's reduction and gold-logit gather on logits sharded on their
vocabulary, each rank on its own columns.

The model code imports this module for ``constrain``, so
``torch.distributed.tensor`` is imported only where a DTensor is made
or read.

``use_mesh`` makes a mesh ambient in this thread while a block runs, as
``jax.set_mesh`` does; ``current_mesh`` reads it, as
``jax.sharding.get_abstract_mesh`` does.  ``constrain`` is the
activations' sharding constraint under it: a DTensor on the ambient
``DeviceMesh`` is redistributed to its logical spec, and anything else
(no ambient mesh, a stand-in mesh, a plain tensor) passes unchanged, as
JAX's constraint does without a mesh.  The expert-parallel MoE dispatch
(``models/moe.moe_ffn_ep_local``) and the dry run read the ambient mesh.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.core.tree import is_spec, map_tree

# logical axis -> mesh axis (or tuple of axes, or None = replicated)
DEFAULT_RULES = {
    # activations
    "batch": ("pod", "data"),    # pod folds into DP when present
    "seq": None,
    "act_seq": "data",           # context/sequence parallelism (long ctx)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "capacity": None,
    # param-only axes
    "layers": None,
    "stack": None,
    "zero": "data",              # ZeRO-1 optimizer-state sharding
    # decode caches: prefer kv_heads on model; head_dim picks model up when
    # kv_heads isn't divisible (size-aware mapping drops it there)
    "cache_seq": None,
    "cache_head_dim": "model",
    # paged kv pools
    "pages": "data",
    "page_tokens": None,
    # shared-nothing PartitionedDB shards: the leading partition axis
    "part": "part",
}

_state = threading.local()


def current_rules() -> dict:
    return getattr(_state, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def axis_rules(rules: dict):
    """Use ``rules`` in this thread while the block runs."""
    prev = current_rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def current_mesh():
    """The ambient mesh of this thread (``use_mesh``), or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a named ``DeviceMesh``, or a stand-in with
    ``axis_names`` and ``axis_sizes`` such as ``launch/mesh.MeshShape``)
    the ambient mesh in this thread while the block runs."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def mesh_axes(mesh) -> dict:
    """{axis name: size} of ``mesh``, in the mesh's axis order."""
    if hasattr(mesh, "axis_sizes"):
        return dict(zip(mesh.axis_names, mesh.axis_sizes))
    names = mesh.mesh_dim_names                 # a DeviceMesh
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to take specs")
    return dict(zip(names, mesh.mesh.shape))


def logical_to_spec(logical, mesh, shape=None, allowed=None) -> tuple:
    """Map logical axis names to a spec (a tuple) for ``mesh``.

    Drops mesh axes that don't exist, that aren't in ``allowed``, that
    an earlier dimension already took, and (when ``shape`` is given)
    axes that don't divide the dimension."""
    rules = current_rules()
    sizes = mesh_axes(mesh) if mesh is not None else {}
    have = set(sizes)
    if allowed is not None:
        have &= set(allowed)
    out, used = [], set()
    for i, name in enumerate(logical):
        mapped = rules.get(name) if name is not None else None
        if mapped is None:
            out.append(None)
            continue
        cands = mapped if isinstance(mapped, tuple) else (mapped,)
        cands = [c for c in cands if c in have and c not in used]
        if shape is not None:
            keep, prod = [], 1
            for c in cands:
                if shape[i] % (prod * sizes[c]) == 0:
                    keep.append(c)
                    prod *= sizes[c]
            cands = keep
        if not cands:
            out.append(None)
        elif len(cands) == 1:
            out.append(cands[0])
        else:
            out.append(tuple(cands))
        used.update(cands)
    return tuple(out)


def constrain(x, logical):
    """The sharding constraint of an activation: ``x`` unchanged when no
    mesh is ambient, when the ambient mesh is a stand-in, or when ``x``
    is a plain tensor; a DTensor on the ambient ``DeviceMesh``
    redistributed to the placements of ``logical``'s spec for its
    shape."""
    mesh = current_mesh()
    if mesh is None or hasattr(mesh, "axis_sizes"):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    if x.device_mesh != mesh:
        raise ValueError("constrain: the DTensor lies on another mesh than "
                         "the ambient one")
    spec = logical_to_spec(logical, mesh, shape=x.shape)
    return x.redistribute(mesh, _on_ranks(placements(spec, mesh), mesh))


def spec_tree(specs, shapes, mesh):
    """specs: a tree of logical tuples; shapes: the matching tree of
    tensors (meta tensors will do) -> the tree of mesh specs."""
    return map_tree(lambda s, v: logical_to_spec(s, mesh, shape=v.shape),
                    specs, shapes, is_leaf=is_spec)


def shard_count(spec, mesh) -> int:
    """How many shards a mesh spec cuts a tensor into (the product of the
    sizes of the mesh axes it names)."""
    sizes = mesh_axes(mesh)
    names = [n for e in spec if e is not None
             for n in (e if isinstance(e, tuple) else (e,))]
    return math.prod(sizes[n] for n in names)


def placements(spec, mesh) -> list:
    """A mesh spec -> the DTensor placements of ``mesh`` (a named
    ``DeviceMesh``): ``Shard(d)`` on each mesh dimension that tensor
    dimension d names, ``Replicate()`` on the others.  A dimension split
    over several mesh axes must name them in the mesh's order, which is
    the order DTensor splits in."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh_axes(mesh))
    out = [Replicate()] * len(order)
    for d, e in enumerate(spec):
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        idx = [order.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e!r} is not in the mesh's axis "
                             f"order {order}")
        for i in idx:
            out[i] = Shard(d)
    return out


def named_sharding_tree(specs, shapes, mesh):
    """specs: a tree of logical tuples; shapes: the matching tree of
    tensors -> the tree of DTensor placements on ``mesh`` (JAX's tree of
    ``NamedSharding``)."""
    return map_tree(lambda s, v: placements(
        logical_to_spec(s, mesh, shape=v.shape), mesh), specs, shapes,
        is_leaf=is_spec)


def leading_axis_sharding(tree, mesh, logical: str = "part"):
    """The placements that shard every leaf's leading axis by ``logical``
    and replicate the rest: the layout of a stacked per-partition
    ``EngineState`` over the partition mesh.  Size-aware as every spec
    is: a leaf whose leading dimension the mesh axis does not divide
    stays replicated rather than padded."""
    return map_tree(lambda x: placements(logical_to_spec(
        (logical,) + (None,) * (x.dim() - 1), mesh, shape=x.shape), mesh),
        tree)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor for a plain
    tensor)."""
    return type(x).__name__ == "DTensor"


def _on_ranks(placements_: list, mesh) -> list:
    """``placements_`` with a mesh dimension of one rank replicated: the
    same layout, which DTensor then never has to unshard."""
    from torch.distributed.tensor import Replicate
    return [Replicate() if mesh.size(i) == 1 else p
            for i, p in enumerate(placements_)]


def from_global(t, mesh, placements_):
    """``t`` (the global tensor) as a DTensor on ``mesh``: rank 0's local
    shard cut from ``t`` by ``placements_`` (no data moves; a meta ``t``
    gives a meta shard; a mesh dimension of one rank replicates)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    placements_ = _on_ranks(placements_, mesh)
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, mesh, placements_)
    local = t
    for d, (n, o) in enumerate(zip(shape, offset)):
        if n != t.shape[d]:
            local = local.narrow(d, o, n)
    return DTensor.from_local(local.contiguous(), mesh, placements_,
                              run_check=False, shape=t.shape,
                              stride=t.contiguous().stride())


def distribute_tree(specs, tensors, mesh):
    """specs: a tree of logical tuples; tensors: the matching tree ->
    the tree of DTensors on ``mesh`` (a named ``DeviceMesh``), each leaf
    placed by ``placements(logical_to_spec(spec, mesh, shape))``."""
    return map_tree(lambda sp, t: from_global(t, mesh, placements(
        logical_to_spec(sp, mesh, shape=t.shape), mesh)), specs, tensors,
        is_leaf=is_spec)


def batch_like(t, x):
    """``t`` (a tensor the model makes, whose first dimension is the
    batch) laid out as ``x``'s batch: sharded on dimension 0 over the
    mesh dimensions that shard ``x``'s dimension 0, replicated over the
    others.  ``t`` itself when ``x`` is not a DTensor."""
    if not is_dtensor(x):
        return t
    from torch.distributed.tensor import Replicate, Shard
    pl = [Shard(0) if p == Shard(0) else Replicate() for p in x.placements]
    return from_global(t, x.device_mesh, pl)


def on_local_shards(fn, in_placements, out_placements, *args):
    """``fn`` on the local shards of ``args``, JAX's ``shard_map``: each
    DTensor argument is redistributed to its entry of ``in_placements``
    (None: as it lies), ``fn`` runs on the local tensors, and each
    output is a DTensor with its entry of ``out_placements`` on the
    arguments' mesh.  Differentiable.  Plain arguments pass through, and
    with no DTensor argument ``fn(*args)`` is returned as it is."""
    from torch.distributed.tensor import DTensor
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)
    mesh = dts[0].device_mesh
    local = []
    for a, pl in zip(args, in_placements):
        if is_dtensor(a):
            # contiguous first: DTensor's redistribution may lay the
            # local shard out otherwise than its strides say
            a = a.contiguous()
            if pl is not None and tuple(pl) != tuple(a.placements):
                a = a.redistribute(mesh, pl)
            a = a.to_local()
        local.append(a)
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    wrapped = tuple(o if pl is None else DTensor.from_local(
        o, mesh, pl, run_check=False)
        for o, pl in zip(outs, out_placements))
    return wrapped[0] if single else wrapped


def on_row_shards(fn, batch_dims, channel_dims, *args, n_out: int = 1):
    """``fn``, which treats each batch row and each channel apart (a
    scan), on local shards (``on_local_shards``).  ``batch_dims`` and
    ``channel_dims`` give each argument's batch and channel dimension
    (None: it has none).  On each mesh dimension the first argument's
    placement decides: sharded on its batch (channel) dimension, every
    argument is sharded on its own batch (channel) dimension and
    replicated where it has none; otherwise all are replicated.  Each of
    the ``n_out`` outputs (a tuple when more than one) is laid out as
    the first argument then is."""
    if not is_dtensor(args[0]):
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard
    ins = [[] for _ in args]
    for p in args[0].placements:
        dims = None
        if isinstance(p, Shard) and p.dim == batch_dims[0]:
            dims = batch_dims
        elif isinstance(p, Shard) and p.dim == channel_dims[0]:
            dims = channel_dims
        for pl, d in zip(ins, dims or [None] * len(args)):
            pl.append(Replicate() if d is None else Shard(d))
    return on_local_shards(fn, ins, [ins[0]] * n_out, *args)


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, backward_sums: bool):
        ctx.group, ctx.backward_sums = group, backward_sums
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return (_all_reduce(g, ctx.group) if ctx.backward_sums else g,
                None, None)


def _all_reduce(t, group, op: str = "sum"):
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(t, op, group))


def group_sum(t, group, backward_sums: bool = False):
    """The sum of the local tensor ``t`` over the ranks of ``group``: one
    functional all-reduce (which ``roofline/comm_cost`` counts).  Its
    gradient is the incoming gradient (each rank's part of a replicated
    sum), or with ``backward_sums`` the gradient's sum over the group
    too (the transpose JAX gives ``psum`` in an unchecked
    ``shard_map``)."""
    return _GroupSum.apply(t, group, backward_sums)


def embedding_lookup(table, tokens):
    """``F.embedding(tokens, table)``.  On a DTensor table sharded on its
    vocabulary over one mesh dimension, each rank looks its tokens up in
    its own rows (zeros for the others) and the rows are summed over
    that dimension's group (``group_sum``): the output is laid out as
    ``tokens``, with the embedding dimension whole."""
    if not is_dtensor(table) or not any(p.is_shard(0)
                                        for p in table.placements):
        return F.embedding(tokens, table)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = table.device_mesh
    dims = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    if len(dims) > 1 or any(p.is_shard(1) for p in table.placements):
        raise NotImplementedError("embedding_lookup: a table sharded on "
                                  "more than its vocabulary over one axis")
    shape, offset = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)
    lo, n = offset[0], shape[0]
    group = mesh.get_group(dims[0])
    rows = tokens.placements if is_dtensor(tokens) else \
        [Replicate()] * mesh.ndim

    def local(t, tok):
        out_of = (tok < lo) | (tok >= lo + n)
        e = F.embedding(torch.where(out_of, 0, tok - lo), t)
        return group_sum(torch.where(out_of[..., None], 0, e), group)

    return on_local_shards(local, [None, rows], [list(rows)], table,
                           tokens)


def _vocab_shards(logits):
    """The mesh dimensions that shard the last (vocabulary) dimension of
    the DTensor ``logits``, as a list of flags; None when ``logits`` is
    no DTensor or is whole on its last dimension."""
    last = logits.ndim - 1
    if not is_dtensor(logits):
        return None
    vocab = [p.is_shard(last) for p in logits.placements]
    return vocab if any(vocab) else None


def vocab_logsumexp(logits):
    """``torch.logsumexp(logits, -1)``.  On a DTensor sharded on its last
    (vocabulary) dimension, each rank reduces its own columns: the
    maximum and the sum of exponentials are all-reduced over the
    vocabulary's groups, where DTensor would gather the whole vocabulary
    to every rank.  The output is laid out as ``logits`` on the other
    dimensions."""
    vocab = _vocab_shards(logits)
    if vocab is None:
        return torch.logsumexp(logits, dim=-1)
    from torch.distributed.tensor import Replicate
    mesh = logits.device_mesh
    groups = [mesh.get_group(d) for d, v in enumerate(vocab) if v]
    rows = [Replicate() if v else p
            for v, p in zip(vocab, logits.placements)]

    def local(t):
        m = t.detach().amax(-1, keepdim=True)
        for group in groups:
            m = _all_reduce(m, group, "max")
        e = torch.exp(t - m).sum(-1, keepdim=True)
        for group in groups:
            e = group_sum(e, group)
        return (torch.log(e) + m)[..., 0]

    return on_local_shards(local, [None], [rows], logits)


def vocab_gather(logits, index):
    """``torch.gather(logits, -1, index)``.  On a DTensor ``logits``
    sharded on its last (vocabulary) dimension, each rank gathers from
    its own columns (zeros for the others) and the values are summed
    over the vocabulary's groups (``group_sum``): the output is laid out
    as ``index`` on the other mesh dimensions, and its gradient scatters
    into each rank's own columns, where DTensor's gather would make the
    gradient's zeros at the global shape on every rank."""
    vocab = _vocab_shards(logits)
    if vocab is None:
        return torch.gather(logits, -1, index)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, last = logits.device_mesh, logits.ndim - 1
    rows = list(index.placements) if is_dtensor(index) else \
        [Replicate()] * mesh.ndim
    rows = [Replicate() if v else p for v, p in zip(vocab, rows)]
    cols = [Shard(last) if v else p for v, p in zip(vocab, rows)]
    shape, offset = compute_local_shape_and_global_offset(
        logits.shape, mesh, cols)
    lo, n = offset[last], shape[last]
    groups = [mesh.get_group(d) for d, v in enumerate(vocab) if v]

    def local(t, idx):
        out_of = (idx < lo) | (idx >= lo + n)
        g = torch.where(out_of, 0, torch.gather(
            t, -1, torch.where(out_of, 0, idx - lo)))
        for group in groups:
            g = group_sum(g, group)
        return g

    return on_local_shards(local, [cols, rows], [rows], logits, index)


_registered = []


def register_strategies() -> None:
    """Give DTensor a sharding strategy for the operations the models
    run that it has none for (once per process): ``aten.searchsorted``
    on the rows of a batch, sharded on any leading dimension of both
    inputs (the output follows ``self``), or everything replicated."""
    if _registered:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.searchsorted.Tensor)
    def _searchsorted(sorted_sequence, values, *args, **kwargs):
        out = [([Replicate()], [Replicate(), Replicate()])]
        if sorted_sequence.ndim == values.ndim:
            out += [([Shard(d)], [Shard(d), Shard(d)])
                    for d in range(values.ndim - 1)]
        return out

    _registered.append(True)
