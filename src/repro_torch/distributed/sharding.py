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
``DeviceMesh``, the port's counterpart of ``NamedSharding``.

``constrain`` (the activations' sharding constraint) and
``leading_axis_sharding`` are not ported: the port runs no model or
partition stack over a mesh yet (ROADMAP Queue 1, G).
"""
from __future__ import annotations

import contextlib
import math
import threading

from torch.distributed.tensor import Replicate, Shard

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
