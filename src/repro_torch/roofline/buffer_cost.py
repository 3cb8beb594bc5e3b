"""What one rank holds while a cell runs: the port's counterpart of the
buffer sizes of XLA's ``memory_analysis`` (``output_size_in_bytes``,
``temp_size_in_bytes``, ``alias_size_in_bytes``), which the JAX
package's dry run reads from the compiled program.

XLA assigns a compiled program's buffers ahead of time: the arguments,
the results (``output``; the results that reuse a donated argument's
buffer are ``alias``) and, apart from them, the temporaries, whose
largest simultaneous size is ``temp``.  The port has no compiled
program.  It runs the cell eagerly on DTensors as rank 0 of the mesh,
each local shard a meta tensor (``roofline/comm_cost.SpmdCost``), and
``LiveBytes`` follows rank 0's local storages as the operations make
them:

* a storage is known by its ``untyped_storage()`` object (a meta tensor
  has no address), counted once however many views share it, and
  dropped from the live bytes when ``weakref.finalize`` says it is
  freed;
* an operation's result whose storage is neither known nor one of its
  inputs' is an allocation (a view or an in-place result allocates
  nothing); a DTensor's local shard is what is counted, not the
  wrapper, and what DTensor runs on fake tensors to learn a layout is
  not counted (``SpmdCost`` holds only counted operations);
* ``peak`` is the largest live sum, arguments included.

``sizes`` then gives XLA's split: ``output`` the bytes of the results'
local shards, ``alias`` those whose storage is an argument's (the
optimizer's moments and parameters, a decode cache: the port updates
them in place, where JAX's dry run returns new buffers), ``temp`` the
peak less the arguments and the results that are not aliases.  Eager
PyTorch frees a buffer when its last reference goes, where XLA reuses
buffers by its own plan, so the two temps differ (ROADMAP D9).  What a
peak cannot see is reported apart: the plain scans run 2-4 steps
(``op_cost.StepCounted``), so their live bytes at the full sequence are
not seen.
"""
from __future__ import annotations

import weakref

import torch

from repro_torch.core.tree import leaves


def local(t):
    """The tensor rank 0 holds of ``t``: a DTensor's local shard, a plain
    tensor itself, anything else None."""
    if type(t).__name__ == "DTensor":
        return t._local_tensor
    return t if isinstance(t, torch.Tensor) else None


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def _locals(tree):
    """The local tensors of the leaves of ``tree``."""
    return [t for t in map(local, leaves(tree)) if t is not None]


def _tensors(values):
    for v in values:
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, (list, tuple)):
            yield from _tensors(v)


class LiveBytes:
    """The live bytes of the storages it holds, and their peak."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self.arguments = 0
        self._held: dict = {}          # id(storage) -> (bytes, finalizer)
        self._args: set = set()        # id(storage) of the arguments

    def hold(self, t, size: int | None = None) -> bool:
        """Count ``t``'s storage (``size`` bytes; the storage's own by
        default) as live until it is freed.  False if it was held."""
        s = t.untyped_storage()
        key = id(s)
        if key in self._held:
            return False
        size = s.nbytes() if size is None else size
        self._held[key] = (size, weakref.finalize(s, self._free, key))
        self.live += size
        self.peak = max(self.peak, self.live)
        return True

    def _free(self, key) -> None:
        size, _ = self._held.pop(key)
        self.live -= size

    def hold_arguments(self, args) -> None:
        """Count the local shards of the tree ``args`` as the arguments,
        each at its own bytes (a shard cut from a global meta tensor is a
        view of the global storage)."""
        for t in _locals(args):
            if self.hold(t, nbytes(t)):
                self.arguments += nbytes(t)
            self._args.add(id(t.untyped_storage()))

    def allocated(self, inputs, out) -> None:
        """Count what an operation on ``inputs`` allocated for ``out``."""
        seen = {id(t.untyped_storage()) for t in _tensors(inputs)}
        for t in _tensors([out]):
            if id(t.untyped_storage()) not in seen:
                self.hold(t)

    def sizes(self, out) -> dict:
        """XLA's split of the peak for a cell whose results are the tree
        ``out``: {"output", "alias", "temp", "arguments", "peak"};
        arguments + output + temp - alias is the peak."""
        output = alias = 0
        seen = set()
        for t in _locals(out):
            key = (id(t.untyped_storage()), t.storage_offset(),
                   tuple(t.shape), t.stride())
            if key in seen:
                continue
            seen.add(key)
            output += nbytes(t)
            if id(t.untyped_storage()) in self._args:
                alias += nbytes(t)
        return {"output": output, "alias": alias,
                "temp": self.peak - self.arguments - (output - alias),
                "arguments": self.arguments, "peak": self.peak}

    def close(self) -> None:
        """Stop following the storages still held."""
        for _, fin in self._held.values():
            fin.detach()
        self._held.clear()
