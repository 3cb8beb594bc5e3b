"""Operation-level cost of a PyTorch function: the port's counterpart of
the JAX package's ``roofline/hlo_cost.py``.

``hlo_cost`` walks compiled XLA HLO because XLA's ``cost_analysis``
counts a ``while`` body (a scan over layers) once.  The port has no HLO;
its layers are a Python loop, so every operation is dispatched each time
it runs.  ``OpCost`` is a ``TorchDispatchMode`` that sees each aten
operation as it runs (forward, autograd's backward and the optimizer
alike) and tallies:

* ``flops``: by ``torch.utils.flop_counter``'s formulas, the ones
  ``FlopCounterMode`` uses (matmuls, convolutions, fused attention: 2 m n
  k for a matmul); elementwise operations count no FLOPs;
* ``bytes``: each operation's tensor inputs read plus its tensor outputs
  written, at their logical sizes; views and allocations move nothing.
  Operations are counted unfused, each going to memory and back, so this
  is an upper bound on HBM traffic: a fused kernel moves less.

It runs on meta tensors (shapes and dtypes, no values), so a full-width
cell costs no memory, and counts the same on real tensors.  Whatever
needs values (``.item()``, ``nonzero``, a boolean mask) raises on meta.

A Python loop over a sequence (the plain scans of RWKV-6 and Mamba) is
T dispatches a step, too slow to run at T = 32,768 even on meta.
``StepCounted`` is the counterpart of ``hlo_cost``'s trip-count
correction: it runs such a function at 2, 3 and 4 steps, forward and
(through autograd) backward, and adds the cost extrapolated to T, exact
where the cost past the first and last step is a polynomial of degree
at most 2 in T (a loop's forward is affine in T; autograd's backward
through per-step slices adds a full-size gradient a step, so it is
quadratic).  Its output is an
empty meta tensor of the full shape.

``counted_times`` is the counterpart for work that a mesh does n times
over parts of one shape (a rank's share of the expert-parallel MoE
dispatch): run once, counted n times, forward and backward.
"""
from __future__ import annotations

import contextlib
import copy

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# operations that move no bytes: allocations and metadata
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided,
               aten._unsafe_view, aten.lift_fresh, aten.sym_size,
               aten.sym_stride, aten.sym_numel, aten.sym_storage_offset}


def _nbytes(values) -> int:
    """Bytes of the tensors among ``values`` and in their lists."""
    n = 0
    for v in values:
        if isinstance(v, torch.Tensor):
            n += v.numel() * v.element_size()
        elif isinstance(v, (list, tuple)):
            n += _nbytes(v)
    return n


class OpCost(TorchDispatchMode):
    """Tallies FLOPs and bytes of every aten operation run under it:
    ``flops``, ``bytes`` and ``by_op`` {op name: {"count", "flops",
    "bytes"}}."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_op: dict = {}
        self.scale = 1             # each operation counts this many times

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        moved = 0
        if not (func.is_view or packet in _NO_TRAFFIC):
            moved = _nbytes((*args, *kwargs.values(), out))
        if self.scale:
            n = self.scale
            rec = self.by_op.setdefault(str(func), {"count": 0, "flops": 0,
                                                    "bytes": 0})
            rec["count"] += n
            rec["flops"] += n * flops
            rec["bytes"] += n * moved
            self.flops += n * flops
            self.bytes += n * moved
        return out

    @contextlib.contextmanager
    def uncounted(self):
        prev, self.scale = self.scale, 0
        try:
            yield
        finally:
            self.scale = prev

    def _snapshot(self):
        return self.flops, self.bytes, copy.deepcopy(self.by_op)

    def extrapolate(self, run, t: int) -> None:
        """Count ``run(n)`` (a loop of n steps) as if run at n = t, from
        runs at n = 2, 3, 4 (the first and the last step of a loop may
        differ from the others, so n = 1 is left out): with c(n) the cost
        of run(n), d1 = c(3) - c(2) and d2 = c(4) - 2 c(3) + c(2),
        c(t) = c(2) + (t-2) d1 + (t-2)(t-3)/2 d2.  Runs run(t) itself
        where t <= 4."""
        if t <= 4:
            run(t)
            return
        snaps = [self._snapshot()]
        for n in (2, 3, 4):
            run(n)
            snaps.append(self._snapshot())
        a, b = t - 2, (t - 2) * (t - 3) // 2

        def fit(v0, v1, v2, v3):
            c1, c2, c3 = v1 - v0, v2 - v1, v3 - v2
            return v0 + c1 + a * (c2 - c1) + b * (c3 - 2 * c2 + c1)

        self.flops = fit(*(s[0] for s in snaps))
        self.bytes = fit(*(s[1] for s in snaps))
        ops = set().union(*(s[2] for s in snaps))
        zero = {"count": 0, "flops": 0, "bytes": 0}
        self.by_op = {op: {k: fit(*(s[2].get(op, zero)[k] for s in snaps))
                           for k in zero} for op in ops}

    def result(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "by_op": dict(sorted(self.by_op.items()))}


def _active_cost() -> OpCost | None:
    modes = [m for m in _get_current_dispatch_mode_stack()
             if isinstance(m, OpCost)]
    return modes[-1] if modes else None


class StepCounted:
    """``fn`` (a loop over its sequence inputs' step dimension) counted by
    ``OpCost.extrapolate`` instead of run step by step: call it as
    ``fn``; ``steps`` maps the positional arguments that carry the
    sequence to their step dimension, ``out_dim`` is the output's.  For
    meta tensors under an ``OpCost`` only; the output is an empty meta
    tensor, and so is each gradient."""

    def __init__(self, fn, steps: dict, out_dim: int):
        self.fn, self.steps, self.out_dim = fn, steps, out_dim

    def _cut(self, args, n: int) -> list:
        return [a.narrow(self.steps[i], 0, n) if i in self.steps else a
                for i, a in enumerate(args)]

    def __call__(self, *args):
        return _StepCounted.apply(self, *args)


class _StepCounted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sc: StepCounted, *args):
        mode = _active_cost()
        if mode is None or any(a.device.type != "meta" for a in args):
            raise RuntimeError("StepCounted runs on meta tensors under an "
                               "OpCost only")
        i0 = next(iter(sc.steps))
        t = args[i0].shape[sc.steps[i0]]
        ctx.sc, ctx.t = sc, t
        ctx.save_for_backward(*args)
        mode.extrapolate(lambda n: sc.fn(*sc._cut(args, n)), t)
        with mode.uncounted():
            out = sc.fn(*sc._cut(args, 1))
        shape = list(out.shape)
        shape[sc.out_dim] = t
        return torch.empty(shape, dtype=out.dtype, device=out.device)

    @staticmethod
    def backward(ctx, gout):
        sc, t, args = ctx.sc, ctx.t, ctx.saved_tensors
        mode = _active_cost()
        need = [i for i, a in enumerate(args) if ctx.needs_input_grad[i + 1]]

        def run(n):
            with mode.uncounted(), torch.enable_grad():
                xs = [a.detach().requires_grad_(i in need)
                      for i, a in enumerate(sc._cut(args, n))]
                out = sc.fn(*xs)
            torch.autograd.grad(out, [xs[i] for i in need],
                                gout.narrow(sc.out_dim, 0, n),
                                allow_unused=True)

        if need:
            mode.extrapolate(run, t)
        return (None, *[torch.empty_like(a) if i in need else None
                        for i, a in enumerate(args)])


def op_cost(fn, *args, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` under ``OpCost``.  Returns (its result,
    {"flops", "bytes", "by_op"})."""
    with OpCost() as mode:
        out = fn(*args, **kwargs)
    return out, mode.result()


def counted_times(n: int, fn, *args):
    """``fn(*args)``, run once and counted ``n`` times by the active
    ``OpCost``, forward and (through autograd) backward: the work of n
    parts of one shape, as the ranks of a mesh do it.  Without an active
    ``OpCost``, ``fn(*args)``.  ``args`` are tensors; ``fn`` returns a
    tuple of tensors."""
    if _active_cost() is None:
        return fn(*args)
    return _CountedTimes.apply(fn, n, *args)


@contextlib.contextmanager
def _scaled(mode: OpCost, n: int):
    prev, mode.scale = mode.scale, mode.scale * n
    try:
        yield
    finally:
        mode.scale = prev


class _CountedTimes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, n, *args):
        ctx.fn, ctx.n = fn, n
        ctx.save_for_backward(*args)
        with _scaled(_active_cost(), n):
            outs = fn(*args)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *gouts):
        args, mode = ctx.saved_tensors, _active_cost()
        need = [i for i in range(len(args)) if ctx.needs_input_grad[i + 2]]
        with mode.uncounted(), torch.enable_grad():
            xs = [a.detach().requires_grad_(i in need)
                  for i, a in enumerate(args)]
            outs = ctx.fn(*xs)
        pairs = [(o, g) for o, g in zip(outs, gouts)
                 if o.requires_grad and g is not None]
        grads = [None] * len(args)
        if need and pairs:
            with _scaled(mode, ctx.n):
                got = torch.autograd.grad([o for o, _ in pairs],
                                          [xs[i] for i in need],
                                          [g for _, g in pairs],
                                          allow_unused=True)
            for i, g in zip(need, got):
                grads[i] = g
        return (None, None, *grads)
