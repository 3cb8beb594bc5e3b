"""Shared helpers of the PyTorch-port parity tests: move trees between the
JAX package and the port through numpy, and compare them leaf by leaf."""
from __future__ import annotations

import numpy as np
import torch


def leaves(tree, path: str = "") -> list:
    """(path, numpy array) for every leaf of a NamedTuple/tuple tree, in
    the order ``jax.tree.leaves`` uses (None is an empty subtree)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += leaves(getattr(tree, f), f"{path}.{f}")
        return out
    if isinstance(tree, tuple):
        out = []
        for i, v in enumerate(tree):
            out += leaves(v, f"{path}[{i}]")
        return out
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [(path, tree.detach().cpu().numpy())]
    return [(path, np.asarray(tree))]


def bits(a: np.ndarray) -> np.ndarray:
    return np.atleast_1d(np.ascontiguousarray(a)).view(np.uint8)


def assert_bit_equal(a: np.ndarray, b: np.ndarray, msg: str = "") -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (msg, a.dtype, b.dtype, a.shape, b.shape)
    if not np.array_equal(bits(a), bits(b)):
        bad = np.flatnonzero(np.atleast_1d(a).ravel()
                             != np.atleast_1d(b).ravel())[:8]
        raise AssertionError(f"{msg}: differs at {bad.tolist()}")


def assert_trees_equal(want, got, float_rtol: dict | None = None) -> None:
    """Bit-equality of every leaf; leaves named in ``float_rtol`` are held
    to that relative tolerance instead (stated per leaf by the caller)."""
    float_rtol = float_rtol or {}
    a, b = leaves(want), leaves(got)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        if p in float_rtol:
            np.testing.assert_allclose(y, x, rtol=float_rtol[p], atol=0,
                                       err_msg=p)
        else:
            assert_bit_equal(x, y, p)


def t(x, dtype=None) -> torch.Tensor:
    """numpy -> CPU tensor (a copy)."""
    a = torch.from_numpy(np.array(x, copy=True))
    return a if dtype is None else a.to(dtype)
