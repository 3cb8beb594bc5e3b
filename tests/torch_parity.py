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


# ------------------------------------------------ process groups (gloo)

def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo_rank(rank: int, world: int, port: int, fn, args: tuple) -> None:
    """One spawned rank: a gloo group on 127.0.0.1, then ``fn(rank, world,
    *args)``; records in ``args``' files are ``fn``'s to write."""
    import datetime
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_gloo(fn, world: int, *args, timeout_s: float = 120.0) -> None:
    """Run ``fn(rank, world, *args)`` (a module-level function: the
    children import its module, so that module imports no JAX at its top)
    in ``world`` spawned gloo ranks; kill them all and fail if any still
    runs after ``timeout_s`` or exits with an error."""
    import time
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_gloo_rank, args=(r, world, port, fn, args))
             for r in range(world)]
    for pr in procs:
        pr.start()
    deadline = time.monotonic() + timeout_s
    try:
        for pr in procs:
            pr.join(max(deadline - time.monotonic(), 0.0))
        hung = [i for i, pr in enumerate(procs) if pr.is_alive()]
        assert not hung, f"gloo ranks {hung} still running after " \
            f"{timeout_s} s"
        codes = [pr.exitcode for pr in procs]
        assert codes == [0] * world, f"gloo ranks exited with {codes}"
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()


def jax_modules() -> list:
    """The JAX modules and the JAX package's modules this process has
    imported (a gloo rank must have none)."""
    import sys
    return sorted(m for m in sys.modules if m == "jax"
                  or m.startswith(("jax.", "repro.")))
