"""Bit-exact port of ``jax.random``'s threefry2x32 generator.

The engine's compactions draw their candidate key ranges and their pin
decisions from ``jax.random`` in the JAX package, so the port must
produce the very same bits: a ``torch.Generator`` would pick other
ranges and the two engines would part ways at the first compaction.

Keys are int64 CPU tensors of shape ``[..., 2]`` holding the two uint32
key words (the layout of a raw ``jax.random.PRNGKey``).  They live on the
host: a key never depends on device data, and the 20 threefry rounds are
~140 elementwise operations that would each be a kernel launch on the
card.  The hash runs in numpy uint32 (which wraps like the JAX
package's uint32); only the finished draws move to the device.
Semantics follow jax 0.9 with its default
``jax_threefry_partitionable=True``:

* ``split(key, n)``   = threefry(key, (0, i)) for i in [0, n)
* ``random_bits``     = w0 ^ w1 of threefry(key, (0, i)) over the flat
                        element index i
* ``fold_in(key, d)`` = threefry(key, (0, d))

A bulk draw (``normal``: an embedding table of 3e8 values) runs the same
hash as int64 tensor ops on the target device, in chunks.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_U = np.uint32


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U(d)) | (x >> _U(32 - d))


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32, 20 rounds (``jax._src.prng._threefry2x32_lowering``)
    on uint32 numpy arrays."""
    ks = (_U(k0), _U(k1), _U(k0 ^ k1 ^ 0x1BD11BDA))
    x0 = x0.astype(_U) + ks[0]
    x1 = x1.astype(_U) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U(i + 1)
    return x0, x1


def _words(key: torch.Tensor) -> tuple[int, int]:
    k = key.reshape(-1).tolist()
    return int(k[0]) & M32, int(k[1]) & M32


def _key(w0, w1) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.asarray(w0, np.int64),
                                      np.asarray(w1, np.int64)], axis=-1))


def PRNGKey(seed: int) -> torch.Tensor:
    """Raw key of an integer seed: (seed >> 32, seed & 0xFFFFFFFF)."""
    s = int(seed)
    return _key((s >> 32) & M32 if s >= 0 else 0, s & M32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: int64[num, 2]."""
    c = np.arange(num, dtype=_U)
    b0, b1 = threefry2x32(*_words(key), np.zeros_like(c), c)
    return _key(b0, b1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    d = np.asarray([int(data) & M32], _U)
    b0, b1 = threefry2x32(*_words(key), np.zeros_like(d), d)
    return _key(b0[0], b1[0])


def random_bits(key: torch.Tensor, shape: tuple) -> np.ndarray:
    """32 random bits per element (uint32 numpy array of ``shape``)."""
    n = int(np.prod(shape, dtype=np.int64))
    c = np.arange(n, dtype=_U)
    b0, b1 = threefry2x32(*_words(key), np.zeros_like(c), c)
    return (b0 ^ b1).reshape(shape)


def _to(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device,
                                                        non_blocking=True)


def randint(key: torch.Tensor, shape: tuple, minval, maxval,
            device=None) -> torch.Tensor:
    """``jax.random.randint`` for int32 output.  ``minval``/``maxval`` are
    ints or 0-dim int tensors; a tensor bound stays on its device (the
    draws move there, no host read), else the result goes to ``device``."""
    bound = maxval if torch.is_tensor(maxval) else minval
    dev = bound.device if torch.is_tensor(bound) else (device or "cpu")
    k1, k2 = split(key, 2)
    higher = _to(random_bits(k1, shape).astype(np.int64), dev)
    lower = _to(random_bits(k2, shape).astype(np.int64), dev)
    lim = lambda v: (v.to(torch.int64) if torch.is_tensor(v) else
                     torch.full((), int(v), dtype=torch.int64, device=dev)
                     ).clamp(-2**31, 2**31 - 1)
    minval, maxval = lim(minval), lim(maxval)
    span = (maxval - minval) & M32
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    mult = 65536 % span
    mult = ((mult * mult) & M32) % span          # uint32 product wraps
    off = (((higher % span) * mult) & M32) + (lower % span)
    off = (off & M32) % span
    out = minval + off
    out = ((out + 2**31) & M32) - 2**31          # int32 wrap of the sum
    return out.to(torch.int32)


def uniform(key: torch.Tensor, shape: tuple, device=None) -> torch.Tensor:
    """``jax.random.uniform`` on [0, 1) in float32."""
    bits = random_bits(key, shape)
    f = ((bits >> _U(9)) | _U(0x3F800000)).view(np.float32) \
        - np.float32(1.0)
    return _to(np.maximum(f, np.float32(0.0)), device or "cpu")


def _threefry_t(k0: int, k1: int, x1: torch.Tensor) -> torch.Tensor:
    """``threefry2x32`` on int64 tensors holding uint32 values (x0 = 0),
    on ``x1``'s device; returns ``w0 ^ w1`` (the ``random_bits`` word)."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & M32)
    x0 = torch.full_like(x1, ks[0])
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0 ^ x1


_CHUNK = 1 << 24     # elements hashed at a time: 128 MB int64 temporaries


def normal(key: torch.Tensor, shape: tuple, device=None) -> torch.Tensor:
    """``jax.random.normal`` in float32: uniform on (-1, 1) from the same
    bits (exact), then ``sqrt(2) * erfinv``.  torch's ``erfinv`` is not
    XLA's approximation, so values agree to a few ULP, not bit for bit
    (up to 5.6e-6 relative, in the tails).  The hash runs on ``device``
    (default CPU), in chunks."""
    dev = torch.device(device or "cpu")
    n = int(np.prod(shape, dtype=np.int64))
    k0, k1 = _words(key)
    f32 = torch.float32
    lo_np = np.nextafter(np.float32(-1), np.float32(0))
    lo = torch.full((), float(lo_np), dtype=f32, device=dev)
    span = torch.full((), float(np.float32(1) - lo_np), dtype=f32,
                      device=dev)
    root2 = torch.full((), float(np.float32(np.sqrt(2))), dtype=f32,
                       device=dev)
    out = torch.empty(n, dtype=f32, device=dev)
    for a in range(0, n, _CHUNK):
        c = torch.arange(a, min(n, a + _CHUNK), dtype=torch.int64,
                         device=dev)
        bits = _threefry_t(k0, k1, c)
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(f32) - 1.0
        u = torch.maximum(lo, f * span + lo)
        out[a:a + c.numel()] = root2 * torch.special.erfinv(u)
    return out.view(shape)
