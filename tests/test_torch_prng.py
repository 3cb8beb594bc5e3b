"""The port's threefry2x32 (repro_torch.core.prng) against jax.random, bit
for bit: the engine's compactions draw their ranges and pin decisions
from these bits, so any difference forks the two engines."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from torch_parity import assert_bit_equal


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_prng_key(seed):
    assert_bit_equal(np.asarray(jax.random.PRNGKey(seed)),
                     prng.PRNGKey(seed).numpy().astype(np.uint32))


@pytest.mark.parametrize("num", [2, 3, 8])
def test_split_chain(num):
    k, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for _ in range(16):
        s, ts = jax.random.split(k, num), prng.split(tk, num)
        assert_bit_equal(np.asarray(s), ts.numpy().astype(np.uint32))
        k, tk = s[-1], ts[-1]


@pytest.mark.parametrize("data", [0, 1, 2, 977, 2**32 - 1])
def test_fold_in(data):
    k, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    assert_bit_equal(np.asarray(jax.random.fold_in(k, data)),
                     prng.fold_in(tk, data).numpy().astype(np.uint32))


@pytest.mark.parametrize("maxval", [1, 2, 5, 37, 256, 49152, 2**31 - 1])
def test_randint_tensor_maxval(maxval):
    """randint with a device-scalar bound, as msc.candidate_ranges draws
    run positions in [0, max(n_active, 1))."""
    k, tk = jax.random.PRNGKey(5), prng.PRNGKey(5)
    for _ in range(8):
        want = jax.random.randint(k, (8,), 0, jnp.int32(maxval))
        got = prng.randint(tk, (8,), 0, torch.tensor(maxval,
                                                     dtype=torch.int32))
        assert_bit_equal(np.asarray(want), got.numpy())
        k, tk = jax.random.split(k)[0], prng.split(tk)[0]


def test_randint_int_bounds():
    k, tk = jax.random.PRNGKey(2), prng.PRNGKey(2)
    want = jax.random.randint(jax.random.fold_in(k, 1), (8,), 0, 256)
    got = prng.randint(prng.fold_in(tk, 1), (8,), 0, 256)
    assert_bit_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("n", [1, 7, 256, 4096])
def test_uniform(n):
    k, tk = jax.random.PRNGKey(9), prng.PRNGKey(9)
    for _ in range(4):
        assert_bit_equal(np.asarray(jax.random.uniform(k, (n,))),
                         prng.uniform(tk, (n,)).numpy())
        k, tk = jax.random.split(k)[1], prng.split(tk)[1]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_normal_matches_jax(seed):
    """``prng.normal``: the device-side hash gives ``random_bits``' words
    exactly; the draw is within rtol 1e-5 of ``jax.random.normal`` (torch's
    erfinv is not XLA's float32 approximation; up to 5.6e-6 measured, in
    the tails)."""
    key = prng.PRNGKey(seed)
    n = 5000
    words = prng._threefry_t(*prng._words(key),
                             torch.arange(n, dtype=torch.int64))
    np.testing.assert_array_equal(words.numpy(),
                                  prng.random_bits(key, (n,)).astype(np.int64))
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (50, 100)))
    got = prng.normal(key, (50, 100)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
