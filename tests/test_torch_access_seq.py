"""The port's exact ordered tracker update (``core/tracker.access_seq``)
against the JAX package's on the CPU, bit for bit: batches with slot
collisions, repeated keys and invalid entries, from tables that earlier
batches filled (clocks 0-3, both locations).  On batches whose keys share
no slot, the batched update (``access_batched``, the B1 kernel's
semantics) and B1's plain passes (``clock_update_passes``) equal it, as
tests/test_tracker_mapper.py holds JAX's ``access_batched`` to its
``access_seq``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tracker as jtracker
from repro_torch.core import tracker
from repro_torch.kernels.clock_update.ref import clock_update_passes
from torch_parity import assert_bit_equal, t

CAP = 64                  # a small table: 24-key batches collide often


def _batches(seed: int, n: int = 6, size: int = 24, key_space: int = 96):
    """``n`` batches of keys (repeats likely), int8 locations and a valid
    mask with about one entry in five invalid (its key -1 or any)."""
    rng = np.random.default_rng([seed, n, size])
    out = []
    for _ in range(n):
        keys = rng.integers(0, key_space, size).astype(np.int32)
        valid = rng.random(size) > 0.2
        keys[~valid & (rng.random(size) < 0.5)] = -1
        out.append((keys, rng.integers(0, 2, size).astype(np.int8), valid))
    return out


def _same(jst, st, msg):
    for name, a, b in zip(("keys", "clock", "loc"), jst, st):
        assert_bit_equal(np.asarray(a), b.numpy(), f"{msg} {name}")


@pytest.mark.parametrize("seed", range(6))
def test_access_seq_matches_jax(seed):
    """Batch after batch, every table bit-equal to JAX's ``access_seq``
    (its lax.scan, jitted); the input tables are left as they were."""
    step = jax.jit(jtracker.access_seq)
    jst, st = jtracker.init(CAP), tracker.init(CAP, device="cpu")
    collided = 0
    for i, (keys, locs, valid) in enumerate(_batches(seed)):
        slots = tracker.slot_of(CAP, t(keys))[t(valid)]
        collided += int(slots.numel() - slots.unique().numel())
        before = [x.clone() for x in st]
        jst = step(jst, jnp.asarray(keys), jnp.asarray(locs),
                   jnp.asarray(valid))
        new = tracker.access_seq(st, t(keys), t(locs), t(valid))
        assert all(torch.equal(a, b) for a, b in zip(before, st))
        st = new
        _same(jst, st, f"batch {i}")
    assert collided > 0
    assert set(st.clock.tolist()) >= {0, 3}


def _collision_free(seed: int):
    """A batch whose keys map to distinct slots of a 2,048-slot table (the
    filter of tests/test_tracker_mapper.py), every entry valid."""
    rng = np.random.default_rng([seed, 77])
    keys = rng.integers(0, 500, int(rng.integers(1, 64)))
    slots = tracker.slot_of(2048, t(keys.astype(np.int32))).tolist()
    first = {}
    for k, s in zip(keys.tolist(), slots):
        first.setdefault(s, k)
    keys = np.asarray(list(first.values()), np.int32)
    return keys, rng.integers(0, 2, keys.size).astype(np.int8), \
        np.ones(keys.size, bool)


@pytest.mark.parametrize("seed", range(5))
def test_batched_and_b1_plain_equal_access_seq_without_collisions(seed):
    """On collision-free batches, from an empty table and from the table
    the first batch left: ``access_batched`` and B1's plain passes equal
    ``access_seq`` bit for bit."""
    st = tracker.init(2048, device="cpu")
    for i in range(2):
        keys, locs, valid = (t(a) for a in _collision_free(seed + 10 * i))
        want = tracker.access_seq(st, keys, locs, valid)
        for fn in (tracker.access_batched, clock_update_passes):
            got = fn(tracker.TrackerState(*[x.clone() for x in st]), keys,
                     locs, valid)
            for a, b in zip(want, got):
                assert torch.equal(a, b), (fn.__name__, i)
        st = want
