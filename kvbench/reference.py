"""The plain reference of a key-value store: a map over the key space.

It keeps each key's last write id (-1: never written), replayed batch by
batch with the same load and op stream the store got, and makes each
expected value from its write id (``values.numpy_values``).  Semantics:
a put sets each key's value, the last write of a key in a batch
winning; a get of a key never written misses.  NumPy only: it imports
nothing of the program.
"""
from __future__ import annotations

import numpy as np

from kvbench import values


def last_writes(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(distinct keys, index of each key's last occurrence)."""
    keys = np.asarray(keys)
    uniq, first_rev = np.unique(keys[::-1], return_index=True)
    return uniq, keys.shape[0] - 1 - first_rev


class Reference:
    def __init__(self, key_space: int, width: int, salt: int):
        self.wid = np.full(key_space, -1, np.int64)
        self.width, self.salt = width, salt

    def put(self, keys, wids) -> None:
        uniq, last = last_writes(keys)
        self.wid[uniq] = np.asarray(wids, np.int64)[last]

    def expect(self, keys) -> tuple[np.ndarray, np.ndarray]:
        w = self.wid[np.asarray(keys)]
        return (values.numpy_values(self.salt, np.maximum(w, 0), self.width),
                w >= 0)

    def wrong_mask(self, keys, vals, found) -> np.ndarray:
        """True where an answer differs: found where the key was never
        written (or the reverse), or any value lane not equal."""
        want_vals, want_found = self.expect(keys)
        found = np.asarray(found, bool)
        differs = (np.asarray(vals, np.float32) != want_vals).any(axis=1)
        return (found != want_found) | (want_found & differs)

    def wrong(self, keys, vals, found) -> int:
        return int(self.wrong_mask(keys, vals, found).sum())
