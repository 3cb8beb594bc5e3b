"""A get batch: ``PrismDB.get`` of ``batch`` keys.  The answers (found,
and every value lane) of the steps the stream keeps are held on the
device, unread, and judged against the reference once the window has
closed."""
from __future__ import annotations

import numpy as np

LATENCY = "read"
ANSWERS = True      # its answer is judged against the reference


def make(ctx, n_steps: int, batch: int) -> dict:
    return {"keys": ctx.draw_keys(n_steps * batch).view(n_steps, batch)}


def submit(store, data: dict, j: int):
    return store.get(data["keys"][j])


def to_host(data: dict, used: list) -> dict:
    return {"keys": data["keys"][used].cpu().numpy()}


def replay(ref, host: dict, n: int, result) -> int:
    """The number of keys whose answer differs from the reference's
    (0 for a step whose answer was not kept)."""
    if result is None:
        return 0
    vals, found = result
    return ref.wrong(host["keys"][n], vals, found)


def written(host: dict, n: int) -> np.ndarray:
    return np.zeros(0, np.int32)
