"""A put batch: ``PrismDB.put`` of ``batch`` keys, each with a value of
its own.

Step ``j`` of this kind writes ids ``wid0 + j * batch .. + batch - 1``,
and its values are made from them on the device as the step is sent
(``kvbench/values.py``), so the stream holds keys alone.  Within a batch
the last write of a key wins, as in the store.
"""
from __future__ import annotations

import numpy as np
import torch

from kvbench import values

LATENCY = "update"
ANSWERS = False     # a put returns nothing to judge


def make(ctx, n_steps: int, batch: int) -> dict:
    return {"keys": ctx.draw_keys(n_steps * batch).view(n_steps, batch),
            "wid0": ctx.wid0, "salt": ctx.salt, "width": ctx.value_width}


def _wids(data: dict, j: int, device=None):
    b = data["keys"].shape[1]
    return torch.arange(data["wid0"] + j * b, data["wid0"] + (j + 1) * b,
                        dtype=torch.int64, device=device)


def submit(store, data: dict, j: int):
    keys = data["keys"][j]
    store.put(keys, values.torch_values(
        data["salt"], _wids(data, j, keys.device), data["width"]))
    return None


def to_host(data: dict, used: list) -> dict:
    return {"keys": data["keys"][used].cpu().numpy(),
            "wid0": data["wid0"], "batch": data["keys"].shape[1],
            "used": used}


def replay(ref, host: dict, n: int, result) -> int:
    """Apply the acknowledged batch (the ``n``-th used step) to the
    reference; a put has no answer to judge."""
    j, b = host["used"][n], host["batch"]
    ref.put(host["keys"][n],
            np.arange(host["wid0"] + j * b, host["wid0"] + (j + 1) * b))
    return 0


def written(host: dict, n: int) -> np.ndarray:
    """Keys that the ``n``-th used step of this kind acknowledged."""
    return host["keys"][n]
