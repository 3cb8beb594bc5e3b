"""The value of every write, made from the write's id and the run's
seed: ``width`` float32 lanes, each an integer in [2^23, 2^24), exact in
float32 and not in any narrower type.

Write ``w`` (the load's writes are 0 .. n - 1 in load order, the
window's puts follow) has lane ``j`` equal to

    2^23 + (w * 2654435761 + j * 40503 + salt) mod 2^23

so two writes fewer than 2^23 apart differ in every lane, and a stale
value of a rewritten key reads wrong.  The store gets the values as
tensors made on the device; the reference keeps only each key's last
write id and makes the same lanes again with NumPy.
"""
from __future__ import annotations

import numpy as np

LO = 1 << 23
MUL, LANE_MUL = 2654435761, 40503


def salt(seed: int) -> int:
    return int(seed) % LO


def torch_values(salt_: int, wid, width: int):
    """[n, width] float32 on ``wid``'s device for int64 write ids."""
    import torch
    lane = torch.arange(width, dtype=torch.int64, device=wid.device)
    x = (wid.to(torch.int64)[:, None] * MUL + lane[None, :] * LANE_MUL
         + salt_) % LO
    return (x + LO).to(torch.float32)


def numpy_values(salt_: int, wid: np.ndarray, width: int) -> np.ndarray:
    """The same lanes, made on the host."""
    lane = np.arange(width, dtype=np.int64)
    x = (np.asarray(wid, np.int64)[:, None] * MUL + lane[None, :] * LANE_MUL
         + salt_) % LO
    return (x + LO).astype(np.float32)
