"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place, holding its values one precision
below the configuration's float32 (bfloat16).

A run with ``--control bf16`` drives it through the cell's own set-up,
window and checks; its gets must come out wrong, or the comparison
could not tell a store that keeps values at a lower precision from one
that keeps them exactly.  The benchmark's own runs never use it.
"""
from __future__ import annotations

import torch


class ControlStore:
    """A map over the key space on the device, values in ``dtype``."""

    def __init__(self, config: dict, seed: int, device=None,
                 dtype=torch.bfloat16):
        tier = config["tier"]
        dev = torch.device("cuda" if device is None else device)
        self.key_space = tier["key_space"]
        self.value_width = tier["value_width"]
        self.vals = torch.zeros((self.key_space, self.value_width),
                                dtype=dtype, device=dev)
        self.present = torch.zeros(self.key_space, dtype=torch.bool,
                                   device=dev)

    def put(self, keys, vals) -> None:
        # the last write of a key in a batch wins, as in the store
        uniq, inv = torch.unique(keys.long(), return_inverse=True)
        order = torch.arange(keys.shape[0], device=keys.device)
        last = torch.full(uniq.shape, -1, dtype=torch.int64,
                          device=keys.device)
        last.scatter_reduce_(0, inv, order, reduce="amax")
        self.vals[uniq] = vals[last].to(self.vals.dtype)
        self.present[uniq] = True

    def get(self, keys):
        k = keys.long()
        return self.vals[k].to(torch.float32), self.present[k]

    def host_reads(self) -> int:
        return 0

    def compactions(self) -> int:
        return 0
