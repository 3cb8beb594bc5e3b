"""The clock_update kernel's three passes (B1) in plain PyTorch.

``clock_update_passes`` computes what ``csrc/clock_update.cu`` computes,
pass for pass, on T-sized tables: claim (the last valid access of each
slot, and its last access that matches the resident key, as
``scatter_reduce`` "amax"), mark (a winner's ``dup`` flag: another valid
access of its slot carries its key) and apply.  It stands beside
``tracker.access_batched``, which counts each key's occurrences with a
sort instead, so the tests can hold the kernel's argument (a key occurs
twice or more iff its slot's winner has a duplicate in its slot) on the
CPU.  Returns new tables; the input tables are left untouched.
"""
from __future__ import annotations

import torch

from repro_torch.core import tracker


def clock_update_passes(state: tracker.TrackerState, keys: torch.Tensor,
                        locs: torch.Tensor, valid: torch.Tensor
                        ) -> tracker.TrackerState:
    t = state.capacity
    b = keys.shape[0]
    dev = keys.device
    keys = keys.to(torch.int32)
    j = torch.arange(b, dtype=torch.int64, device=dev)
    s = tracker.slot_of(t, keys).to(torch.int64)
    neg = torch.full((t,), -1, dtype=torch.int64, device=dev)
    # claim
    last_cand = neg.scatter_reduce(0, s[valid], j[valid], "amax")
    hit = valid & (state.keys[s] == keys)
    last_hit = neg.scatter_reduce(0, s[hit], j[hit], "amax")
    # mark: w is each valid access's slot winner
    w = torch.where(valid, last_cand[s], j)
    other = valid & (w != j) & (keys[w] == keys)
    dup = torch.zeros(b, dtype=torch.bool, device=dev)
    dup[w[other]] = True
    # apply: one winner per touched slot
    win = valid & (w == j)
    ws, wj = s[win], j[win]
    h = last_hit[ws]
    res_key, res_clock = state.keys[ws], state.clock[ws]
    any_hit = h >= 0
    insert = ~any_hit & ((res_key < 0) | (res_clock == 0))
    new_clock = torch.where(any_hit | (insert & dup[wj]), 3,
                            torch.where(insert, 0, res_clock.to(torch.int32)
                                        - 1)).to(torch.int8)
    new_key = torch.where(insert, keys[wj], res_key)
    new_loc = torch.where(any_hit, locs[h.clamp(min=0)].to(torch.int8),
                          torch.where(insert, locs[wj].to(torch.int8),
                                      state.loc[ws]))
    tk, tc, tl = (x.clone() for x in state)
    tk[ws], tc[ws], tl[ws] = new_key, new_clock, new_loc
    return tracker.TrackerState(tk, tc, tl)
