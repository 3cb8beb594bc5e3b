"""Trace replay: pack recorded host traces into stacked op streams (the
port's copy of the JAX package's ``workloads/trace.py``).

A host trace is a sequence of ``(op, keys)`` or ``(op, keys, aux)``
records (``op`` in {"put", "get", "delete", "scan"}; ``keys`` any
integer sequence; ``aux`` the per-key scan lengths).  ``pack_trace``
pads every record to one batch width and stacks them into the
``OpBatch`` stream ``engine.run_ops`` / ``PrismDB.run_ops`` replays;
``unpack_trace`` inverts it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine

OP_CODE = {"put": engine.PUT, "get": engine.GET, "delete": engine.DELETE,
           "scan": engine.SCAN}
OP_NAME = {v: k for k, v in OP_CODE.items()}


def pack_trace(trace, *, batch: int, value_width: int) -> engine.OpBatch:
    """Pack host records into one stacked ``OpBatch`` of CPU tensors
    ([T, batch] lanes, short records padded with invalid lanes).  Records
    longer than ``batch`` are rejected: split them upstream, silent
    truncation would misreport replayed load."""
    kinds, keys, valid, aux = [], [], [], []
    for rec in trace:
        op, ks = rec[0], np.asarray(rec[1], np.int32)
        ax = np.asarray(rec[2], np.int32) if len(rec) > 2 \
            else np.zeros(ks.shape[0], np.int32)
        if ks.shape[0] > batch:
            raise ValueError(
                f"trace record of {ks.shape[0]} keys exceeds batch={batch}")
        pad = batch - ks.shape[0]
        kinds.append(OP_CODE[op])
        keys.append(np.pad(ks, (0, pad)))
        aux.append(np.pad(ax, (0, pad)))
        valid.append(np.pad(np.ones(ks.shape[0], bool), (0, pad)))
    keys = torch.from_numpy(np.stack(keys).astype(np.int32))
    return engine.OpBatch(
        kind=torch.tensor(kinds, dtype=torch.int32), keys=keys,
        vals=keys[..., None].to(torch.float32).expand(
            *keys.shape, value_width).contiguous(),
        valid=torch.from_numpy(np.stack(valid)),
        aux=torch.from_numpy(np.stack(aux).astype(np.int32)))


def unpack_trace(ops: engine.OpBatch) -> list[tuple]:
    """Stacked stream -> host records, padding stripped; scan records
    carry their aux lengths."""
    kinds, keys, valid, aux = (x.cpu().numpy() for x in (
        ops.kind, ops.keys, ops.valid, ops.aux))
    out = []
    for i in range(kinds.shape[0]):
        m = valid[i]
        name = OP_NAME[int(kinds[i])]
        if name == "scan":
            out.append((name, keys[i][m], aux[i][m]))
        else:
            out.append((name, keys[i][m]))
    return out
