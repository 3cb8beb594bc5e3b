"""Fault-tolerant checkpointing: atomic, asynchronous, device-elastic
(the port's copy of the JAX package's ``train/checkpoint.py``).

  * atomic: write to <dir>/tmp.<step>, fsync, rename to
    <dir>/step_<step:08d> (a crash mid-save never corrupts the latest
    checkpoint);
  * asynchronous: the device-to-host copy happens inside ``save``, which
    returns only once every leaf has a complete host copy of its own (the
    train step updates the state in place right after); serialization,
    fsync and rename run on a background thread;
  * elastic: a checkpoint holds plain numpy arrays in the state's tree,
    and ``restore`` puts them on whatever ``device`` is asked for (the
    JAX package's ``shardings``; on one card, another device).
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import threading
from typing import Any

import torch

from repro_torch.core.backend import resolve_device
from repro_torch.core.tree import map_tree


def _to_host(x: torch.Tensor):
    # a blocking copy into a new host buffer, also from a CPU tensor,
    # which the next step would otherwise update under the snapshot
    return x.detach().to("cpu", copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Any, *, blocking: bool = False):
        """Snapshot ``state`` to host memory now; persist it in the
        background (``wait`` joins and raises what the write raised)."""
        host = map_tree(_to_host, state)
        self.wait()
        self._thread = threading.Thread(
            target=self._persist, args=(step, host), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _persist(self, step: int, host_state):
        try:
            tmp = os.path.join(self.dir, f"tmp.{step}")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, "state.pkl"), "wb") as f:
                pickle.dump(host_state, f, protocol=5)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step}, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, final)               # atomic commit
            self._gc()
        except Exception as e:                  # raised again by wait()
            self._error = e

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"))

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, *, device=None) -> Any:
        """Load a checkpoint (the latest when ``step`` is None) onto
        ``device`` (None: the card): the elastic path, since the stored
        arrays belong to no device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        dev = resolve_device(device)
        path = os.path.join(self.dir, f"step_{step:08d}", "state.pkl")
        with open(path, "rb") as f:
            host = pickle.load(f)
        return map_tree(lambda x: torch.from_numpy(x).to(dev), host)
