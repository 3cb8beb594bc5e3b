"""Spans the benchmark puts around the program's functions in a traced
run: a profiler range ``kvbench.<metric>/<function>``, named after the
metric that asked for it and the function, and with ``sync`` a
host-clock time that ends in a synchronise.

A metric module declares what it wraps:

    WRAP = (("repro_torch.core.engine", "maintenance"), ...)
    SYNC = True            # time each call on the host, synchronised

and a ``WRAP`` entry may carry a third item, ``keep(*args, **kwargs)``,
whose return value is kept for every call.

Nothing is wrapped in an untraced run.  The program calls each wrapped
function through its module's attribute, so the wrapper sees every
call; the originals are put back when the trace stops.
"""
from __future__ import annotations

import importlib
import time
from collections import defaultdict


class Spans:
    def __init__(self, sync):
        self._sync = sync
        self._saved = []
        self.host_s = defaultdict(float)
        self.calls = defaultdict(int)
        self.kept = defaultdict(list)

    def install(self, name: str, module) -> None:
        """Wrap every function that metric ``module`` names."""
        for modname, attr, *keep in getattr(module, "WRAP", ()):
            self._wrap(name, importlib.import_module(modname), attr,
                       getattr(module, "SYNC", False),
                       keep[0] if keep else None)

    def _wrap(self, name, mod, attr, sync, keep) -> None:
        from torch.profiler import record_function
        fn = getattr(mod, attr)
        host_s, calls, kept, sync_fn = (self.host_s, self.calls, self.kept,
                                        self._sync)
        label = f"kvbench.{name}/{attr}"

        def run(*a, **kw):
            t0 = time.perf_counter()
            with record_function(label):
                out = fn(*a, **kw)
                if sync:
                    sync_fn()
            if sync:
                host_s[name] += time.perf_counter() - t0
            calls[name] += 1
            if keep is not None:
                kept[name].append(keep(*a, **kw))
            return out

        self._saved.append((mod, attr, fn))
        setattr(mod, attr, run)

    def remove(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()
