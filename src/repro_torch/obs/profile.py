"""Optional ``torch.profiler`` trace capture (the JAX package's
``obs/profile.py``).

``maybe_trace(None)`` is a free no-op, so callers can thread a
``--profile DIR`` flag straight through.  A trace is a Chrome trace
(``<dir>/trace_<pid>_<ns>.json``) with host (CPU) activity and, where a
card is present, its kernels and copies (CUDA activity); open it in
Perfetto (ui.perfetto.dev) or ``chrome://tracing``.  A profiler that
cannot start or stop prints a warning to stderr and the block runs on.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """Trace the block into a Chrome trace under ``trace_dir`` if given;
    yields ``trace_dir`` (None when nothing is traced)."""
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(trace_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    try:
        prof.start()
    except Exception as exc:  # pragma: no cover - platform dependent
        print(f"[obs] profiler trace unavailable: {exc}", file=sys.stderr)
        yield None
        return
    name = f"trace_{os.getpid()}_{time.time_ns()}.json"
    path = os.path.join(trace_dir, name)
    try:
        yield trace_dir
    finally:
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(path)
        except Exception as exc:  # pragma: no cover
            print(f"[obs] profiler stop failed: {exc}", file=sys.stderr)
