"""The closed loop: one client that sends the next batch when the last
one has completed.  A step's latency, which each of its ops shares, is
its wall time from submission to the synchronise after it.

No step starts after the deadline; the step running at the deadline
completes, and the window closes with it.  So the window's work is every
step it started, and its length runs from the first submission to the
last completion: a compaction stall in flight at the deadline counts
whole, with its batch.
"""
from __future__ import annotations

import time


class StreamExhausted(RuntimeError):
    pass


def _step(store, streams, i: int, sync):
    if i >= len(streams.kinds):
        raise StreamExhausted(
            f"the stream ran out after {i} steps: raise the traffic "
            "file's stream_ops_per_s or max_steps")
    res = streams.submit(store, i)
    sync()
    return res


def warmup(store, streams, spec: dict, sync) -> int:
    """Run the cell's own traffic until ``spec`` is met; returns the
    steps taken.  "steps": ``spec["steps"]`` steps.  "watermark_drain":
    until a step that began with the fast tier at or above its high
    watermark has compacted (the first drain of the watermark cycle),
    so the window starts at the same point of the cycle in every run."""
    until = spec["until"]
    if until == "steps":
        for i in range(int(spec["steps"])):
            _step(store, streams, i, sync)
        return int(spec["steps"])
    if until != "watermark_drain":
        raise ValueError(f"unknown warm-up rule {until!r}")
    for i in range(int(spec["max_steps"])):
        armed = store.occupancy() >= store.high_watermark
        c0 = store.compactions()
        _step(store, streams, i, sync)
        if armed and store.compactions() > c0:
            return i + 1
    raise RuntimeError(f"no watermark drain within {spec['max_steps']} "
                       "warm-up steps")


def window(store, streams, start: int, seconds: float, sync,
           on_step=None) -> dict:
    """Steps from ``start`` until the deadline: per step its index, its
    submission and completion times, and the answers the stream keeps.  ``on_step(t)`` is
    called after each step with its completion time and returns the
    seconds it took itself (the profiler's stop), which the window
    pauses for: they count neither in its length nor against its
    deadline."""
    steps, results = [], {}
    t_open = time.perf_counter()
    deadline = t_open + seconds
    paused = 0.0
    i = start
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline:
            break
        res = _step(store, streams, i, sync)
        t1 = time.perf_counter()
        if res is not None and streams.kept(i):
            results[i] = res
        steps.append((i, t0, t1))
        if on_step is not None:
            pause = on_step(t1)
            deadline += pause
            paused += pause
        i += 1
    t_close = steps[-1][2] if steps else t_open
    return {"seconds": t_close - t_open - paused, "steps": steps,
            "results": results}
