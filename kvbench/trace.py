"""Reduce a ``torch.profiler`` trace of the window to what the metrics
read: the device's busy seconds, the device seconds of the kernels
launched inside each of the benchmark's ranges, the device operations
that took most time and the idle gaps by what the host was doing.

The raw events (``kineto_results.events()``) are read once, without
building the profiler's event tree.  The window is the benchmark's own
``kvbench.window`` range.  A device operation is one with the CUDA
device type that is not a range's image on the device's timeline (a
user annotation) nor CUPTI's "Command Buffer Full" marker.  A kernel
belongs to a range when it was launched inside that range: at the
host time of its CUDA API call (the call with its correlation id), or,
for an operation with no such call in the trace, at the start of the
host operation it is linked to.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

WINDOW = "kvbench.window"
NOT_DEVICE_WORK = ("Command Buffer Full",)
API_PREFIX = "cu"     # CUDA runtime and driver calls: cudaLaunchKernel, ...
TOP = 10


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    def __init__(self, prof):
        from torch.autograd import DeviceType
        cpu, dev = [], []
        for e in prof.profiler.kineto_results.events():
            dt = e.device_type()
            if dt == DeviceType.CPU:
                cpu.append((e.start_ns(), e.end_ns(), e.name(),
                            e.correlation_id(), e.start_thread_id(),
                            e.linked_correlation_id()))
            elif dt == DeviceType.CUDA and e.duration_ns() > 0 \
                    and e.name() not in NOT_DEVICE_WORK \
                    and not e.name().startswith("kvbench.") \
                    and not getattr(e, "is_user_annotation",
                                    lambda: False)():
                dev.append((e.start_ns(), e.end_ns(), e.name(),
                            e.linked_correlation_id(), e.correlation_id()))
        win = [c for c in cpu if c[2] == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no kvbench.window range")
        self.w0, self.w1, _, _, self.tid, _ = win[0]
        self.window_s = (self.w1 - self.w0) / 1e9
        self.n_device_ops = len(dev)
        self.n_host_ops = len(cpu)
        inside = [(max(s, self.w0), min(e, self.w1)) for s, e, *_ in dev
                  if e > self.w0 and s < self.w1]
        self.busy = _merge(inside)
        self.busy_s = sum(e - s for s, e in self.busy) / 1e9

        by_name = defaultdict(int)
        for s, e, name, *_ in dev:
            if e > self.w0 and s < self.w1:
                by_name[name] += e - s
        self.device_ops = [[n[:100], t / 1e9] for n, t in sorted(
            by_name.items(), key=lambda x: -x[1])[:TOP]]

        # ranges of the benchmark's spans, and each launch's host time
        self._ranges = defaultdict(list)
        op_start, api_start = {}, {}
        for s, e, name, corr, _, link in cpu:
            if name.startswith("kvbench.") and name != WINDOW:
                self._ranges[name].append((s, e))
            if name.startswith(API_PREFIX):
                api_start[corr] = s
            else:
                op_start[corr] = s
        for v in self._ranges.values():
            v.sort()
        self._launched = [(api_start.get(corr, op_start.get(link)), e - s)
                          for s, e, _, link, corr in dev]
        self.unlinked = sum(1 for *_, link, _ in dev if not link)
        self.idle_gaps = self._idle_gaps(
            [c for c in cpu if c[4] == self.tid and c[2] != WINDOW])

    def device_s(self, label: str) -> float:
        """Device seconds of the operations launched inside the ranges
        ``label`` or ``label/<function>`` (0.0 when none ran)."""
        rs = sorted(r for name, v in self._ranges.items()
                    if name == label or name.startswith(label + "/")
                    for r in v)
        if not rs:
            return 0.0
        starts = [s for s, _ in rs]
        total = 0
        for t, d in self._launched:
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= rs[i][1]:
                total += d
        return total / 1e9

    def _idle_gaps(self, host) -> list:
        """Idle seconds of the window, by the innermost host operation
        running at each gap's midpoint."""
        gaps, t = [], self.w0
        for s, e in self.busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.w1 > t:
            gaps.append((t, self.w1))
        host.sort()
        out, stack, j = defaultdict(int), [], 0
        for a, b in gaps:
            mid = (a + b) // 2
            while j < len(host) and host[j][0] <= mid:
                while stack and stack[-1][1] <= host[j][0]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            out[stack[-1][2][:100] if stack else "host, outside any op"] \
                += b - a
        return [[n, s / 1e9] for n, s in sorted(out.items(),
                                                 key=lambda x: -x[1])[:TOP]]
