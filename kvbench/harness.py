"""One run of one cell: set-up, the measured window, the checks that
decide ``correct``, and the metrics.

    set-up    the kernels built (into the checkout's ``build/``), the
              store made from the configuration file, the load, the op
              stream made on the device, the warm-up with the cell's own
              traffic (``setup_s``: process start to the first timed
              step)
    window    ``seconds`` of the traffic file's loop; traced, the
              profiler and the metrics' spans run over it
    checks    the kept answers of the window's gets (one get step in
              the traffic file's ``judge_every``, at an offset drawn from
              the seed) and a read-back of acknowledged keys, loaded and
              written in the window, are judged against the plain
              reference (``reference.py``), which replays the load and
              every step
    metrics   each metric of the cell (``BENCHMARK.json``: end-to-end
              ones untraced, per-layer ones traced) read by its module in
              ``kvbench/metrics/``; a reader that finds nothing to read
              returns None and the metric is left out
"""
from __future__ import annotations

import math
import sys
import time
from collections import Counter

import numpy as np
import torch

from kvbench import spec as spec_mod
from kvbench import streams as streams_mod
from kvbench import values
from kvbench.reference import Reference
from kvbench.spans import Spans
from kvbench.store import Store, shrink

BATCH_FLOOR = 64      # the smallest batch or read-back of a rehearsal
TRACE_SECONDS = 12.0  # the profiled prefix of a traced window
CONTROL_RATE = 20     # the control's stream: this many times the mix's


class Run:
    """What a metric's reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def latencies(self, cls: str | None = None) -> np.ndarray:
        """Step latencies (s) of the window's steps of one latency class
        ("read", "update"; None: every step) that ran with the profiler
        and the spans off; every op of a step shares its step's."""
        return np.asarray([t1 - t0 for k, t0, t1 in self.steps
                           if cls in (None, self.latency_class[k])
                           and t0 >= self.untraced_from])

    def p95_ms(self, cls: str):
        """The 95th percentile of ``latencies(cls)`` in ms (None: no
        such step)."""
        lat = self.latencies(cls)
        return float(np.percentile(lat, 95)) * 1e3 if lat.size else None


def _log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float | None = None, root=None, bench_dir=None,
             device=None, shrink_factor: int = 1, control: str | None = None,
             store_factory=None, trace_seconds: float = TRACE_SECONDS) -> dict:
    """Run cell ``name`` once and return its result line (a dict).
    ``device`` None is the card; ``shrink_factor`` cuts the
    configuration's counts for a rehearsal; ``control`` "bf16" puts the
    lower-precision reference in the store's place; ``store_factory``
    (config, seed, device) -> store replaces the store (tests);
    ``trace_seconds`` is the traced prefix of a traced window."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec_mod.Cell(name, root=root, bench_dir=bench_dir)
    bdir = cell.dir
    config = shrink(cell.config, shrink_factor)
    traffic = dict(cell.traffic)
    batch = int(traffic["batch"])
    if shrink_factor > 1:
        batch = max(batch // shrink_factor, BATCH_FLOOR)
        traffic["readback"] = {k: min(v, max(v // shrink_factor,
                                             BATCH_FLOOR))
                               for k, v in traffic["readback"].items()}
    dev = torch.device("cuda" if device is None else device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    s_db, s_load, s_stream, s_check, s_vals = streams_mod.seeds(seed, 5)
    salt = values.salt(s_vals)

    if on_card and control is None:
        from repro_torch.kernels import build
        build.build_all(tuple(config["kernels"]))
        _log(f"kernels ready at {time.perf_counter() - t_start:.2f} s")
    if store_factory is not None:
        store = store_factory(config, s_db % 2**31, dev)
    elif control is not None:
        from kvbench.control import ControlStore
        if control != "bf16":
            raise ValueError(f"unknown control {control!r}")
        store = ControlStore(config, s_db % 2**31, dev)
        traffic["warmup"] = {"until": "steps",
                             "steps": min(64, int(traffic["warmup"].get(
                                 "max_steps", 64)))}
    else:
        store = Store(config, s_db % 2**31, dev)

    sync()
    _log(f"store ready at {time.perf_counter() - t_start:.2f} s")
    load = streams_mod.Load(config["load"], s_load, salt, store.value_width,
                            dev)
    t0 = time.perf_counter()
    for k, v in load.batches():
        store.put(k, v)
    sync()
    _log(f"load: {load.keys.shape[0]} keys in "
         f"{time.perf_counter() - t0:.2f} s")

    wspec = traffic["warmup"]
    n_warm = int(wspec.get("max_steps", wspec.get("steps", 0)))
    rate = float(traffic["stream_ops_per_s"])
    if control is not None:
        rate *= CONTROL_RATE     # the control outruns the store
    n_win = math.ceil(rate * seconds / batch) + 2
    streams = streams_mod.Streams(
        traffic, n_warm + n_win, batch, s_stream, salt,
        load.keys.shape[0], store.value_width, dev, bdir)
    sync()
    _log(f"{len(streams.kinds)} steps of traffic made at "
         f"{time.perf_counter() - t_start:.2f} s")
    loop = spec_mod.plugin(bdir, "loops", traffic["loop"])
    warm = loop.warmup(store, streams, wspec, sync)
    _log(f"warm-up: {warm} steps, done at "
         f"{time.perf_counter() - t_start:.2f} s")

    metrics_spec = cell.metrics(trace)
    readers = {m["name"]: spec_mod.plugin(bdir, "metrics", m["name"])
               for m in metrics_spec}
    spans = Spans(sync)
    if trace:
        for n, mod in readers.items():
            spans.install(n, mod)
    h0, c0 = store.host_reads(), store.compactions()
    tracer = _Tracer(trace, on_card, spans, trace_seconds)
    setup_s = time.perf_counter() - t_start
    try:
        tracer.start()
        rec = loop.window(store, streams, warm, seconds, sync,
                          on_step=tracer.step)
    finally:
        tracer.stop()
    h1, c1 = store.host_reads(), store.compactions()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    tr = tracer.reduce()

    steps = [(streams.kinds[i], t0, t1) for i, t0, t1 in rec["steps"]]
    n_run = len(steps)
    n_traced = sum(t1 <= tracer.stopped_at for _, _, t1 in steps)
    run = Run(setup_s=setup_s, seconds=rec["seconds"], steps=steps,
              n_steps=n_run, ops=n_run * batch, traced_ops=n_traced * batch,
              host_reads=h1 - h0,
              compactions=c1 - c0,
              latency_class={k: m.LATENCY for k, m in streams.mods.items()},
              untraced_from=tracer.stopped_at, spans=spans, trace=tr)
    _log(f"window: {n_run} steps ({dict(Counter(k for k, _, _ in steps))})"
         f" in {run.seconds:.3f} s, compactions {c1 - c0}, host reads "
         f"{h1 - h0}")
    for cls in sorted(set(run.latency_class.values())):
        lat = run.latencies(cls) * 1e3
        if lat.size:
            q = np.percentile(lat, [50, 95, 99])
            _log(f"{cls} steps (ms): p50 {q[0]:.2f} p95 {q[1]:.2f} p99 "
                 f"{q[2]:.2f} max {lat.max():.2f}, over 4x p50: "
                 f"{int((lat > 4 * q[0]).sum())} of {lat.size}")

    answers = _Answers(store, streams, load, rec, warm, batch, s_check)
    key_space, width = store.key_space, store.value_width
    # the program's state is freed before the reference runs
    del store, streams, load, rec
    if on_card:
        torch.cuda.empty_cache()
    checks, judged = answers.judge(key_space, width, salt)
    metrics = {}
    for m in metrics_spec:
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) \
        and judged["gets"] + judged["readback"] > 0
    out = {"correct": bool(correct),
           "attempted": n_run * batch + judged["readback"],
           "failed": int(sum(c["value"] for c in checks.values())),
           "metrics": metrics,
           "device": _device(dev, peak, tr)}
    if tr is not None:
        out["breakdown"] = {"device_ops": tr.device_ops,
                            "idle_gaps": tr.idle_gaps}
    out["checks"] = checks
    return out


class _Tracer:
    """The profiler and the metrics' spans over the first ``seconds``
    of a traced window (to the first step boundary after them), inside a
    ``kvbench.window`` range; both stop together, so the steps after
    run as in an untraced window."""

    def __init__(self, on: bool, profile: bool, spans: Spans,
                 seconds: float):
        self.on, self.profile, self.spans = on, profile, spans
        self.seconds = seconds
        self.prof = self.rng = self.until = None
        self.stopped_at = -math.inf   # the stop, on the host

    def start(self) -> None:
        if not self.on:
            return
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function)
        if self.profile:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.rng = record_function("kvbench.window")
        self.rng.__enter__()
        self.until = time.perf_counter() + self.seconds

    def step(self, t: float) -> float:
        """Stop once the traced seconds are over; returns the seconds
        the stop took (0 otherwise)."""
        if self.rng is None or t < self.until:
            return 0.0
        self.stop()
        return time.perf_counter() - t

    def stop(self) -> None:
        if self.rng is not None:
            self.rng.__exit__(None, None, None)
            self.rng = None
            t0 = time.perf_counter()
            if self.prof is not None:
                self.prof.__exit__(None, None, None)
            self.spans.remove()
            self.stopped_at = time.perf_counter()
            _log(f"trace stopped in {self.stopped_at - t0:.1f} s")

    def reduce(self):
        if self.prof is None:
            return None
        from kvbench.trace import Trace
        t0 = time.perf_counter()
        tr = Trace(self.prof)
        self.prof = None
        _log(f"trace: {tr.window_s:.2f} s, {tr.n_host_ops} host and "
             f"{tr.n_device_ops} device ops read in "
             f"{time.perf_counter() - t0:.1f} s; {tr.unlinked} device ops "
             "launched outside any op")
        return tr


def _device(dev, peak: int, tr) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
         "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        d["busy_s"] = tr.busy_s
        d["window_s"] = tr.window_s
    return d


class _Answers:
    """What the program answered, on the host: the window's kept get
    results and the read-back's, with the stream data the reference
    replays."""

    def __init__(self, store, streams, load, rec, warm: int, batch: int,
                 seed: int):
        t0 = time.perf_counter()
        self.warm, self.batch = warm, batch
        self.kinds, self.index, self.mods = (streams.kinds, streams.index,
                                             streams.mods)
        self.ran = warm + len(rec["steps"])
        used = {k: [] for k in streams.mods}
        for i in range(self.ran):
            used[streams.kinds[i]].append(streams.index[i])
        self.host = {k: streams.mods[k].to_host(streams.data[k], used[k])
                     for k in streams.mods if used[k]}
        self.pos = {k: {j: n for n, j in enumerate(used[k])} for k in used}
        self.results = {i: _to_host(r) for i, r in rec["results"].items()}
        self.load_keys = load.keys.cpu().numpy()
        # keys acknowledged by the window's puts
        mine = []
        for i in range(warm, self.ran):
            k = streams.kinds[i]
            mine.append(streams.mods[k].written(
                self.host[k], self.pos[k][streams.index[i]]))
        rng = np.random.default_rng(seed)
        rb = streams.readback
        n_load = self.load_keys.shape[0]
        sample = [self.load_keys[rng.choice(
            n_load, min(rb.get("loaded", 0), n_load), replace=False)]]
        w = np.unique(np.concatenate(mine)) if mine else np.zeros(0)
        sample.append(rng.choice(w, min(rb.get("written", 0), w.shape[0]),
                                 replace=False))
        self.sample = np.concatenate(sample).astype(np.int32)
        self.readback = []
        for a in range(0, self.sample.shape[0], batch):
            k = torch.from_numpy(self.sample[a:a + batch]).to(
                load.keys.device)
            self.readback.append(_to_host(store.get(k)))
        _log(f"answers: {self.sample.shape[0]} keys read back in "
             f"{time.perf_counter() - t0:.1f} s")

    def judge(self, key_space: int, width: int,
              salt: int) -> tuple[dict, dict]:
        """Replay the load and every step into the reference; count the
        kept get answers and the read-back's that differ from it."""
        t0 = time.perf_counter()
        ref = Reference(key_space, width, salt)
        ref.put(self.load_keys, np.arange(self.load_keys.shape[0]))
        wrong = gets = 0
        for i in range(self.ran):
            k = self.kinds[i]
            mod = self.mods[k]
            if i < self.warm and mod.ANSWERS:
                continue               # a warm-up answer is not kept
            res = self.results.get(i)
            wrong += mod.replay(ref, self.host[k],
                                self.pos[k][self.index[i]], res)
            gets += self.batch if res is not None else 0
        rb_wrong = 0
        for n, (v, f) in enumerate(self.readback):
            keys = self.sample[n * self.batch:(n + 1) * self.batch]
            rb_wrong += ref.wrong(keys, v, f)
        _log(f"checks: {gets} window gets and {self.sample.shape[0]} "
             f"read-backs judged in {time.perf_counter() - t0:.1f} s")
        return ({"get_wrong": {"value": int(wrong), "limit": 0},
                 "readback_wrong": {"value": int(rb_wrong), "limit": 0}},
                {"gets": gets, "readback": int(self.sample.shape[0])})


def _to_host(res):
    if res is None:
        return None
    vals, found = res
    return vals.cpu().numpy(), found.cpu().numpy()
