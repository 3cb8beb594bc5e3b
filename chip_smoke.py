#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port of PrismDB on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printed as one JSON line:
  1. device   -- nvidia-smi name/power limit, build of every CUDA kernel
                 (one nvcc per source, all started together)
  2. kernels  -- each kernel against its plain PyTorch version on the card
                 at the main path's shapes (clock_update bit-exact,
                 msc_score rtol 1e-5 with equal argmax), with CUDA-event
                 times and the card's bound for the same work
  3. parity   -- the engine at paper_tier_config(scale=1) on one op
                 stream: backend "cuda" on the card vs "reference" on the
                 card and on the CPU; state, counters and per-op results
                 bit-equal
  4. main     -- PrismDB(paper_tier_config(SCALE), backend="cuda") through
                 put/get/delete/scan_ops: preload 50% of the key space,
                 YCSB-A, YCSB-C and a scan segment; then main_full, the
                 same at the paper's full size (100.7 M keys) with a fixed
                 preload of FULL_PRELOAD_KEYS; throughput, modeled
                 p50/p99/p999, host reads per step, peak memory, kernel
                 launches, device busy share; read-back of a sample of
                 preloaded keys (value == key) and of deleted keys
Then the kernels line, the nvidia-smi line, and the final ok line.  The
sizes are the module constants below; PERF.md ("Scale used") says why.

Exits non-zero, printing no result, when no CUDA device is available,
when the port's sources are missing, or when any phase fails.  Long
reports go to chiprun_out/.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
FULL_SCALE = 1536              # paper §7: 100.7 M keys
BATCH = 4096                   # client batch (ops per engine step)
# The 50%-preload recipe runs at 1536 / 128: the largest halving of the
# full scale whose run directory does not overflow (ROADMAP Queue 3) and
# whose preload fits the time limit.
SCALE = FULL_SCALE // 128
SEGMENT = 64                   # client batches per YCSB segment at SCALE
# The full-size state is preloaded with a fixed key count: past the fast
# tier's 0.98 high watermark (10,961,113 keys), so compactions run, and
# well inside the time limit (a 50% preload does not fit it).
FULL_PRELOAD_KEYS = 2688 * BATCH          # 11,010,048 keys
FULL_SEGMENT = 16
FULL_PROFILE_STEPS = 2         # profiler bookkeeping grows per traced op


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# ------------------------------------------------------------ phase 2

def check_clock_update(cfg, batch: int, rng) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import tracker
    from repro_torch.kernels.clock_update import ops
    dev = torch.device("cuda")
    t = cfg.tracker_slots
    # keys that collide on a slot: draw many, keep groups sharing a slot
    pool = torch.from_numpy(rng.integers(0, cfg.key_space, 1 << 20)
                            .astype(np.int32)).to(dev)
    gen = lambda seed: torch.Generator(dev).manual_seed(seed)
    slots = tracker.slot_of(t, pool)
    order = torch.argsort(slots)
    s_sorted = slots[order]
    dup = torch.zeros_like(s_sorted, dtype=torch.bool)
    dup[1:] = s_sorted[1:] == s_sorted[:-1]
    dup[:-1] |= s_sorted[:-1] == s_sorted[1:]
    colliding = pool[order[dup]]
    state = tracker.init(t, dev)
    worst = 0
    for it in range(8):
        hot = torch.from_numpy(rng.integers(0, 4 * batch, batch // 4)
                               .astype(np.int32)).to(dev)
        coll = colliding[torch.randint(0, colliding.numel(), (batch // 4,),
                                       device=dev, generator=gen(it))]
        rnd = torch.from_numpy(rng.integers(0, cfg.key_space, batch // 2)
                               .astype(np.int32)).to(dev)
        keys = torch.cat([hot, coll, rnd])[torch.randperm(
            batch, device=dev, generator=gen(it))]
        locs = torch.from_numpy(rng.integers(0, 2, batch)
                                .astype(np.int8)).to(dev)
        valid = torch.from_numpy(rng.random(batch) > 0.05).to(dev)
        want = tracker.access_batched(state, keys, locs, valid)
        got = ops.clock_update(
            tracker.TrackerState(*[x.clone() for x in state]), keys, locs,
            valid)
        torch.cuda.synchronize()
        for a, b in zip(want, got):
            worst = max(worst, int((a.to(torch.int64) - b.to(torch.int64))
                                   .abs().max()))
        state = want
    if worst != 0:
        raise AssertionError(f"clock_update differs from access_batched "
                             f"(max abs err {worst})")
    touched = int(torch.unique(tracker.slot_of(t, keys[valid])).numel())
    scratch = tracker.TrackerState(*[x.clone() for x in state])
    ms = cuda_ms(lambda: ops.clock_update(scratch, keys, locs, valid), 50)
    # the two launches alone, the occurrence count computed once outside
    occ = ops.occurrences(keys, valid)
    last = [torch.full((t,), -1, dtype=torch.int32, device=dev)
            for _ in range(2)]
    lib = ops._lib()
    stream = torch.cuda.current_stream().cuda_stream
    launch_ms = cuda_ms(lambda: lib.clock_update_launch(
        keys.data_ptr(), occ.data_ptr(), locs.data_ptr(), valid.data_ptr(),
        batch, scratch.keys.data_ptr(), scratch.clock.data_ptr(),
        scratch.loc.data_ptr(), t, last[0].data_ptr(), last[1].data_ptr(),
        stream), 200)
    plain_ms = cuda_ms(lambda: tracker.access_batched(state, keys, locs,
                                                      valid), 20)
    nbytes = batch * (4 + 4 + 1 + 1) + touched * (6 + 6)
    return {"name": "clock_update", "route": "cuda",
            "source": "src/repro_torch/csrc/clock_update.cu",
            "replaces": "src/repro/kernels/clock_update/clock_update.py:85",
            "max_abs_err": float(worst), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
            "library_ms": None, "shape": {"T": t, "B": batch},
            "touched_slots": touched, "launch_only_ms": launch_ms}


def check_msc_score(cfg, rng) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels.msc_score import ops
    from repro_torch.kernels.msc_score.ref import msc_scores_ref
    dev = torch.device("cuda")
    k, nb = cfg.power_k, cfg.n_buckets
    bw = max(cfg.key_space // nb, 1)
    worst_rel = worst_abs = 0.0
    for it in range(64):
        lo = rng.integers(0, cfg.key_space, k)
        hi = np.minimum(lo + rng.integers(1, cfg.key_space // 8, k),
                        cfg.key_space)
        args = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
            lo, hi, rng.integers(0, 4096, k),
            rng.integers(0, cfg.fast_slots // nb + 1, nb),
            rng.integers(0, cfg.slow_slots // nb + 1, nb),
            rng.integers(0, cfg.fast_slots // (4 * nb) + 1, nb),
            rng.integers(0, cfg.tracker_slots // (8 * nb) + 1, (nb, 4)))]
        probs = torch.from_numpy(np.sort(rng.random(4)).astype(
            np.float32)).to(dev)
        want = msc_scores_ref(*args, probs, bucket_width=bw)
        got = ops.msc_scores(*args, probs, bucket_width=bw)
        torch.cuda.synchronize()
        diff = (want - got).abs()
        worst_abs = max(worst_abs, float(diff.max()))
        worst_rel = max(worst_rel, float((diff / want.abs().clamp(
            min=1e-30)).max()))
        if int(torch.argmax(want)) != int(torch.argmax(got)):
            raise AssertionError("msc_score argmax differs from the plain "
                                 "version")
    if worst_rel > 1e-5:
        raise AssertionError(f"msc_score rel err {worst_rel} > 1e-5")
    ms = cuda_ms(lambda: ops.msc_scores(*args, probs, bucket_width=bw), 200)
    plain_ms = cuda_ms(lambda: msc_scores_ref(*args, probs,
                                              bucket_width=bw), 100)
    nbytes = k * 4 * 4 + nb * 3 * 4 + nb * 16 + 16
    ops_n = k * nb * 24
    bound_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    bound_ops = 1e3 * ops_n / F32_OPS_PER_S
    return {"name": "msc_score", "route": "cuda",
            "source": "src/repro_torch/csrc/msc_score.cu",
            "replaces": "src/repro/kernels/msc_score/msc_score.py:52",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None, "shape": {"K": k, "B": nb}}


# ------------------------------------------------------------ streams

class Zipf:
    """Bounded zipfian ranks (Gray et al., as YCSB) scrambled onto the key
    space by an affine bijection, so hot keys spread over the runs."""

    def __init__(self, n: int, theta: float = 0.99):
        import numpy as np
        self.n, self.theta = n, theta
        z = 0.0
        for a in range(1, n + 1, 1 << 24):
            r = np.arange(a, min(n, a + (1 << 24) - 1) + 1, dtype=np.float64)
            z += float(np.sum(r ** -theta))
        self.zetan = z
        zeta2 = 1.0 + 0.5 ** theta
        self.alpha = 1.0 / (1.0 - theta)
        self.eta = (1 - (2.0 / n) ** (1 - theta)) / (1 - zeta2 / z)

    def keys(self, rng, size: int):
        import numpy as np
        u = rng.random(size)
        uz = u * self.zetan
        rank = np.floor(self.n * (self.eta * u - self.eta + 1) ** self.alpha)
        rank = np.where(uz < 1.0, 0, np.where(uz < 1.0 + 0.5 ** self.theta,
                                              1, rank))
        rank = np.clip(rank, 0, self.n - 1).astype(np.int64)
        return ((rank * 2654435761 + 12345) % self.n).astype(np.int32)


def make_stream(rng, zipf, batch: int, n: int, mix: str, device):
    """``n`` client batches of ``mix`` ("A": 50/50 get/put batches, "C":
    gets, "E": scans of length 1..100), uploaded to ``device`` up front
    (generation and upload are set-up, not engine time)."""
    import numpy as np
    import torch
    kinds = [mix if mix != "A" else ("get" if rng.random() < 0.5 else "put")
             for _ in range(n)]
    keys = torch.from_numpy(zipf.keys(rng, n * batch).reshape(n, batch))
    lens = torch.from_numpy(rng.integers(1, 101, (n, batch)).astype(np.int32))
    return kinds, keys.to(device), lens.to(device)


def drive(db, stream, walls=None) -> None:
    """Run a stream through the facade; with ``walls``, synchronise after
    each step and record its wall time."""
    import torch
    kinds, keys, lens = stream
    for i, kind in enumerate(kinds):
        t0 = time.perf_counter()
        if kind == "put":
            db.put(keys[i])
        elif kind in ("get", "C"):
            db.get(keys[i])
        else:
            db.scan_ops(keys[i], lens[i])
        if walls is not None:
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)


# ------------------------------------------------------------ phase 3

def engine_parity(batch: int) -> dict:
    import numpy as np
    from repro_torch.configs.prismdb_kv import paper_tier_config
    from repro_torch.core.db import PrismDB
    cfg = paper_tier_config(scale=1)
    runs = {}
    for backend, device in (("cuda", "cuda"), ("reference", "cuda"),
                            ("reference", "cpu")):
        db = PrismDB(cfg, seed=0, backend=backend, device=device)
        rng = np.random.default_rng(11)
        zipf = Zipf(cfg.key_space)
        pre = rng.permutation(cfg.key_space // 2).astype(np.int32)
        for i in range(0, pre.size, batch):
            db.put(pre[i:i + batch])
        results = []
        for mix, n in (("A", 12), ("C", 4), ("E", 4), ("A", 8)):
            for _ in range(n):
                keys = zipf.keys(rng, batch)
                kind = mix if mix != "A" else ("get" if rng.random() < 0.5
                                               else "put")
                if kind == "put":
                    db.put(keys)
                elif kind in ("get", "C"):
                    results.append([x.cpu().numpy() for x in db.get(keys)])
                else:
                    lens = rng.integers(1, 101, batch).astype(np.int32)
                    results.append([db.scan_ops(keys, lens).cpu().numpy()])
        db.delete(pre[:batch])
        results.append([x.cpu().numpy() for x in db.get(pre[:batch])])
        runs[backend, device] = (db, results)
    dk, rk = runs["cuda", "cuda"]
    comp = dk.counters["compactions"]
    if comp == 0:
        raise AssertionError("parity run made no compaction")
    out = {"phase": "parity", "scale": 1, "compactions": comp}
    for (backend, device), (dr, rr) in runs.items():
        if (backend, device) != ("cuda", "cuda"):
            out[f"{backend}_{device}"] = _same_run(dk, rk, dr, rr)
    out["ok"] = True
    return out


def _same_run(dk, rk, dr, rr) -> dict:
    """Raise unless two runs of one stream agree: counters, every state
    leaf bit for bit (``obs.ev_score`` to rtol 1e-5: the msc_score kernel
    sums in another order) and every per-op result."""
    import numpy as np
    from repro_torch.core import engine
    if dk.counters != dr.counters:
        raise AssertionError("counters differ between the runs")

    def leaves(x, path=""):
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            for f in x._fields:
                yield from leaves(getattr(x, f), f"{path}.{f}")
        elif isinstance(x, tuple):
            for i, v in enumerate(x):
                yield from leaves(v, f"{path}[{i}]")
        else:
            yield path, x

    sk = dict(leaves(engine.state_to_numpy(dk.estate)))
    sr = dict(leaves(engine.state_to_numpy(dr.estate)))
    score_err = 0.0
    for name, a in sk.items():
        b = sr[name]
        if name == ".obs.ev_score":
            score_err = float(np.max(np.abs(a - b) / np.maximum(
                np.abs(b), 1e-30)))
            if score_err > 1e-5:
                raise AssertionError(f"ev_score rel err {score_err}")
        elif not np.array_equal(np.atleast_1d(a).view(np.uint8),
                                np.atleast_1d(b).view(np.uint8)):
            raise AssertionError(f"state leaf {name} differs")
    for x, y in zip(rk, rr):
        for a, b in zip(x, y):
            if not np.array_equal(a, b):
                raise AssertionError("per-op results differ")
    return {"leaves_equal": len(sk), "ev_score_max_rel_err": score_err}


# ------------------------------------------------------------ phase 4

def _orphan_keys(db):
    """Keys in slow-tier rows whose run id has no directory entry (the
    run directory was full when they were written): unreachable by gets."""
    st = db.estate.tier
    return st.keys[1][(st.runs[0] >= db.cfg.max_runs) & (st.keys[1] >= 0)]


def _check_readback(db, keys, batch: int, what: str) -> None:
    """Raise unless every key of ``keys`` is found with value == key.  A
    failure says how many of the lost keys sit in orphaned slow rows (the
    reference's run-directory overflow, ROADMAP Queue 3) and how many do
    not (a fault of the port)."""
    import torch
    lost = []
    for i in range(0, keys.numel(), batch):
        k = keys[i:i + batch]
        vals, found, _ = db.get(k)
        ok = found & (vals == k[:, None].to(torch.float32)).all(dim=1)
        lost.append(k[~ok])
    lost = torch.cat(lost)
    if lost.numel():
        orphaned = int(torch.isin(lost, _orphan_keys(db)).sum())
        raise AssertionError(
            f"read-back {what}: {lost.numel()} of {keys.numel()} keys not "
            f"found with value == key; {orphaned} of them in slow rows no "
            f"run-directory entry covers (reference fault), "
            f"{lost.numel() - orphaned} elsewhere (port fault)")


def main_path(scale: int, batch: int, seg: int, n_pre: int, device=None,
              profile_steps: int = 8) -> dict:
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs.prismdb_kv import paper_tier_config
    from repro_torch.core import engine
    from repro_torch.core.db import PrismDB
    from repro_torch.obs import export
    cfg = paper_tier_config(scale=scale)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(1)
    t0 = time.time()
    zipf = Zipf(cfg.key_space)
    db = PrismDB(cfg, seed=0, backend="cuda", device=device)  # None: card
    torch.cuda.synchronize()
    t_init = time.time() - t0

    kernels.reset_launches()
    engine.HOST_READS.n = 0
    pre = torch.from_numpy(rng.permutation(n_pre).astype(np.int32)).to(
        db.device)
    t0 = time.time()
    tick = max(n_pre // batch // 10, 1)
    for j, i in enumerate(range(0, n_pre, batch)):
        db.put(pre[i:i + batch])
        if j % tick == tick - 1:
            print(f"# preload {i + batch}/{n_pre} keys "
                  f"{time.time() - t0:.1f}s compactions "
                  f"{int(db.estate.tier.ctr.compactions)}", file=sys.stderr,
                  flush=True)
    torch.cuda.synchronize()
    t_pre = time.time() - t0
    out = {"phase": "main", "scale": scale, "key_space": cfg.key_space,
           "fast_slots": cfg.fast_slots, "tracker_slots": cfg.tracker_slots,
           "max_runs": cfg.max_runs, "batch": batch, "init_s": t_init,
           "preload_keys": n_pre, "preload_s": t_pre,
           "preload_steps": db.dispatches,
           "preload_compactions": db.counters["compactions"],
           "preload_ms_per_step": 1e3 * t_pre / max(db.dispatches, 1),
           "preload_host_reads_per_step": engine.HOST_READS.n
           / max(db.dispatches, 1),
           "runs_active_after_preload": int(
               db.estate.tier.dir_active[0].sum()),
           "segments": {}}

    # read-back: a sample of preloaded keys holds value == key
    n_chk = min(65536, n_pre)
    sample = pre[torch.randperm(n_pre, device=db.device,
                                generator=torch.Generator(db.device)
                                .manual_seed(5))[:n_chk]]
    _check_readback(db, sample, batch, "after the preload")
    out["readback_keys"] = n_chk

    for mix in ("A", "C", "E"):
        stream = make_stream(rng, zipf, batch, seg, mix, db.device)
        snap0, c0 = db.obs_snapshot(), db.counters
        d0, h0 = db.dispatches, engine.HOST_READS.n
        walls: list = []
        torch.cuda.synchronize()
        t0 = time.time()
        drive(db, stream, walls)
        dt = time.time() - t0
        snap, c1 = db.obs_snapshot(), db.counters
        q = export.quantiles_from_hist(
            export.hist_delta(snap, snap0),
            sums=export.hist_sum_delta(snap, snap0))
        w = np.asarray(walls) * 1e3
        out["segments"][mix] = {
            "steps": seg, "ops": seg * batch, "wall_s": dt,
            "ops_per_s": seg * batch / dt,
            "step_ms_p50": float(np.percentile(w, 50)),
            "step_ms_p90": float(np.percentile(w, 90)),
            "step_ms_max": float(w.max()),
            "compactions": c1["compactions"] - c0["compactions"],
            "modeled_us_p50": q["p50"], "modeled_us_p99": q["p99"],
            "modeled_us_p999": q["p999"],
            "host_reads_per_step": (engine.HOST_READS.n - h0)
            / max(db.dispatches - d0, 1)}

    # device busy share and device-to-host copies over a YCSB-A window
    # (the profiler's bookkeeping grows with the ops traced: a full-size
    # compaction step traces thousands, so that window is kept short)
    from torch.profiler import ProfilerActivity, profile
    stream = make_stream(rng, zipf, batch, profile_steps, "A", db.device)
    torch.cuda.synchronize()
    h0 = engine.HOST_READS.n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        drive(db, stream)
        torch.cuda.synchronize()
        window = time.time() - t0
    ka = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    busy_us = sum(dev_us(e) for e in ka if not e.key.startswith("aten::")
                  and not e.key.startswith("cuda"))
    out["profile"] = {
        "window_s": window, "steps": profile_steps,
        "device_busy_share": busy_us / 1e6 / window,
        "host_reads": engine.HOST_READS.n - h0,
        "dtoh_copies": sum(e.count for e in ka if "DtoH" in e.key),
        "top": [(e.key[:60], dev_us(e)) for e in sorted(
            ka, key=dev_us, reverse=True)[:8]]}
    OUT.mkdir(exist_ok=True)
    (OUT / f"profile_scale{scale}.txt").write_text(ka.table(
        sort_by="self_cuda_time_total", row_limit=60))

    # deletes: deleted keys are gone, the rest of the sample is intact
    gone = sample[:batch]
    db.delete(gone)
    _, found, _ = db.get(gone)
    if bool(found.any()):
        raise AssertionError("deleted keys still found")
    _check_readback(db, sample[batch:], batch, "after the segments")
    out.update({
        "delete_ok": True,
        "orphaned_slow_rows": int(_orphan_keys(db).numel()),
        "runs_active": int(db.estate.tier.dir_active[0].sum()),
        "compactions": db.counters["compactions"],
        "steps": db.dispatches,
        "host_reads_per_step": engine.HOST_READS.n / db.dispatches,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": dict(kernels.LAUNCHES)})
    for name, n in kernels.LAUNCHES.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.prismdb_kv import paper_tier_config
    from repro_torch.kernels import build
    t_start = time.time()
    smi = smi_line()
    t0 = time.time()
    report = build.build_all()
    OUT.mkdir(exist_ok=True)
    if report:
        (OUT / "ptxas.txt").write_text("\n\n".join(
            f"== {k}\n{v['ptxas']}" for k, v in report.items()))
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.time() - t0, "built": sorted(report)})

    rng = np.random.default_rng(0)
    full = paper_tier_config(FULL_SCALE)
    rows = [check_clock_update(full, BATCH, rng), check_msc_score(full, rng)]
    emit({"phase": "kernels", "rows": rows})
    emit(engine_parity(BATCH))
    small = paper_tier_config(SCALE)
    emit(main_path(SCALE, BATCH, SEGMENT, small.key_space // 2))
    res = main_path(FULL_SCALE, BATCH, FULL_SEGMENT, FULL_PRELOAD_KEYS,
                    profile_steps=FULL_PROFILE_STEPS)
    res["phase"] = "main_full"
    emit(res)
    for r in rows:                  # the kernels line reports main_full
        r["launches"] = res["launches"][r["name"]]
    emit({"phase": "done", "elapsed_s": time.time() - t_start})
    emit({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
