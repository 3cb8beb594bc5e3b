"""The benchmark's parts on the CPU: the plain reference against a
dictionary, the values of a write, the zipfian constants against
YCSB's, the tracker-slot hash against the store's, the trace reduction
on a made-up trace, and the module check of ``run.py``."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from kvbench import kernel_bytes, reference, run, trace, values  # noqa: E402
from kvbench.keys import zipfian  # noqa: E402


def test_reference_matches_a_dictionary():
    rng = np.random.default_rng(7)
    ref = reference.Reference(500, 4, salt=12345)
    want, wid = {}, 0
    for step in range(60):
        keys = rng.integers(0, 500, 64).astype(np.int32)
        if step % 2 == 0:
            ids = np.arange(wid, wid + 64)
            wid += 64
            ref.put(keys, ids)
            vals = values.numpy_values(12345, ids, 4)
            for k, v in zip(keys, vals):       # the last write wins
                want[int(k)] = v
            continue
        got_vals, got_found = ref.expect(keys)
        for k, v, f in zip(keys, got_vals, got_found):
            assert f == (int(k) in want)
            if f:
                assert (v == want[int(k)]).all()
        found = np.array([int(k) in want for k in keys])
        vals = np.stack([want.get(int(k), np.zeros(4, np.float32))
                         for k in keys])
        assert ref.wrong(keys, vals, found) == 0
        vals[3, 1] += 1.0
        found[5] = not found[5]
        brute = sum(
            f != (int(k) in want) or (f and not (v == want[int(k)]).all())
            for k, v, f in zip(keys, vals, found))
        assert ref.wrong(keys, vals, found) == brute >= 1


def test_values_are_each_writes_own_and_exact_only_in_float32():
    ids = np.arange(0, 1 << 20, 97, dtype=np.int64)
    host = values.numpy_values(777, ids, 256)
    dev = values.torch_values(777, torch.from_numpy(ids), 256).numpy()
    assert np.array_equal(host, dev)
    assert host.min() >= 1 << 23 and host.max() < 1 << 24
    # two writes differ in every lane
    assert (host[1:] != host[:-1]).all()
    # bfloat16 and float16 cannot hold them
    t = torch.from_numpy(host)
    for low in (torch.bfloat16, torch.float16):
        assert (t.to(low).to(torch.float32) != t).any(dim=1).all()


def test_zipfian_constants_are_ycsbs():
    # YCSB's ZipfianGenerator: zeta(n) = sum 1 / i^theta, alpha =
    # 1 / (1 - theta), eta = (1 - (2/n)^(1-theta)) / (1 - zeta(2)/zeta(n))
    for n in (1000, 70_000):
        theta = 0.99
        zetan = sum(1.0 / i ** theta for i in range(1, n + 1))
        zeta2 = 1.0 + 0.5 ** theta
        z = zipfian.Zipf(n, theta)
        assert z.zetan == pytest.approx(zetan, rel=1e-12)
        assert z.alpha == pytest.approx(1.0 / (1.0 - theta))
        assert z.eta == pytest.approx(
            (1 - (2.0 / n) ** (1 - theta)) / (1 - zeta2 / zetan))
    # rank 0 is drawn with probability 1 / zeta(n)
    z = zipfian.Zipf(1000)
    u = torch.rand(400_000, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(3))
    share0 = float((z.ranks(u) == 0).double().mean())
    assert share0 == pytest.approx(1.0 / z.zetan, rel=0.02)


@pytest.mark.parametrize("n", [2_097_152, 65_536, 16_384, 7_168])
def test_zipfian_scramble_is_a_bijection(n):
    import math
    assert math.gcd(zipfian.SCRAMBLE_MUL, n) == 1


def test_tracker_slot_is_the_stores():
    from repro_torch.core import tracker
    keys = torch.randint(0, 2**31 - 1, (5000,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    for cap in (6553, 10_066_329):
        assert torch.equal(kernel_bytes.tracker_slot(keys, cap),
                           tracker.slot_of(cap, keys))


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla", "flax", "repro",
             "repro.core.db", "benchmarks.run", "repro_torch",
             "repro_torch.core", "jaxtyping", "reproducible", "torch"]
    assert run.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla", "flax", "repro",
         "repro.core.db", "benchmarks.run"])


class _Ev:
    def __init__(self, name, dev, s, e, corr=0, link=0, tid=1):
        self._v = (name, dev, s, e, corr, link, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[1] != "cpu" and self._v[0].startswith("kvbench.")


class _Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type(
            "R", (), {"events": lambda self: events})()})()


def test_trace_reduction_on_a_made_up_trace():
    from torch.autograd import DeviceType
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    ev = [_Ev("kvbench.window", cpu, 0, 1000, corr=1),
          _Ev("kvbench.roofline.x/f", cpu, 100, 300, corr=2),
          _Ev("aten::add", cpu, 400, 450, corr=3),
          _Ev("cudaLaunchKernel", cpu, 110, 120, corr=90, link=2),
          _Ev("kvbench.roofline.x/f", cuda, 200, 300, corr=2),
          _Ev("kern_a", cuda, 200, 260, corr=90, link=2),
          _Ev("kern_b", cuda, 250, 300, corr=91, link=2),
          # launched by a CUDA API call inside the range, under no op
          _Ev("cudaLaunchKernel", cpu, 290, 295, corr=92),
          _Ev("kern_c", cuda, 300, 310, corr=92),
          _Ev("add_kernel", cuda, 500, 600, link=3),
          _Ev("Command Buffer Full", cuda, 600, 900, link=3),
          _Ev("late", cuda, 950, 1100, link=3)]
    tr = trace.Trace(_Prof(ev))
    assert tr.window_s == pytest.approx(1e-6)
    # busy: [200, 310] + [500, 600] + [950, 1000] inside the window
    assert tr.busy_s == pytest.approx(260e-9)
    assert tr.device_s("kvbench.roofline.x") == pytest.approx(120e-9)
    assert tr.device_s("kvbench.none") == 0.0
    gaps = dict(tr.idle_gaps)
    assert gaps["aten::add"] == pytest.approx(190e-9)       # [310, 500]
    assert gaps["kvbench.roofline.x/f"] == pytest.approx(200e-9)  # [0, 200]
    assert gaps["host, outside any op"] == pytest.approx(350e-9)
    assert tr.device_ops[0][0] == "late"


def test_benchmark_json_names_files_that_exist():
    import json
    import re
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    configs = {c["name"]: c for c in bench["configs"]}
    assert all(p == "kvbench" or p.startswith("kvbench/")
               for p in bench["paths"])
    for c in configs.values():
        assert name.match(c["name"]) and (ROOT / c["file"]).exists()
        # a key cut is at the file's top level or in one of its groups
        cfg = json.loads((ROOT / c["file"]).read_text())
        groups = [cfg] + [v for v in cfg.values() if isinstance(v, dict)]
        assert all(any(k in g for g in groups) for k in c["reduced"])
    cells = {w["name"]: w for w in bench["workloads"]}
    assert {w["config"] for w in cells.values()} == set(configs)
    for w in cells.values():
        assert name.match(w["name"]) and w["chips"] == 1
        assert (ROOT / "kvbench/traffic" / f"{w['traffic']}.json").exists()
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert (ROOT / "kvbench/metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= set(cells)
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for cell in cells:
        mine = {m["name"] for m in bench["end_to_end"]
                if cell in m.get("workloads", cells)}
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in bench["per_layer"])
