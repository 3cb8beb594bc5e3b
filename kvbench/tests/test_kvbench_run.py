"""Whole runs of the benchmark on the CPU, at the configurations' counts
cut to the 16,384-key store and a window of a fraction of a
second: the result line a sound run prints, the control and every fault
a cell can have coming out not correct, and a cell added as new files
alone (a traffic mix and a ``BENCHMARK.json`` entry) running in a copy
of the benchmark, in a process of its own that loads no JAX."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from kvbench import harness  # noqa: E402
from kvbench.store import Store  # noqa: E402

BIG_SEED = 2**31 + 12345
KEYS = {"correct", "attempted", "failed", "metrics", "device"}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CPU_KEYS = 16_384      # the rehearsal's store


def _config(cell: str) -> dict:
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    return json.loads((ROOT / "kvbench/configs" /
                       f"{w['config']}.json").read_text())


def _cell(traffic: str, quantum: int = 0) -> str:
    """The first cell of ``traffic`` whose store compacts at ``quantum``."""
    return next(w["name"] for w in BENCH["workloads"]
                if w["traffic"] == traffic and _config(w["name"])[
                    "engine"]["compaction_quantum"] == quantum)


def _shrink(cell: str) -> int:
    return _config(cell)["tier"]["key_space"] // CPU_KEYS


def _metrics(cell: str, group: str) -> set:
    return {m["name"] for m in BENCH[group]
            if cell in m.get("workloads", [cell])}


A, Q64 = _cell("ycsb-a"), _cell("ycsb-a", 64)


def _run(cell, seed=BIG_SEED, trace=False, seconds=0.3, **kw):
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            shrink_factor=_shrink(cell), **kw)


def test_a_sound_run_prints_its_line():
    out = _run(A)
    assert KEYS <= set(out) and list(out)[-1] == "checks"
    assert "breakdown" not in out
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == _metrics(A, "end_to_end")
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["checks"] == {"get_wrong": {"value": 0, "limit": 0},
                             "readback_wrong": {"value": 0, "limit": 0}}
    assert out["device"]["platform"] == "cpu"


def test_a_traced_run_reads_the_counters_and_spans():
    # the tails come from the steps after the trace's stop: a window long
    # enough for steps of both kinds after it, on a loaded machine too
    out = _run(Q64, trace=True, seconds=1.5, trace_seconds=0.1)
    assert out["correct"] is True
    # the device's metrics need the card's trace: left out on the CPU
    assert set(out["metrics"]) == {
        m["name"] for m in BENCH["per_layer"]
        if Q64 in m.get("workloads", [Q64])
        and m["source"] != "device_trace"}


class _Faulty(Store):
    """The store with one fault planted where its answer is made."""

    fault = None
    puts = 0

    def put(self, keys, vals):
        self.puts += 1
        if self.fault == "unchanged" and self.puts % 2:
            return                             # a step that changes nothing
        if self.fault == "half":               # half of the batch left out
            keys, vals = keys[::2], vals[::2]
        super().put(keys, vals)

    def get(self, keys):
        vals, found = super().get(keys)
        if self.fault == "altered":            # one answer altered
            vals = vals.clone()
            vals[0, 1] += 1.0
            found = found.clone()
            found[0] = True
        return vals, found


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_every_fault_comes_out_not_correct(fault):
    cls = type("F", (_Faulty,), {"fault": fault})
    out = _run(A, store_factory=lambda c, s, d: cls(c, s, d))
    assert out["correct"] is False
    assert out["failed"] > 0


@pytest.mark.parametrize("cell", [A, Q64])
def test_the_bf16_control_comes_out_not_correct(cell):
    out = _run(cell, control="bf16")
    assert out["correct"] is False
    assert out["checks"]["get_wrong"]["value"] > 0 \
        or out["checks"]["readback_wrong"]["value"] > 0


def _copy(tmp_path: Path, with_program: bool) -> Path:
    """A checkout holding BENCHMARK.json and kvbench/ (and, with the
    program, a link to src/)."""
    dst = tmp_path / "checkout"
    shutil.copytree(ROOT / "kvbench", dst / "kvbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    if with_program:
        os.symlink(ROOT / "src", dst / "src")
    return dst


def _cli(cwd: Path, cell: str, *extra) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    return subprocess.run(
        [sys.executable, "kvbench/run.py", "--workload", cell, "--seed",
         str(BIG_SEED), "--seconds", "0.3", "--trace", "0", *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_a_new_mix_and_cell_need_only_new_files(tmp_path):
    dst = _copy(tmp_path, with_program=True)
    mix = json.loads((dst / "kvbench/traffic/ycsb-c.json").read_text())
    mix.update(kinds={"get": 0.75, "put": 0.25}, batch=4096)
    (dst / "kvbench/traffic/dummy.json").write_text(json.dumps(mix))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    config = _config(A)["name"]
    bench["workloads"].append({"name": f"{config}.dummy",
                               "config": config, "traffic": "dummy",
                               "chips": 1, "why": "a test"})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    res = _cli(dst, f"{config}.dummy", "--cpu-shrink", str(_shrink(A)))
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and KEYS <= set(line)
    assert res.stderr.strip().splitlines()[-1] == \
        "check readback_wrong: 0 (limit 0)"


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = _cli(ROOT, A)
    assert res.returncode != 0 and res.stdout.strip() == ""
    res = _cli(_copy(tmp_path, with_program=False), A,
               "--cpu-shrink", str(_shrink(A)))
    assert res.returncode != 0 and res.stdout.strip() == ""
