"""The port's examples (``examples/*_torch.py``) on the CPU, against the
JAX examples run on the same inputs.

Each JAX example's ``main`` runs once a session in a process of its own
(``JAX_SIDE``, under a time limit; ~20 s each), its standard output
captured; for ``serve_tiered`` that process also hands over the weights
its ``main`` draws (``init_params`` of ``PRNGKey(0)``), which the port's
``main`` takes through ``model.params_from_numpy``.  Every number the
JAX example prints must come out of the port's, line for line, but for
what differs by design: the port counts engine steps where JAX counts
jitted calls, so the lines that report dispatch counts are left out,
the section headers are not compared, and a line that reports a
dispatch count beside other numbers is held by the others; the wall
time ``serve_tiered`` prints is left out as well.  This module never
imports JAX.
"""
import importlib.util
import os
import pickle
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.models import model

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
JAX_TIMEOUT_S = 240

# The JAX side: examples/<argv[1]>.py's main with its output captured,
# pickled to argv[2] beside serve_tiered's weights.
JAX_SIDE = textwrap.dedent("""
    import contextlib, io, pickle, runpy, sys
    import jax, numpy as np
    jax.config.update("jax_platform_name", "cpu")
    name, out = sys.argv[1], sys.argv[2]
    mod = runpy.run_path(f"examples/{name}.py")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod["main"]()
    res = {"stdout": buf.getvalue()}
    if name == "serve_tiered":
        from repro.configs.base import get_arch, reduced
        from repro.models import model as M
        p, _ = M.init_params(reduced(get_arch("phi4-mini-3.8b")),
                             jax.random.PRNGKey(0))
        res["tree"] = jax.tree.map(np.asarray, p)
    with open(out, "wb") as fh:
        pickle.dump(res, fh)
""")
# the lines left out of the comparison: dispatch counts and headers
SKIP = re.compile(r"dispatches so far|^run_ops:|^\d\) ")
# within a line: a dispatch count ("1 dispatch", "16 engine steps") and
# the wall time ("8.2s)")
STEPS = re.compile(r"\w+ (dispatch|engine step)s?|[\d.]+s\)")


def _jax_side(name: str, tmp_path_factory) -> dict:
    """JAX's ``examples/<name>.py`` run once a session: the test workers
    share its file, the first to come runs it under a lock."""
    from filelock import FileLock
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent                  # shared by the session's workers
    out = root / f"jax_example_{name}.pkl"
    with FileLock(str(root / f"jax_example_{name}.lock")):
        if not out.exists():
            proc = subprocess.run(
                [sys.executable, "-c", JAX_SIDE, name, str(out)],
                cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                               "JAX_PLATFORMS": "cpu"},
                capture_output=True, text=True, timeout=JAX_TIMEOUT_S)
            assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as fh:
        return pickle.load(fh)


def _main(name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _numbers(text: str) -> list:
    """The numbers of each compared line, its dispatch count and wall
    time taken out."""
    return [re.findall(r"\d[\d,.]*", STEPS.sub("", line))
            for line in text.splitlines() if not SKIP.search(line)]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["quickstart", "workloads_demo"],
                         ids=["quickstart_torch", "workloads_demo_torch"])
def test_example_prints_the_jax_examples_numbers(name, capsys,
                                                 tmp_path_factory):
    """Every number the JAX example prints, line by line, but its
    dispatch counts."""
    want = _jax_side(name, tmp_path_factory)["stdout"]
    _main(f"{name}_torch")(["--device", "cpu"])
    got = _numbers(capsys.readouterr().out)
    assert got == _numbers(want)
    assert sum(map(len, got)) >= 8


def test_serve_tiered_example_passes_its_asserts(capsys, tmp_path_factory):
    """On the JAX example's weights: the port's example passes its asserts
    (every request retires) and prints JAX's engine ticks, compactions,
    demoted and promoted pages, page reads and their split, and slow-link
    traffic; the small fast pool forces demotions."""
    jx = _jax_side("serve_tiered", tmp_path_factory)
    mcfg = reduced(get_arch("phi4-mini-3.8b"))
    eng = _main("serve_tiered_torch")(
        ["--device", "cpu"],
        params=model.params_from_numpy(mcfg, jx["tree"], device="cpu"))
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    got = _numbers(out)
    assert got == _numbers(jx["stdout"])
    assert sum(map(len, got)) >= 9
    assert eng.stats["retired"] == 10
    assert eng.counters["demoted"] > 0
