"""The port's GPipe pipeline (``repro_torch.distributed.pipeline``)
against the JAX package on the CPU.

Reduced stablelm-12b with 4 layers, a batch of 4 x 16 tokens in 2
microbatches.  The port's ``pipelined_forward`` at S = 1 and S = 2 on a
stand-in mesh and at S = 2 over a gloo group of two spawned ranks is
held against JAX's ``M.forward`` within the JAX package's own tolerance
for its pipeline (atol 2e-3, rtol 1e-3, tests/test_distributed.py), and
against JAX's ``pipelined_forward`` at S = 2 within atol 1e-4.  JAX's
pipeline needs one device per stage, so it runs once, in a subprocess
with two forced host devices (``JAX_SIDE``), for stablelm and for
reduced qwen2-vl-2b (reference fault F9: JAX's pipeline feeds a vlm its
token embeddings and 1-D positions, not the batch's ``embeds`` and M-RoPE
positions; the port matches it).  That subprocess computes the whole JAX
side once a session (the parameters, ``M.forward``'s and the pipeline's
logits), so this module never imports JAX: the gloo ranks, which import
it, import only ``repro_torch``.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch, reduced
from repro_torch.distributed.pipeline import pipelined_forward
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model
from torch_parity import jax_modules, spawn_gloo, t

ROOT = Path(__file__).resolve().parents[1]
STABLELM, QWEN2VL = "stablelm-12b", "qwen2-vl-2b"
N_LAYERS = {STABLELM: 4, QWEN2VL: 2}
BATCH, SEQ, N_MICRO = 4, 16, 2
PARAM_SEED = {STABLELM: 5, QWEN2VL: 6}
FWD_TOL = dict(atol=2e-3, rtol=1e-3)     # tests/test_distributed.py:143-144
PP_TOL = 1e-4
JAX_TIMEOUT_S = 240

# The JAX side, in a process of its own with two forced host devices
# (JAX's pipelined_forward needs one a stage): each reduced config's
# parameters from PARAM_SEED, JAX's M.forward logits and its two-stage
# pipeline's, of the tokens in argv[1]; pickled to argv[2].
JAX_SIDE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, numpy as np
    from repro.configs.base import get_arch, reduced
    from repro.distributed.pipeline import pipelined_forward
    from repro.models import model as M
    jax.config.update("jax_platform_name", "cpu")
    cfgs = {cfgs!r}
    tokens = np.load(sys.argv[1])
    mesh = jax.make_mesh((2,), ("pod",))
    out = {{"tokens": tokens}}
    for name, (n_layers, seed) in cfgs.items():
        cfg = reduced(get_arch(name)).replace(n_layers=n_layers)
        p, _ = M.init_params(cfg, jax.random.PRNGKey(seed))
        fwd, _ = jax.jit(lambda p, b: M.forward(cfg, p, b, remat=False))(
            p, {{"tokens": tokens}})
        with jax.set_mesh(mesh):
            pipe = pipelined_forward(cfg, mesh, p, {{"tokens": tokens}},
                                     n_micro={n_micro})
        out[name] = {{"tree": jax.tree.map(np.asarray, p),
                     "forward": np.asarray(fwd), "pipeline": np.asarray(pipe)}}
    with open(sys.argv[2], "wb") as fh:
        pickle.dump(out, fh)
""").format(cfgs={k: (N_LAYERS[k], PARAM_SEED[k]) for k in N_LAYERS},
            n_micro=N_MICRO)


def _cfg(name):
    return reduced(get_arch(name)).replace(n_layers=N_LAYERS[name])


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    """The JAX side (``JAX_SIDE``), run once a session: the test workers
    share its file, the first to come runs it under a lock."""
    from filelock import FileLock
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent                  # shared by the session's workers
    out = root / "jax_pipeline.pkl"
    with FileLock(str(root / "jax_pipeline.lock")):
        if not out.exists():
            tokens = np.random.default_rng(41).integers(
                0, 512, (BATCH, SEQ)).astype(np.int32)
            np.save(root / "jax_pipeline_tokens.npy", tokens)
            proc = subprocess.run(
                [sys.executable, "-c", JAX_SIDE,
                 str(root / "jax_pipeline_tokens.npy"), str(out)],
                cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                               "JAX_PLATFORMS": "cpu"},
                capture_output=True, text=True, timeout=JAX_TIMEOUT_S)
            assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as fh:
        return pickle.load(fh)


def _port(jx, name):
    cfg = _cfg(name)
    return cfg, model.params_from_numpy(cfg, jx[name]["tree"], device="cpu")


@pytest.mark.parametrize("stages", [1, 2])
def test_pipeline_matches_jax(jx, stages):
    """On a stand-in mesh of 1 and 2 stages: the logits equal JAX's
    ``M.forward``'s within the JAX package's pipeline tolerance, and JAX's
    two-stage ``pipelined_forward``'s within atol 1e-4."""
    cfg, p = _port(jx, STABLELM)
    with torch.no_grad():
        got = pipelined_forward(cfg, MeshShape(("pod",), (stages,)), p,
                                {"tokens": t(jx["tokens"])},
                                n_micro=N_MICRO).numpy()
    np.testing.assert_allclose(got, jx[STABLELM]["forward"], **FWD_TOL)
    np.testing.assert_allclose(got, jx[STABLELM]["pipeline"], atol=PP_TOL,
                               rtol=0)


def test_pipeline_cuda_backend_matches_reference(jx):
    """Backend "cuda" runs B7 in every attention layer of every stage (on
    CPU tensors its plain version): the same logits as "reference" at
    the JAX kernel tests' f32 tolerance, atol 2e-5."""
    cfg, p = _port(jx, STABLELM)
    mesh = MeshShape(("pod",), (2,))
    batch = {"tokens": t(jx["tokens"])}
    with torch.no_grad():
        ref = pipelined_forward(cfg, mesh, p, batch, n_micro=N_MICRO)
        got = pipelined_forward(cfg, mesh, p, batch, n_micro=N_MICRO,
                                backend="cuda")
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=0)


def test_pipeline_vlm_reads_tokens_only_f9(jx):
    """Reference fault F9: JAX's pipeline embeds a vlm's ``tokens`` and
    gives its layers 1-D positions (t = h = w), so the batch's ``embeds``
    and M-RoPE positions are not read.  The port matches JAX's two-stage
    pipeline within atol 1e-4, and equals its own ``forward`` of the
    tokens alone, whatever the batch's other keys hold."""
    cfg, p = _port(jx, QWEN2VL)
    tok = t(jx["tokens"])
    batch = {"tokens": tok, "embeds": torch.ones(BATCH, SEQ, cfg.d_model),
             "positions": torch.zeros(BATCH, SEQ, 3, dtype=torch.int64)}
    with torch.no_grad():
        got = pipelined_forward(cfg, MeshShape(("pod",), (2,)), p, batch,
                                n_micro=N_MICRO)
        own, _ = model.forward(cfg, p, {"tokens": tok})
    np.testing.assert_allclose(got.numpy(), jx[QWEN2VL]["pipeline"],
                               atol=PP_TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), own.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["ssm", "hybrid", "layers", "micro",
                                  "no_pod"])
def test_pipeline_refuses_what_jax_asserts(case):
    """The family must be dense, moe or vlm, the stages must divide the
    layers and the microbatches the batch, and the mesh needs "pod"."""
    name = {"ssm": "rwkv6-7b", "hybrid": "jamba-v0.1-52b"}.get(
        case, STABLELM)
    cfg = reduced(get_arch(name))
    stages = 3 if case == "layers" else 2
    mesh = MeshShape(("data",), (2,)) if case == "no_pod" else \
        MeshShape(("pod",), (stages,))
    p = model.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    tok = torch.zeros(3 if case == "micro" else 4, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        pipelined_forward(cfg, mesh, p, {"tokens": tok}, n_micro=2)


def _pipeline_rank(rank: int, world: int, src: str, out: str) -> None:
    """One stage of the gloo run: the port's pipeline on a ("pod",)
    ``DeviceMesh`` of ``world`` ranks, its logits to ``out.<rank>``."""
    from torch.distributed.device_mesh import init_device_mesh
    with open(src, "rb") as fh:
        tree, tokens = pickle.load(fh)
    cfg = _cfg(STABLELM)
    p = model.params_from_numpy(cfg, tree, device="cpu")
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
    with torch.no_grad():
        lg = pipelined_forward(cfg, mesh, p, {"tokens": t(tokens)},
                               n_micro=N_MICRO)
    with open(f"{out}.{rank}", "wb") as fh:
        pickle.dump({"logits": lg.numpy(), "jax": jax_modules()}, fh)


def test_pipeline_gloo_two_stages(jx, tmp_path):
    """Two gloo ranks, a stage each (``batch_isend_irecv`` to the next
    rank, the last stage's outputs summed to every rank): each rank's
    logits equal the stand-in run's within atol 1e-5 (one thread here,
    more there), JAX's ``M.forward``'s within the pipeline tolerance
    and JAX's pipeline's within atol 1e-4."""
    src = tmp_path / "params.pkl"
    with open(src, "wb") as fh:
        pickle.dump((jx[STABLELM]["tree"], jx["tokens"]), fh)
    out = str(tmp_path / "rank")
    spawn_gloo(_pipeline_rank, 2, str(src), out)
    cfg, p = _port(jx, STABLELM)
    with torch.no_grad():
        want = pipelined_forward(cfg, MeshShape(("pod",), (2,)), p,
                                 {"tokens": t(jx["tokens"])},
                                 n_micro=N_MICRO).numpy()
    for r in range(2):
        with open(f"{out}.{r}", "rb") as fh:
            got = pickle.load(fh)
        assert got["jax"] == []
        np.testing.assert_allclose(got["logits"], want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["logits"], jx[STABLELM]["forward"],
                                   **FWD_TOL)
        np.testing.assert_allclose(got["logits"], jx[STABLELM]["pipeline"],
                                   atol=PP_TOL, rtol=0)
