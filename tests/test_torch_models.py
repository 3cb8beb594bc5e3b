"""The port's dense-family model (``models/common.py``, ``attention.py``,
``model.py``) against the JAX package on the CPU, at reduced sizes.

The JAX package's parameters are carried across with
``model.params_from_numpy``, and every input is made from a seed with
numpy and handed to both.  Tolerances (float32 throughout): atol 1e-5 on
norms, RoPE, FFN, attention outputs, logits, losses and decode caches --
the two frameworks' CPU matmuls and reductions sum in other orders
(measured: at most 1.4e-6 on these shapes); the flash_attention plain
version (backend "cuda" on CPU tensors) against the Pallas kernel in
interpret mode at atol 2e-5 (tests/test_kernels.py:28).  Generated
tokens (argmax) are held equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch
from repro.configs.base import reduced as j_reduced
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import model as JM
from repro_torch import kernels
from repro_torch.configs.base import get_arch, reduced
from repro_torch.models import attention as attn
from repro_torch.models import common, model
from torch_parity import t

ARCHS = ["phi4-mini-3.8b", "gemma3-1b"]
TOL = 1e-5


def _cfgs(name):
    return j_reduced(j_get_arch(name)), reduced(get_arch(name))


def _params(name, seed=1):
    jcfg, cfg = _cfgs(name)
    jp, _ = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, model.params_from_numpy(
        cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0, err_msg=msg)


def test_configs_match_the_jax_package():
    for name in ARCHS:
        jcfg, cfg = _cfgs(name)
        full_j, full = j_get_arch(name), get_arch(name)
        for a, b in ((jcfg, cfg), (full_j, full)):
            for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                      "vocab", "head_dim", "layer_windows", "rope_theta",
                      "norm_eps", "tie_embeddings", "ffn_kind", "act"):
                assert getattr(a, f) == getattr(b, f), (name, f)


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_norms(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    p = {"w": w} if kind == "rms" else {"w": w, "b": b}
    want = jcommon.norm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), kind, 1e-6)
    got = common.norm({k: t(v) for k, v in p.items()}, t(x), kind, 1e-6)
    _close(got, want)


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 7, 16)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    _close(common.apply_rope(t(x), t(pos), theta),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("kind,act", [("swiglu", "silu"), ("mlp", "gelu")])
def test_ffn(kind, act):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in (
        ("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)),
        ("b_up", (128,)), ("b_down", (64,)))}
    want = jcommon.ffn({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), kind, act)
    _close(common.ffn({k: t(v) for k, v in p.items()}, t(x), kind, act),
           want)


def test_init_params_shapes_and_scales():
    """The port's own init: the JAX parameter tree's shapes (per layer),
    norms one, and the JAX ``ParamFactory`` scales within sampling
    error."""
    jcfg, cfg = _cfgs("phi4-mini-3.8b")
    jp, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
    p = model.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert p["embed"].shape == jp["embed"].shape
    assert len(p["blocks"]) == cfg.n_layers
    for grp in ("mixer", "ffn", "ln1", "ln2"):
        for k, v in jp["blocks"][grp].items():
            assert tuple(p["blocks"][0][grp][k].shape) == v.shape[1:]
    assert torch.all(p["blocks"][1]["ln2"]["w"] == 1)
    assert torch.all(p["final_norm"]["w"] == 1)
    d, hd = cfg.d_model, cfg.head_dim
    for w, scale in ((p["embed"], 0.02),
                     (p["blocks"][0]["mixer"]["wq"], d ** -0.5),
                     (p["blocks"][0]["mixer"]["wo"],
                      (cfg.n_heads * hd) ** -0.5),
                     (p["blocks"][0]["ffn"]["w_down"], cfg.d_ff ** -0.5)):
        assert abs(float(w.std()) / scale - 1) < 0.1


@pytest.mark.parametrize("name", ARCHS)
def test_qkv_and_attention(name):
    """``_qkv`` and ``attention`` of every layer (its own window) on both
    backends against the JAX package's reference attention."""
    jcfg, cfg, jp, tp = _params(name)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    for i, w in enumerate(cfg.layer_windows):
        jblk = jax.tree.map(lambda a: a[i], jp["blocks"])["mixer"]
        jq, jk, jv = jattn._qkv(jblk, jcfg, jnp.asarray(x), jnp.asarray(pos))
        q, k, v = attn._qkv(tp["blocks"][i]["mixer"], cfg, t(x), t(pos))
        for a, b in ((q, jq), (k, jk), (v, jv)):
            _close(a, b, msg=f"qkv layer {i}")
        want = jattn.attention(jblk, jcfg, jnp.asarray(x), jnp.asarray(pos),
                               jnp.int32(w), backend="reference")
        for backend in ("reference", "cuda"):
            got = attn.attention(tp["blocks"][i]["mixer"], cfg, t(x), t(pos),
                                 w, backend=backend)
            _close(got, want, msg=f"attention layer {i} {backend}")


@pytest.mark.parametrize("name", ARCHS)
def test_layer_attention_vs_pallas_interpret(name):
    """Each layer's attention core (its q/k/v, its window) through the
    port's ``mha`` on backend "cuda" (B7's plain version on the CPU)
    against the JAX package's ``mha(backend="pallas")`` in interpret
    mode: atol 2e-5."""
    from repro.kernels.flash_attention.ops import mha as j_mha
    from repro_torch.kernels.flash_attention.ops import mha
    jcfg, cfg, jp, tp = _params(name)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 20, jcfg.d_model)).astype(np.float32)
    pos = np.arange(20, dtype=np.int32)[None]
    for i, w in enumerate(cfg.layer_windows):
        q, k, v = attn._qkv(tp["blocks"][i]["mixer"], cfg, t(x), t(pos))
        want = j_mha(*(jnp.asarray(a.contiguous().numpy()) for a in (q, k, v)),
                     causal=True, window=w, backend="pallas", block_q=16,
                     block_k=16)
        got = mha(q, k, v, causal=True, window=w, backend="cuda")
        _close(got, want, 2e-5, f"layer {i} window {w}")


@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_loss(name):
    """``forward`` (both backends; gemma3's windows of 8 go through B7's
    plain version on backend "cuda") and ``loss_fn`` against the JAX
    package's ``forward(backend="reference")``."""
    jcfg, cfg, jp, tp = _params(name)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    want, _ = JM.forward(jcfg, jp, jb, backend="reference")
    jloss = JM.loss_fn(jcfg, jp, jb, backend="reference")
    tb = {"tokens": t(toks), "labels": t(labels)}
    n0 = kernels.LAUNCHES["flash_attention"]
    for backend in ("reference", "cuda"):
        got, aux = model.forward(cfg, tp, tb, backend=backend)
        assert got.shape == (2, 24, cfg.vocab) and float(aux) == 0.0
        _close(got, want, msg=backend)
        assert np.array_equal(got.argmax(-1).numpy(),
                              np.asarray(jnp.argmax(want, -1)))
        _close(model.loss_fn(cfg, tp, tb, backend=backend), jloss,
               msg=backend)
    assert kernels.LAUNCHES["flash_attention"] == n0    # plain on CPU


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step(name):
    """``decode_step`` over a dense cache (each layer's window) against
    the JAX package's: logits and caches atol 1e-5, equal greedy tokens;
    and ``decode_attention_dense`` on its own."""
    jcfg, cfg, jp, tp = _params(name)
    jc, _ = JM.init_cache(jcfg, 2, 16, jnp.float32)
    tc = model.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    tok = np.array([3, 7], np.int32)
    pos = np.zeros(2, np.int32)
    for step in range(12):
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(tok),
                                jnp.asarray(pos))
        tl, tc = model.decode_step(cfg, tp, tc, t(tok), t(pos))
        _close(tl, jl, msg=f"step {step}")
        _close(tc["k"], jc["k"], msg=f"k step {step}")
        _close(tc["v"], jc["v"], msg=f"v step {step}")
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), tok)
        pos = pos + 1
    # one layer's dense decode attention against a half-filled cache
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(2, jcfg.n_kv_heads, 16, jcfg.head_dim)) \
        .astype(np.float32)
    cv = rng.normal(size=ck.shape).astype(np.float32)
    p5 = np.array([5, 9], np.int32)
    jblk = jax.tree.map(lambda a: a[0], jp["blocks"])["mixer"]
    w = cfg.layer_windows[0]
    jo, jk, jv = jattn.decode_attention_dense(
        jblk, jcfg, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(p5), jnp.int32(w))
    to, tk, tv = attn.decode_attention_dense(
        tp["blocks"][0]["mixer"], cfg, t(x), t(ck), t(cv), t(p5), w)
    for a, b in ((to, jo), (tk, jk), (tv, jv)):
        _close(a, b)


@pytest.mark.parametrize("name", ARCHS)
def test_reference_fault_pallas_forward_raises(name):
    """A fault of the JAX package (ROADMAP Queue 3): its dense forward
    scans the layers with the window as a traced scan input, and
    ``attention`` calls ``mha(..., window=int(window))`` on that tracer,
    so ``forward(backend="pallas")`` raises for every reduced dense
    config.  The port's layer loop keeps each window a Python int and
    runs the kernel path (``test_forward_and_loss``)."""
    jcfg, _, jp, _ = _params(name)
    toks = jnp.zeros((1, 8), jnp.int32)
    with pytest.raises(jax.errors.ConcretizationTypeError):
        JM.forward(jcfg, jp, {"tokens": toks}, backend="pallas")


def test_unported_families_raise():
    jcfg = get_arch("phi4-mini-3.8b")
    for cfg in (jcfg.replace(family="hybrid"), jcfg.replace(family="ssm"),
                jcfg.replace(moe=True), jcfg.replace(family="audio")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            model.init_params(reduced(cfg), torch.Generator(), device="cpu")
