"""The port's dense, ssm (rwkv6), hybrid (jamba) and moe (granite,
qwen3-moe at top 8) models, and the configs of all ten architectures (``models/common.py``, ``attention.py``, ``rwkv6.py``,
``mamba.py``, ``moe.py``, ``model.py``) against the JAX package on the
CPU, at reduced sizes.

The JAX package's parameters are carried across with
``model.params_from_numpy``, and every input is made from a seed with
numpy and handed to both.  Tolerances (float32 throughout): atol 1e-5 on
norms, RoPE, FFN, attention outputs, logits, losses and decode caches --
the two frameworks' CPU matmuls and reductions sum in other orders
(measured: at most 1.4e-6 on these shapes); the flash_attention plain
version (backend "cuda" on CPU tensors) against the Pallas kernel in
interpret mode at atol 2e-5 (tests/test_kernels.py:28).  Generated
tokens (argmax) are held equal.  The rwkv6 and hybrid tests state their
own tolerances (``RWKV_TOL``, ``HYB_TOL``).
"""
import types

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


ALL_ARCHS = ["gemma3-1b", "granite-moe-3b-a800m", "jamba-v0.1-52b",
             "phi4-mini-3.8b", "qwen2-vl-2b", "qwen3-moe-235b-a22b",
             "rwkv6-7b", "stablelm-12b", "starcoder2-15b", "whisper-small"]


def test_the_ten_archs_are_registered():
    from repro.configs.base import all_archs as j_all_archs
    from repro_torch.configs.base import all_archs
    assert sorted(all_archs()) == sorted(j_all_archs()) == ALL_ARCHS


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_every_config_field_matches_the_jax_package(name):
    """Every field of the published config and of ``reduced``'s, and the
    derived head dim, layer kinds and windows, equal the JAX package's."""
    import dataclasses
    for a, b in ((j_get_arch(name), get_arch(name)), _cfgs(name)):
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)]
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), (name, f.name)
        for f in ("head_dim", "layer_types", "layer_windows"):
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


@pytest.mark.parametrize("name", ARCHS + ["jamba-v0.1-52b",
                                          "granite-moe-3b-a800m",
                                          "qwen2-vl-2b", "whisper-small"])
def test_reference_fault_pallas_forward_raises(name):
    """A fault of the JAX package (ROADMAP Queue 3): its dense forward
    scans the layers with the window as a traced scan input, and
    ``attention`` calls ``mha(..., window=int(window))`` on that tracer,
    so ``forward(backend="pallas")`` raises for every reduced dense
    config; the moe family takes the same scan, and the hybrid scan
    passes the attention layer ``jnp.int32(-1)``, traced there too; the
    vlm family takes the dense scan, and the audio family's encoder and
    decoder scans pass ``jnp.int32(-1)`` as well.  The port's layer loop
    keeps each window a Python int and runs the kernel path
    (``test_forward_and_loss``, ``test_hybrid_forward_and_loss``,
    ``test_granite_forward_and_loss``, ``test_vlm_forward_and_loss``,
    ``test_whisper_forward_and_loss``)."""
    jcfg, _, jp, _ = _params(name)
    batch = {"tokens": jnp.zeros((1, 8), jnp.int32)}
    if jcfg.family == "audio":
        batch["enc_embeds"] = jnp.zeros((1, jcfg.enc_seq, jcfg.d_model))
    with pytest.raises(jax.errors.ConcretizationTypeError):
        JM.forward(jcfg, jp, batch, backend="pallas")


def test_check_supported_accepts_banded_local():
    """Banded attention (``banded_local``, set by the dry run's opt
    variant) is ported: ``check_supported`` and the entry points that take
    a config accept it (tests/test_torch_banded.py holds it to JAX); an
    unknown family still raises."""
    cfg = reduced(get_arch("gemma3-1b")).replace(banded_local=True)
    model.check_supported(cfg)
    p = model.init_params(cfg, torch.Generator(), device="cpu")
    assert model.init_cache(cfg, 1, 8, device="cpu")["k"].shape[0] == \
        cfg.n_layers
    logits, _ = model.forward(cfg, p, {"tokens": torch.zeros(
        1, 12, dtype=torch.int64)})
    assert logits.shape == (1, 12, cfg.vocab)
    with pytest.raises(NotImplementedError, match="unknown family"):
        model.check_supported(cfg.replace(family="diffusion"))


# ------------------------------------------------------------------ rwkv6

RWKV = "rwkv6-7b"
# float32 throughout.  The rwkv6 block is a chain of ~10 matmuls per
# layer whose outputs (logits up to ~4, WKV states up to ~2) the two
# frameworks' CPU BLAS sum in other orders: measured at most 9e-6 on the
# logits and 1.4e-5 on the carried caches of these shapes.  Outputs,
# logits and losses: atol 5e-5; caches: atol 5e-5 + rtol 1e-5.  The WKV
# plain version against JAX's ``wkv`` keeps the JAX package's own
# kernel tolerance, atol 1e-4 (tests/test_kernels.py:325).
RWKV_TOL = 5e-5


@pytest.fixture(scope="module")
def rwkv():
    """Reduced rwkv6-7b parameters carried across, with seeded non-trivial
    ``u``, ``mix_base``, ``mix_k``, ``ln_b`` and ``w0`` (JAX's init makes
    the first four zero and ``w0`` constant, and a wrong broadcast of any
    of them would pass on those); the JAX side of every rwkv test run
    once here, jitted: forward and loss on "reference" and "pallas"
    (interpret mode), and a 12-token teacher-forced decode."""
    jcfg, cfg = _cfgs(RWKV)
    jp, _ = JM.init_params(jcfg, jax.random.PRNGKey(7))
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(21)
    tm = tree["blocks"]["mixer"]["time_mix"]
    cm = tree["blocks"]["mixer"]["channel_mix"]
    for grp, key, scale, shift in ((tm, "u", 0.5, 0.0),
                                   (tm, "mix_base", 1.0, 0.0),
                                   (tm, "ln_b", 0.3, 0.0),
                                   (tm, "w0", 1.0, -3.0),
                                   (cm, "mix_k", 1.0, 0.0)):
        grp[key] = (shift + scale * rng.normal(size=grp[key].shape)).astype(
            np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = model.params_from_numpy(cfg, tree, device="cpu")
    toks = rng.integers(0, cfg.vocab, (2, 37)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    fwd, loss = {}, {}
    for be in ("reference", "pallas"):
        fwd[be] = np.asarray(jax.jit(lambda p, b: JM.forward(
            jcfg, p, b, backend=be)[0])(jp, jb))
        loss[be] = float(jax.jit(lambda p, b: JM.loss_fn(
            jcfg, p, b, backend=be))(jp, jb))
    step = jax.jit(lambda p, c, tk: JM.decode_step(
        jcfg, p, c, tk, jnp.zeros(2, jnp.int32)))
    jc, _ = JM.init_cache(jcfg, 2, 16, jnp.float32)
    dec = []
    for i in range(12):
        lg, jc = step(jp, jc, jnp.asarray(toks[:, i]))
        dec.append((np.asarray(lg), jax.tree.map(np.asarray, jc)))
    return types.SimpleNamespace(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp,
                                 toks=toks, labels=labels, fwd=fwd,
                                 loss=loss, dec=dec)


def test_rwkv_config_matches_the_jax_package():
    jcfg, cfg = _cfgs(RWKV)
    for a, b in ((jcfg, cfg), (j_get_arch(RWKV), get_arch(RWKV))):
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "vocab", "head_dim", "pattern", "layer_windows",
                  "norm_kind", "norm_eps", "tie_embeddings"):
            assert getattr(a, f) == getattr(b, f), f
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
            cfg.vocab) == (2, 64, 4, 16, 512)


@pytest.mark.parametrize("groups", [4, 16])
def test_group_norm(groups):
    rng = np.random.default_rng(8)
    x = (3 + 2 * rng.normal(size=(2, 5, 64))).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    want = jcommon.group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              groups=groups, eps=64e-5)
    got = common.group_norm(t(x), t(w), t(b), groups=groups, eps=64e-5)
    assert got.dtype == torch.float32
    _close(got, want)
    xb = t(x).to(torch.bfloat16)
    assert common.group_norm(xb, t(w), t(b), groups).dtype == torch.bfloat16


def test_rwkv_init_params_shapes_and_scales():
    """The port's own rwkv init: the JAX tree's shapes per layer (no
    ``ffn``: the channel mix is the ffn, ``lm_head`` untied), its
    constants, and the ParamFactory scales within sampling error."""
    from repro_torch.models import rwkv6
    jcfg, cfg = _cfgs(RWKV)
    jp, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
    p = model.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert set(p) == set(jp) and "lm_head" in p
    assert set(p["blocks"][0]) == {"mixer", "ln1", "ln2"}
    for grp in ("time_mix", "channel_mix"):
        jg = jp["blocks"]["mixer"][grp]
        assert set(jg) == set(p["blocks"][0]["mixer"][grp])
        for k, v in jg.items():
            assert tuple(p["blocks"][1]["mixer"][grp][k].shape) == \
                v.shape[1:], (grp, k)
    tm = p["blocks"][0]["mixer"]["time_mix"]
    assert torch.all(tm["w0"] == -4) and torch.all(tm["u"] == 0)
    assert torch.all(tm["ln_w"] == 1) and torch.all(tm["mix_base"] == 0)
    d = cfg.d_model
    for w, scale in ((tm["wr"], d ** -0.5), (tm["w_lora_a"], 0.01),
                     (p["blocks"][0]["mixer"]["channel_mix"]["wv"],
                      (int(3.5 * d) // 32 * 32) ** -0.5),
                     (p["lm_head"], d ** -0.5)):
        assert abs(float(w.std()) / scale - 1) < 0.1
    assert tm["mix_lora_b"].shape == (5 * rwkv6.MIX_LORA_R, 5 * d)


def test_rwkv_time_mix_and_channel_mix(rwkv):
    """Each layer's ``time_mix`` (whole sequence on both backends, and the
    decode form with a state and a token-shift carry) and
    ``channel_mix`` (with and without a carry) against the JAX
    package's, the sequence form on its "reference" and "pallas"
    (interpret) backends."""
    from repro.models import rwkv6 as jrwkv
    from repro_torch.models import rwkv6
    jcfg, cfg = rwkv.jcfg, rwkv.cfg
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 21, jcfg.d_model)).astype(np.float32)
    x1 = x[:, :1]
    last = rng.normal(size=(2, jcfg.d_model)).astype(np.float32)
    hd = jcfg.d_model // jcfg.n_heads
    st = rng.normal(size=(2, jcfg.n_heads, hd, hd)).astype(np.float32)
    for i in range(cfg.n_layers):
        jblk = jax.tree.map(lambda a: a[i], rwkv.jp["blocks"])["mixer"]
        tblk = rwkv.tp["blocks"][i]["mixer"]
        for jbe in ("reference", "pallas"):
            (want, (_, wl)) = jax.jit(lambda p, a: jrwkv.time_mix(
                p, jcfg, a, backend=jbe))(jblk["time_mix"], jnp.asarray(x))
            for be in ("reference", "cuda"):
                got, (ns, gl) = rwkv6.time_mix(tblk["time_mix"], cfg, t(x),
                                               backend=be)
                assert ns is None
                _close(got, want, RWKV_TOL, f"time_mix {i} {be} {jbe}")
                _close(gl, wl, 0, f"last_x {i}")
        want, (jst, wl) = jrwkv.time_mix(
            jblk["time_mix"], jcfg, jnp.asarray(x1), state=jnp.asarray(st),
            last_x=jnp.asarray(last))
        got, (gst, gl) = rwkv6.time_mix(tblk["time_mix"], cfg, t(x1),
                                        state=t(st), last_x=t(last))
        _close(got, want, RWKV_TOL, f"time_mix step {i}")
        np.testing.assert_allclose(gst.numpy(), np.asarray(jst),
                                   atol=RWKV_TOL, rtol=1e-5)
        for carry in (None, last):
            jarg = None if carry is None else jnp.asarray(carry)
            want, wl = jrwkv.channel_mix(jblk["channel_mix"], jnp.asarray(x),
                                         last_x=jarg)
            got, gl = rwkv6.channel_mix(
                tblk["channel_mix"], t(x),
                last_x=None if carry is None else t(carry))
            _close(got, want, RWKV_TOL, f"channel_mix {i}")
            _close(gl, wl, 0)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_rwkv_forward_and_loss(rwkv, backend):
    """``forward`` and ``loss_fn`` (backend "cuda": B8's plain version on
    CPU tensors) against the JAX package's on "reference" and on
    "pallas" (the rwkv6_scan kernel in interpret mode), equal argmax."""
    tb = {"tokens": t(rwkv.toks), "labels": t(rwkv.labels)}
    n0 = kernels.LAUNCHES["rwkv6_scan"]
    got, aux = model.forward(rwkv.cfg, rwkv.tp, tb, backend=backend)
    loss = model.loss_fn(rwkv.cfg, rwkv.tp, tb, backend=backend)
    assert got.shape == (2, 37, rwkv.cfg.vocab) and float(aux) == 0.0
    for jbe in ("reference", "pallas"):
        _close(got, rwkv.fwd[jbe], RWKV_TOL, jbe)
        assert np.array_equal(got.argmax(-1).numpy(),
                              rwkv.fwd[jbe].argmax(-1))
        _close(loss, rwkv.loss[jbe], RWKV_TOL, jbe)
    assert kernels.LAUNCHES["rwkv6_scan"] == n0           # plain on CPU


def test_rwkv_decode_step(rwkv):
    """``init_cache`` and a 12-token teacher-forced ``decode_step``
    (float32 caches) against the JAX package's: logits and every carried
    cache leaf at each step; the logits also against the forward's at the
    same position (the recurrent step against the scan)."""
    cfg = rwkv.cfg
    tc = model.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    jc0, _ = JM.init_cache(rwkv.jcfg, 2, 16, jnp.float32)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tc.items()} == {
        k: (v.shape, torch.float32) for k, v in jc0.items()}
    assert model.init_cache(cfg, 2, 16, device="cpu")["last_tm"].dtype == \
        torch.bfloat16
    pos = torch.zeros(2, dtype=torch.int32)
    for i, (jl, jc) in enumerate(rwkv.dec):
        tl, tc2 = model.decode_step(cfg, rwkv.tp, tc, t(rwkv.toks[:, i]), pos)
        assert tc2 is tc                                   # in place
        _close(tl, jl, RWKV_TOL, f"step {i}")
        _close(tl, rwkv.fwd["reference"][:, i], RWKV_TOL, f"scan {i}")
        for k in ("wkv", "last_tm", "last_cm"):
            np.testing.assert_allclose(tc[k].numpy(), jc[k], atol=RWKV_TOL,
                                       rtol=1e-5, err_msg=f"{k} step {i}")


# ------------------------------------------------------- hybrid and moe

JAMBA, GRANITE = "jamba-v0.1-52b", "granite-moe-3b-a800m"
# float32 throughout.  The random jamba's MoE experts are drawn with std
# 1/sqrt(E) (the JAX init's fan-in quirk, kept), so its residual stream
# and logits are larger than a dense model's (logits up to ~4); the two
# frameworks' CPU matmuls sum in other orders: measured at most 9.4e-6
# on its logits.  Hybrid outputs, logits, losses: atol 5e-5; caches
# atol 5e-5 + rtol 1e-5.  The mamba_scan plain version against the
# Pallas kernel keeps the JAX package's kernel tolerance, atol 1e-4
# (tests/test_kernels.py:340).
HYB_TOL = 5e-5


def _moe_tree(name, seed, **kw):
    """JAX ``init_moe`` parameters of the reduced config (numpy leaves),
    and both packages' configs."""
    from repro.models import moe as jmoe
    jcfg, cfg = _cfgs(name)
    jcfg, cfg = jcfg.replace(**kw), cfg.replace(**kw)
    jp, _ = jmoe.init_moe(jcommon.ParamFactory(jax.random.PRNGKey(seed)),
                          jcfg)
    return jcfg, cfg, jax.tree.map(np.asarray, jp)


def _jax_top_e(jcfg, router, x):
    """The JAX package's routing of x (its own ops, recomputed)."""
    e = router.shape[-1]
    logits = (jnp.asarray(x).reshape(-1, x.shape[-1]) @ router) \
        .astype(jnp.float32)
    logits = jnp.where(jnp.arange(e) >= jcfg.n_experts, -1e30, logits)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.top_k)
    return np.asarray(top_e).reshape(*x.shape[:-1], jcfg.top_k)


# A MoE layer on its own, fed unit-normal inputs, gives outputs up to
# ~26 (the experts' 1/sqrt(E) scale): atol 1e-5 and rtol 1e-5 there
# (measured at most 3.2e-7 relative: float32 rounding of the matmuls).
MOE_TOL = 1e-5


def _moe_close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=MOE_TOL, rtol=MOE_TOL, err_msg=msg)


def _moe_both(jcfg, cfg, tree, x, dispatch="global"):
    from repro.models import moe as jmoe
    from repro_torch.models import moe
    jfn = {"global": jmoe.moe_ffn_global,
           "rowwise": jmoe.moe_ffn_rowwise}[dispatch]
    tfn = {"global": moe.moe_ffn_global,
           "rowwise": moe.moe_ffn_rowwise}[dispatch]
    want, wx = jax.jit(lambda p, a: jfn(p, jcfg, a))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    got, gx = tfn({k: t(v) for k, v in tree.items()}, cfg, t(x))
    return want, wx, got, gx


@pytest.mark.parametrize("name", [JAMBA, GRANITE])
def test_moe_configs_match_the_jax_package(name):
    jcfg, cfg = _cfgs(name)
    for a, b in ((jcfg, cfg), (j_get_arch(name), get_arch(name))):
        for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "vocab", "head_dim", "pattern", "layer_types",
                  "layer_windows", "norm_kind", "norm_eps", "tie_embeddings",
                  "moe", "n_experts", "n_experts_padded", "top_k",
                  "moe_every", "capacity_factor", "moe_dispatch",
                  "ssm_state", "ssm_conv", "ssm_expand", "ffn_kind", "act"):
            assert getattr(a, f) == getattr(b, f), (name, f)


def test_hybrid_init_params_shapes_and_scales():
    """The port's own jamba init: per layer, the JAX superblock's shapes
    (``blocks["pos{i}"]``), mamba's constants (``dt_proj_b`` -4.6,
    ``a_log`` = log(1..N) on every channel, ``d`` one), the MoE layers
    at the odd pattern positions, and the ParamFactory scales -- the
    experts' 1/sqrt(E) of the JAX init's fan-in quirk included."""
    jcfg, cfg = _cfgs(JAMBA)
    jp, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
    p = model.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert set(p) == set(jp) and len(p["blocks"]) == cfg.n_layers == 8
    for l, blk in enumerate(p["blocks"]):
        jblk = jp["blocks"][f"pos{l}"]
        assert set(blk) == set(jblk)
        for grp in blk:
            assert set(blk[grp]) == set(jblk[grp]), (l, grp)
            for k, v in jblk[grp].items():
                assert tuple(blk[grp][k].shape) == v.shape[1:], (l, grp, k)
        assert ("router" in blk["ffn"]) == (l % 2 == 1)
        assert ("wq" in blk["mixer"]) == (l == 4)
    m, f = p["blocks"][0]["mixer"], p["blocks"][1]["ffn"]
    di, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    assert torch.all(m["dt_proj_b"] == -4.6) and torch.all(m["d"] == 1)
    assert torch.equal(m["a_log"], torch.log(torch.arange(
        1, n + 1, dtype=torch.float32)).expand(di, n))
    e = cfg.n_experts_padded
    for w, scale in ((m["in_proj"], cfg.d_model ** -0.5),
                     (m["conv_w"], 0.5), (m["x_proj"], di ** -0.5),
                     (m["out_proj"], di ** -0.5), (f["router"], 0.02),
                     (f["w_gate"], e ** -0.5), (f["w_up"], e ** -0.5),
                     (f["w_down"], e ** -0.5)):
        assert abs(float(w.std()) / scale - 1) < 0.1


def test_mamba_layer_prefill_and_decode():
    """Each mamba layer of reduced jamba: the sequence form on both
    backends (backend "cuda": B9's plain version on CPU tensors) against
    the JAX package's ``mamba_layer`` on "reference" and "pallas"
    (interpret mode: the mamba_scan kernel), and the decode form with a
    state and conv carry; conv_b, d, dt_proj_b and a_log seeded away
    from their constant inits."""
    from repro.models import mamba as jmamba
    from repro_torch.models import mamba
    jcfg, cfg = _cfgs(JAMBA)
    jp, _ = JM.init_params(jcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(10)
    di, n, k = cfg.ssm_expand * cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    x = rng.normal(size=(2, 21, cfg.d_model)).astype(np.float32)
    x1 = x[:, :1]
    h0 = rng.normal(size=(2, di, n)).astype(np.float32)
    c0 = rng.normal(size=(2, k - 1, di)).astype(np.float32)
    for pos in (0, 7):
        jm = jax.tree.map(lambda a: np.asarray(a[0]),
                          jp["blocks"][f"pos{pos}"]["mixer"])
        for key, shift, scale in (("conv_b", 0.0, 0.3), ("d", 1.0, 0.5),
                                  ("dt_proj_b", -4.0, 1.0),
                                  ("a_log", 0.0, 0.5)):
            jm[key] = (jm[key] + shift + scale * rng.normal(
                size=jm[key].shape)).astype(np.float32)
        tm = {kk: t(v) for kk, v in jm.items()}
        jm = jax.tree.map(jnp.asarray, jm)
        for jbe in ("reference", "pallas"):
            want, (wh, wc) = jax.jit(lambda p, a: jmamba.mamba_layer(
                p, jcfg, a, backend=jbe))(jm, jnp.asarray(x))
            assert wh is None
            for be in ("reference", "cuda"):
                got, (gh, gc) = mamba.mamba_layer(tm, cfg, t(x), backend=be)
                assert gh is None
                _close(got, want, HYB_TOL, f"prefill {pos} {be} {jbe}")
                _close(gc, wc, 0, f"conv carry {pos}")
        want, (wh, wc) = jmamba.mamba_layer(
            jm, jcfg, jnp.asarray(x1), state=(jnp.asarray(h0),
                                              jnp.asarray(c0)))
        got, (gh, gc) = mamba.mamba_layer(tm, cfg, t(x1),
                                          state=(t(h0), t(c0)))
        _close(got, want, HYB_TOL, f"decode {pos}")
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=HYB_TOL,
                                   rtol=1e-5)
        _close(gc, wc, 0, f"decode conv {pos}")


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("dispatch", ["global", "rowwise"])
def test_moe_ffn_matches_jax(dispatch, cf):
    """``moe_ffn_global`` and ``moe_ffn_rowwise`` (reduced granite: 8
    experts, top 2) against the JAX package's: outputs within
    ``MOE_TOL``, ``aux_loss`` atol 1e-6, ``dropped`` equal, each token's
    experts equal to the JAX routing's.  At capacity_factor 0.5 tokens
    must drop (at 1.25 a few do too)."""
    jcfg, cfg, tree = _moe_tree(GRANITE, 3, capacity_factor=cf)
    x = np.random.default_rng(11).normal(size=(2, 16, cfg.d_model)) \
        .astype(np.float32)
    want, wx, got, gx = _moe_both(jcfg, cfg, tree, x, dispatch)
    _moe_close(got, want, dispatch)
    _close(gx["aux_loss"], wx["aux_loss"], 1e-6)
    assert float(gx["dropped"]) == float(wx["dropped"])
    assert float(gx["dropped"]) > 0 or cf > 1
    assert np.array_equal(gx["experts"].numpy(),
                          _jax_top_e(jcfg, tree["router"], x))


def test_moe_padded_experts_never_chosen():
    """Experts padded 5 -> 8 (as tests/test_models.py:117): the router's
    mask keeps the pads out of every token's top 2, and the layer equals
    the JAX package's."""
    jcfg, cfg, tree = _moe_tree(GRANITE, 4, n_experts=5, n_experts_padded=8,
                                top_k=2)
    x = np.random.default_rng(12).normal(size=(1, 16, cfg.d_model)) \
        .astype(np.float32)
    want, wx, got, gx = _moe_both(jcfg, cfg, tree, x)
    assert int(gx["experts"].max()) < 5
    assert np.array_equal(gx["experts"].numpy(),
                          _jax_top_e(jcfg, tree["router"], x))
    _moe_close(got, want)
    assert float(gx["dropped"]) == float(wx["dropped"])


def test_moe_router_tie_lower_index_wins():
    """A tie in the router: experts 1, 3 and 6 get bit-equal logits (small
    integers times multiples of 1/8, exact in any summation order) above
    the others, so the top 2 are experts 1 and 3 -- ``lax.top_k``'s rule,
    the lower index first -- for every token, in both packages."""
    jcfg, cfg, tree = _moe_tree(GRANITE, 5)
    rng = np.random.default_rng(13)
    x = rng.integers(0, 2, (1, 8, cfg.d_model)).astype(np.float32)
    col = rng.integers(1, 4, cfg.d_model).astype(np.float32) / 8
    router = np.tile((col / 2)[:, None], (1, 8))
    router[:, [1, 3, 6]] = col[:, None]
    tree["router"] = router.astype(np.float32)
    want, wx, got, gx = _moe_both(jcfg, cfg, tree, x)
    assert np.all(gx["experts"].numpy() == [1, 3])
    assert np.array_equal(gx["experts"].numpy(),
                          _jax_top_e(jcfg, tree["router"], x))
    _moe_close(got, want)


def test_moe_ffn_dispatch_modes():
    """``moe_ffn`` takes the global, the rowwise or the expert-parallel
    dispatch as ``moe_dispatch`` says; the expert-parallel one, under a
    one-rank ("data", "model") mesh, equals the global dispatch within
    ``MOE_TOL`` with the same kept choices."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import moe
    _, cfg, tree = _moe_tree(GRANITE, 6)
    p = {k: t(v) for k, v in tree.items()}
    x = t(np.random.default_rng(14).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32))
    for mode, fn in (("global", moe.moe_ffn_global),
                     ("rowwise", moe.moe_ffn_rowwise)):
        got, _ = moe.moe_ffn(p, cfg.replace(moe_dispatch=mode), x)
        assert torch.equal(got, fn(p, cfg, x)[0]), mode
    want, wx = moe.moe_ffn_global(p, cfg, x)
    with sharding.use_mesh(MeshShape(("data", "model"), (1, 1))):
        got, gx = moe.moe_ffn(p, cfg.replace(moe_dispatch="ep_local"), x)
    _moe_close(got, want, "ep_local")
    assert torch.equal(moe.ep_local_kept(cfg, gx["experts"]), wx["kept"])


@pytest.fixture(scope="module")
def hybrid():
    """Reduced jamba parameters carried across (mamba's conv_b, d,
    dt_proj_b and a_log seeded away from their constant inits), and the
    JAX side of the hybrid tests run once, jitted: forward and loss on
    "reference" (its "pallas" forward raises:
    ``test_reference_fault_pallas_forward_raises``), and a 12-token
    teacher-forced decode at capacity_factor 8.0, where no token can
    drop (E / k = 4 <= 8), so decode and forward route alike."""
    jcfg, cfg = _cfgs(JAMBA)
    jp, _ = JM.init_params(jcfg, jax.random.PRNGKey(14))
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(22)
    for i, kind in enumerate(jcfg.pattern):
        if kind != "mamba":
            continue
        mx = tree["blocks"][f"pos{i}"]["mixer"]
        for key, shift, scale in (("conv_b", 0.0, 0.3), ("d", 1.0, 0.5),
                                  ("dt_proj_b", -4.0, 1.0),
                                  ("a_log", 0.0, 0.5)):
            mx[key] = (mx[key] + shift + scale * rng.normal(
                size=mx[key].shape)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = model.params_from_numpy(cfg, tree, device="cpu")
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    fwd, aux = jax.jit(lambda p, b: JM.forward(jcfg, p, b))(jp, jb)
    loss = float(jax.jit(lambda p, b: JM.loss_fn(jcfg, p, b))(jp, jb))
    c8 = jcfg.replace(capacity_factor=8.0)
    step = jax.jit(lambda p, c, tk, pos: JM.decode_step(c8, p, c, tk, pos))
    jc, _ = JM.init_cache(c8, 2, 16, jnp.float32)
    dec = []
    for i in range(12):
        lg, jc = step(jp, jc, jnp.asarray(toks[:, i]),
                      jnp.full((2,), i, jnp.int32))
        dec.append((np.asarray(lg), jax.tree.map(np.asarray, jc)))
    fwd8 = np.asarray(jax.jit(lambda p, b: JM.forward(c8, p, b)[0])(
        jp, {"tokens": jnp.asarray(toks[:, :12])}))
    return types.SimpleNamespace(jcfg=jcfg, cfg=cfg, tp=tp, toks=toks,
                                 labels=labels, fwd=np.asarray(fwd),
                                 aux=float(aux), loss=loss, dec=dec,
                                 fwd8=fwd8)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_hybrid_forward_and_loss(hybrid, backend):
    """Reduced jamba's ``forward`` (7 mamba layers, 1 attention layer, 4
    MoE layers; backend "cuda": B9's and B7's plain versions on CPU
    tensors) and ``loss_fn`` against the JAX package's on "reference":
    logits, the summed aux loss and the loss, equal argmax."""
    tb = {"tokens": t(hybrid.toks), "labels": t(hybrid.labels)}
    n0 = dict(kernels.LAUNCHES)
    got, aux = model.forward(hybrid.cfg, hybrid.tp, tb, backend=backend)
    loss = model.loss_fn(hybrid.cfg, hybrid.tp, tb, backend=backend)
    assert got.shape == (2, 24, hybrid.cfg.vocab)
    _close(got, hybrid.fwd, HYB_TOL)
    assert np.array_equal(got.argmax(-1).numpy(), hybrid.fwd.argmax(-1))
    _close(aux, hybrid.aux, HYB_TOL)
    _close(loss, hybrid.loss, HYB_TOL)
    assert kernels.LAUNCHES == n0                       # plain on CPU


def test_hybrid_decode_step(hybrid):
    """``init_cache`` in the JAX hybrid layout and a 12-token
    teacher-forced ``decode_step`` at capacity_factor 8.0 (float32
    caches) against the JAX package's: logits and every cache leaf (K/V
    per superblock, the mamba state and conv carry) at each step, equal
    argmax; the logits also against the forward's at the same position
    (the recurrent step against the scan)."""
    cfg = hybrid.cfg.replace(capacity_factor=8.0)
    tc = model.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    jc0, _ = JM.init_cache(hybrid.jcfg, 2, 16, jnp.float32)
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: v.shape for k, v in jc0.items()}
    assert tc["ssm_h"].dtype == torch.float32
    assert model.init_cache(cfg, 2, 16, device="cpu")["conv"].dtype == \
        torch.bfloat16
    for i, (jl, jc) in enumerate(hybrid.dec):
        tl, tc2 = model.decode_step(cfg, hybrid.tp, tc,
                                    t(hybrid.toks[:, i]),
                                    torch.full((2,), i, dtype=torch.int32))
        assert tc2 is tc                                   # in place
        _close(tl, jl, HYB_TOL, f"step {i}")
        assert np.array_equal(tl.argmax(-1).numpy(), jl.argmax(-1))
        _close(tl, hybrid.fwd8[:, i], HYB_TOL, f"forward {i}")
        for k in jc:
            np.testing.assert_allclose(tc[k].numpy(), jc[k], atol=HYB_TOL,
                                       rtol=1e-5, err_msg=f"{k} step {i}")


@pytest.fixture(scope="module")
def granite():
    """Reduced granite (2 layers of attention + MoE, 8 experts top 2) and
    the JAX side run once, jitted: forward and loss on "reference", and a
    12-step greedy decode at the published capacity_factor 1.25 (two
    tokens a step: capacity 1 an expert, so tokens drop in both
    packages alike)."""
    jcfg, cfg, jp, tp = _params(GRANITE, seed=15)
    rng = np.random.default_rng(23)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    fwd, aux = jax.jit(lambda p, b: JM.forward(jcfg, p, b))(jp, jb)
    loss = float(jax.jit(lambda p, b: JM.loss_fn(jcfg, p, b))(jp, jb))
    step = jax.jit(lambda p, c, tk, pos: JM.decode_step(jcfg, p, c, tk, pos))
    jc, _ = JM.init_cache(jcfg, 2, 16, jnp.float32)
    tok = np.array([3, 7], np.int32)
    dec = []
    for i in range(12):
        lg, jc = step(jp, jc, jnp.asarray(tok), jnp.full((2,), i, jnp.int32))
        dec.append((tok, np.asarray(lg), jax.tree.map(np.asarray, jc)))
        tok = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
    return types.SimpleNamespace(jcfg=jcfg, cfg=cfg, tp=tp, toks=toks,
                                 labels=labels, fwd=np.asarray(fwd),
                                 aux=float(aux), loss=loss, dec=dec)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_granite_forward_and_loss(granite, backend):
    """Reduced granite's ``forward`` and ``loss_fn`` against the JAX
    package's on "reference": logits atol 1e-5, the aux loss, the loss,
    equal argmax."""
    tb = {"tokens": t(granite.toks), "labels": t(granite.labels)}
    got, aux = model.forward(granite.cfg, granite.tp, tb, backend=backend)
    _close(got, granite.fwd)
    assert np.array_equal(got.argmax(-1).numpy(), granite.fwd.argmax(-1))
    _close(aux, granite.aux)
    _close(model.loss_fn(granite.cfg, granite.tp, tb, backend=backend),
           granite.loss)


def test_granite_decode_step(granite):
    """Reduced granite's greedy ``decode_step`` against the JAX package's:
    the same tokens, logits and K/V caches atol 1e-5 at each step."""
    tc = model.init_cache(granite.cfg, 2, 16, torch.float32, device="cpu")
    for i, (tok, jl, jc) in enumerate(granite.dec):
        tl, tc = model.decode_step(granite.cfg, granite.tp, tc, t(tok),
                                   torch.full((2,), i, dtype=torch.int32))
        _close(tl, jl, msg=f"step {i}")
        assert np.array_equal(tl.argmax(-1).numpy(), jl.argmax(-1))
        for k in ("k", "v"):
            _close(tc[k], jc[k], msg=f"{k} step {i}")


QWEN3 = "qwen3-moe-235b-a22b"


@pytest.mark.parametrize("dispatch", ["global", "rowwise"])
def test_moe_ffn_top8_matches_jax(dispatch):
    """Known difference D4 held: the port adds a token's k expert outputs
    in choice order, the JAX package scatter-adds them in expert order.
    At qwen3-moe's published top 8 (reduced, with 16 experts so that 8
    of them are a choice): outputs within ``MOE_TOL``, ``aux_loss`` atol
    1e-6, ``dropped`` equal, each token's experts the JAX routing's."""
    jcfg, cfg, tree = _moe_tree(QWEN3, 7, n_experts=16, n_experts_padded=16,
                                top_k=8)
    assert cfg.top_k == 8 and cfg.n_experts == 16
    x = np.random.default_rng(15).normal(size=(2, 16, cfg.d_model)) \
        .astype(np.float32)
    want, wx, got, gx = _moe_both(jcfg, cfg, tree, x, dispatch)
    _moe_close(got, want, dispatch)
    _close(gx["aux_loss"], wx["aux_loss"], 1e-6)
    assert float(gx["dropped"]) == float(wx["dropped"])
    assert np.array_equal(gx["experts"].numpy(),
                          _jax_top_e(jcfg, tree["router"], x))
