"""The port's vlm family (qwen2-vl-2b: M-RoPE, patch-embedding inputs,
biases on q/k/v) against the JAX package on the CPU, at the reduced size.

The JAX package's parameters are carried across with
``model.params_from_numpy`` (the q/k/v biases, zero at init, seeded so
that their path is exercised), and every input is made from a seed with
numpy and handed to both.  Positions are the stub frontend's (t, t % 7,
t % 5) with t = arange (``src/repro/train/data.py:55-64``).  Tolerances
(float32 throughout): atol 1e-5 on M-RoPE, ``_qkv`` (2-D and 3-D
positions), each layer's attention on both backends, logits, losses and
decode caches -- the two frameworks' CPU matmuls sum in other orders;
the flash_attention plain version (backend "cuda" on CPU tensors)
against the JAX package's Pallas kernel in interpret mode at atol 2e-5
(tests/test_kernels.py:28).  Generated tokens (argmax) are held equal.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch
from repro.configs.base import reduced as j_reduced
from repro.kernels.flash_attention.ops import mha as j_mha
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import model as JM
from repro_torch import kernels
from repro_torch.configs.base import get_arch, reduced
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models import attention as attn
from repro_torch.models import common, model
from torch_parity import t

VLM = "qwen2-vl-2b"
TOL = 1e-5
S = 24          # prefill tokens
N_DEC = 12      # decode steps


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0, err_msg=msg)


def stub_positions(b: int, s: int, repeat: int = 1) -> np.ndarray:
    """The stub frontend's (t, h, w) = (t, t % 7, t % 5), t = arange(s)
    // repeat: contiguous at repeat 1, each t held for ``repeat`` tokens
    (as an image's patches share one) above."""
    tt = np.arange(s) // repeat
    return np.ascontiguousarray(np.broadcast_to(
        np.stack([tt, tt % 7, tt % 5], -1), (b, s, 3))).astype(np.int32)


@pytest.fixture(scope="module")
def vlm():
    """Reduced qwen2-vl parameters carried across (biases seeded), the
    inputs, and the JAX side run once, jitted: forward and loss on
    "reference" from patch embeddings and stub positions, a text-only
    forward, and an N_DEC-token teacher-forced decode from float32
    caches."""
    jcfg, cfg = j_reduced(j_get_arch(VLM)), reduced(get_arch(VLM))
    jp, _ = JM.init_params(jcfg, jax.random.PRNGKey(21))
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(31)
    mixer = tree["blocks"]["mixer"]
    for k in ("bq", "bk", "bv"):
        mixer[k] = (0.1 * rng.normal(size=mixer[k].shape)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    emb = (rng.normal(size=(2, S, cfg.d_model)) * 0.02).astype(np.float32)
    pos = stub_positions(2, S)
    toks = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jb = {"embeds": jnp.asarray(emb), "positions": jnp.asarray(pos),
          "labels": jnp.asarray(labels)}
    fwd, aux = jax.jit(lambda p, b: JM.forward(jcfg, p, b))(jp, jb)
    loss = float(jax.jit(lambda p, b: JM.loss_fn(jcfg, p, b))(jp, jb))
    fwd_text = jax.jit(lambda p, tk: JM.forward(jcfg, p, {"tokens": tk})[0])(
        jp, jnp.asarray(toks[:, :N_DEC]))
    step = jax.jit(lambda p, c, tk, ps: JM.decode_step(jcfg, p, c, tk, ps))
    jc, _ = JM.init_cache(jcfg, 2, 16, jnp.float32)
    dec = []
    for i in range(N_DEC):
        lg, jc = step(jp, jc, jnp.asarray(toks[:, i]),
                      jnp.full((2,), i, jnp.int32))
        dec.append((np.asarray(lg), jax.tree.map(np.asarray, jc)))
    return types.SimpleNamespace(
        jcfg=jcfg, cfg=cfg, jp=jp, tp=model.params_from_numpy(
            cfg, tree, device="cpu"), emb=emb, pos=pos, toks=toks,
        labels=labels, fwd=np.asarray(fwd), aux=float(aux), loss=loss,
        fwd_text=np.asarray(fwd_text), dec=dec)


def _jblk(v, i):
    return jax.tree.map(lambda a: a[i], v.jp["blocks"])


def _layer_inputs(v, pos):
    """Each layer's normed attention input on the port's own activations
    (backend "reference"), from the fixture's embeddings."""
    x = t(v.emb)
    out = []
    for blk, (kind, use_moe, w) in zip(v.tp["blocks"],
                                       model.layer_plan(v.cfg)):
        out.append(common.norm(blk["ln1"], x, v.cfg.norm_kind,
                               v.cfg.norm_eps))
        x, _ = model._block_apply(v.cfg, blk, x, t(pos), w, kind, use_moe,
                                  "reference")
    return out


def test_vlm_init_params_shapes(vlm):
    """The port's own init has the JAX tree's shapes per layer and the
    q/k/v biases zero."""
    p = model.init_params(vlm.cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert p["embed"].shape == vlm.jp["embed"].shape
    assert "lm_head" not in p and len(p["blocks"]) == vlm.cfg.n_layers
    for grp in ("mixer", "ffn", "ln1", "ln2"):
        for k, a in vlm.jp["blocks"][grp].items():
            assert tuple(p["blocks"][0][grp][k].shape) == a.shape[1:], k
    assert torch.all(p["blocks"][1]["mixer"]["bq"] == 0)


@pytest.mark.parametrize("sections,hd", [((4, 2, 2), 16),
                                         ((16, 24, 24), 128)])
def test_m_rope(sections, hd):
    """``apply_m_rope`` against the JAX package's: the reduced config's
    sections and qwen2-vl-2b's published ones, theta 1e6, positions with
    repeats and each stream its own."""
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 3, 9, hd)).astype(np.float32)
    pos = rng.integers(0, 400, (2, 9, 3)).astype(np.int32)
    pos[:, 3:6, 0] = pos[:, 3:4, 0]
    _close(common.apply_m_rope(t(x), t(pos), sections, 1e6),
           jcommon.apply_m_rope(jnp.asarray(x), jnp.asarray(pos), sections,
                                1e6))


@pytest.mark.parametrize("ndim", [2, 3])
def test_vlm_qkv(vlm, ndim):
    """``_qkv`` of every layer against the JAX package's, with 3-D (t, h,
    w) positions and with 2-D ones (text-only decode: t = h = w)."""
    rng = np.random.default_rng(40 + ndim)
    x = rng.normal(size=(2, 7, vlm.cfg.d_model)).astype(np.float32)
    pos = stub_positions(2, 7) if ndim == 3 else \
        rng.integers(0, 50, (2, 7)).astype(np.int32)
    for i in range(vlm.cfg.n_layers):
        want = jattn._qkv(_jblk(vlm, i)["mixer"], vlm.jcfg, jnp.asarray(x),
                          jnp.asarray(pos))
        got = attn._qkv(vlm.tp["blocks"][i]["mixer"], vlm.cfg, t(x), t(pos))
        for a, b, n in zip(got, want, "qkv"):
            _close(a, b, msg=f"{n} layer {i}")


def test_vlm_attention_per_layer(vlm):
    """Each layer's ``attention`` on both backends against the JAX
    package's reference attention, on the layer's own input and the stub
    positions (contiguous t: the backends agree)."""
    for i, h in enumerate(_layer_inputs(vlm, vlm.pos)):
        want = jattn.attention(_jblk(vlm, i)["mixer"], vlm.jcfg,
                               jnp.asarray(h.numpy()),
                               jnp.asarray(vlm.pos), -1, backend="reference")
        for backend in ("reference", "cuda"):
            got = attn.attention(vlm.tp["blocks"][i]["mixer"], vlm.cfg, h,
                                 t(vlm.pos), -1, backend=backend)
            _close(got, want, msg=f"layer {i} {backend}")


def test_vlm_layer_attention_vs_pallas_interpret(vlm):
    """Each layer's attention core on the model's own activations: the
    port's ``mha`` on backend "cuda" (B7's plain version on the CPU)
    against the JAX package's ``mha(backend="pallas")`` in interpret
    mode, GQA group 2 of the reduced config: atol 2e-5."""
    for i, h in enumerate(_layer_inputs(vlm, vlm.pos)):
        q, k, v = attn._qkv(vlm.tp["blocks"][i]["mixer"], vlm.cfg, h,
                            t(vlm.pos))
        want = j_mha(*(jnp.asarray(a.contiguous().numpy())
                       for a in (q, k, v)), causal=True, window=-1,
                     backend="pallas", block_q=16, block_k=16)
        _close(mha(q, k, v, causal=True, backend="cuda"), want, 2e-5,
               f"layer {i}")


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_vlm_forward_and_loss(vlm, backend):
    """``forward`` from patch embeddings and 3-D positions, and
    ``loss_fn``, against the JAX package's on "reference": logits, the
    (zero) aux and the loss, equal argmax; no kernel launch on CPU
    tensors."""
    tb = {"embeds": t(vlm.emb), "positions": t(vlm.pos),
          "labels": t(vlm.labels)}
    n0 = dict(kernels.LAUNCHES)
    got, aux = model.forward(vlm.cfg, vlm.tp, tb, backend=backend)
    assert got.shape == (2, S, vlm.cfg.vocab) and float(aux) == vlm.aux == 0
    _close(got, vlm.fwd, msg=backend)
    assert np.array_equal(got.argmax(-1).numpy(), vlm.fwd.argmax(-1))
    _close(model.loss_fn(vlm.cfg, vlm.tp, tb, backend=backend), vlm.loss)
    assert kernels.LAUNCHES == n0


def test_vlm_decode_step(vlm):
    """The text-only decode (2-D positions: t = h = w = pos) from a
    float32 dense cache against the JAX package's: logits and caches at
    each step, equal argmax; and the logits against the text-only
    forward's at the same position."""
    tc = model.init_cache(vlm.cfg, 2, 16, torch.float32, device="cpu")
    for i, (jl, jc) in enumerate(vlm.dec):
        tl, tc = model.decode_step(vlm.cfg, vlm.tp, tc, t(vlm.toks[:, i]),
                                   torch.full((2,), i, dtype=torch.int32))
        _close(tl, jl, msg=f"step {i}")
        assert np.array_equal(tl.argmax(-1).numpy(), jl.argmax(-1))
        _close(tl, vlm.fwd_text[:, i], msg=f"forward {i}")
        for k in ("k", "v"):
            _close(tc[k], jc[k], msg=f"{k} step {i}")


def test_d6_repeated_t_positions(vlm):
    """Known difference D6, in both packages: backend "reference" masks by
    the temporal stream ``positions[..., 0]``, B7 (and JAX's Pallas
    kernel) by row index.  With each t held for two tokens, as an image's
    patches share one, the port's "reference" equals the JAX reference,
    the port's "cuda" equals JAX's Pallas interpret, and the two
    differ."""
    pos = stub_positions(2, S, repeat=2)
    for i, h in enumerate(_layer_inputs(vlm, pos)):
        jargs = (_jblk(vlm, i)["mixer"], vlm.jcfg, jnp.asarray(h.numpy()),
                 jnp.asarray(pos), -1)
        mixer = vlm.tp["blocks"][i]["mixer"]
        ref = attn.attention(mixer, vlm.cfg, h, t(pos), -1,
                             backend="reference")
        cu = attn.attention(mixer, vlm.cfg, h, t(pos), -1, backend="cuda")
        _close(ref, jattn.attention(*jargs, backend="reference"),
               msg=f"reference layer {i}")
        _close(cu, jattn.attention(*jargs, backend="pallas"), 2e-5,
               f"pallas layer {i}")
        assert float((ref - cu).abs().max()) > 1e-3, i
