"""The port's audio family (whisper-small: encoder-decoder with
cross-attention, LayerNorm, GELU MLP) against the JAX package on the
CPU, at the reduced size (2 encoder and 2 decoder layers over 32
frames).

The JAX package's parameters are carried across with
``model.params_from_numpy`` (the LayerNorm and MLP biases, zero at init,
seeded so that their path is exercised), and every input is made from a
seed with numpy and handed to both.  Tolerances (float32 throughout):
atol 1e-5 on cross-attention (and its cached form), the encoder's
output, logits, losses and decode logits and caches -- the two
frameworks' CPU matmuls sum in other orders; the flash_attention plain
version (backend "cuda" on CPU tensors) against the JAX package's Pallas
kernel in interpret mode at atol 2e-5 (tests/test_kernels.py:28), the
encoder's layers non-causal.  A teacher-forced decode from a filled
cross cache against ``forward`` at atol 2e-3 / rtol 1e-3, as the JAX
package's ``test_prefill_decode_consistency`` holds the other families.

Reference fault F6 (ROADMAP Queue 3): the JAX package zeroes the
decoder's cross-attention cache in ``init_cache`` and nothing writes it,
so its decode from a fresh cache attends to zeros.  The port matches it;
the tests fill the cache themselves from the encoder's output.
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

WHISPER = "whisper-small"
TOL = 1e-5
S = 16          # decoder tokens; every one also a decode step


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0, err_msg=msg)


def _seed_biases(tree, rng):
    """Add N(0, 0.1^2) to every LayerNorm and MLP bias (zero at init)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _seed_biases(v, rng)
        elif k in ("b", "b_up", "b_down"):
            tree[k] = (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)


def _j_encode(jcfg, p, enc):
    """The JAX package's encoder half of ``_forward_encdec``
    (src/repro/models/model.py:266-281), layer by layer."""
    b, se = enc.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(se)[None], (b, se))
    x = enc
    for i in range(jcfg.enc_layers):
        blk = jax.tree.map(lambda a: a[i], p["enc_blocks"])
        h = jcommon.norm(blk["ln1"], x, jcfg.norm_kind, jcfg.norm_eps)
        x = x + jattn.attention(blk["mixer"], jcfg, h, pos, -1,
                                causal=False, backend="reference")
        h = jcommon.norm(blk["ln2"], x, jcfg.norm_kind, jcfg.norm_eps)
        x = x + jcommon.ffn(blk["ffn"], h, jcfg.ffn_kind, jcfg.act)
    return jcommon.norm(p["enc_final_norm"], x, jcfg.norm_kind,
                        jcfg.norm_eps)


def _j_cross_kv(p, enc_out):
    """Each decoder layer's cross K/V of the encoder's output, stacked
    [L, B, Hkv, S_enc, hd]: what fills the cross cache."""
    cross = p["blocks"]["cross"]
    return (jnp.einsum("bsd,ldhk->lbhsk", enc_out, cross["wk"]),
            jnp.einsum("bsd,ldhk->lbhsk", enc_out, cross["wv"]))


def _cross_kv(cfg, params, enc_out):
    """The port's cross K/V of ``enc_out`` per decoder layer, stacked."""
    return (torch.stack([attn._proj(enc_out, blk["cross"]["wk"])
                         for blk in params["blocks"]]),
            torch.stack([attn._proj(enc_out, blk["cross"]["wv"])
                         for blk in params["blocks"]]))


@pytest.fixture(scope="module")
def whisper():
    """Reduced whisper parameters carried across (biases seeded), frame
    embeddings x 0.02 as the stub frontend draws them
    (src/repro/train/data.py:47-53), decoder tokens, and the JAX side run
    once, jitted: forward and loss on "reference", the encoder's output,
    and an S-token teacher-forced decode from float32 caches with the
    cross cache zero (as ``init_cache`` leaves it) and filled."""
    jcfg, cfg = j_reduced(j_get_arch(WHISPER)), reduced(get_arch(WHISPER))
    jp, _ = JM.init_params(jcfg, jax.random.PRNGKey(22))
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(32)
    _seed_biases(tree, rng)
    jp = jax.tree.map(jnp.asarray, tree)
    enc = (rng.normal(size=(2, cfg.enc_seq, cfg.d_model)) * 0.02).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jb = {"enc_embeds": jnp.asarray(enc), "tokens": jnp.asarray(toks),
          "labels": jnp.asarray(labels)}
    fwd, aux = jax.jit(lambda p, b: JM.forward(jcfg, p, b))(jp, jb)
    loss = float(jax.jit(lambda p, b: JM.loss_fn(jcfg, p, b))(jp, jb))
    enc_out = jax.jit(lambda p, e: _j_encode(jcfg, p, e))(jp,
                                                         jnp.asarray(enc))
    xk, xv = _j_cross_kv(jp, enc_out)
    step = jax.jit(lambda p, c, tk, ps: JM.decode_step(jcfg, p, c, tk, ps))
    dec = {}
    for filled in (False, True):
        jc, _ = JM.init_cache(jcfg, 2, S, jnp.float32)
        if filled:
            jc = {**jc, "cross_k": xk, "cross_v": xv}
        out = []
        for i in range(S):
            lg, jc = step(jp, jc, jnp.asarray(toks[:, i]),
                          jnp.full((2,), i, jnp.int32))
            out.append((np.asarray(lg), jax.tree.map(np.asarray, jc)))
        dec[filled] = out
    return types.SimpleNamespace(
        jcfg=jcfg, cfg=cfg, jp=jp, tp=model.params_from_numpy(
            cfg, tree, device="cpu"), enc=enc, toks=toks, labels=labels,
        fwd=np.asarray(fwd), aux=float(aux), loss=loss,
        enc_out=np.asarray(enc_out), dec=dec)


def test_whisper_init_params_shapes(whisper):
    """The port's own init has the JAX tree's shapes: encoder blocks,
    decoder blocks with ``cross`` and ``ln_cross``, ``enc_final_norm``;
    and ``params_from_numpy`` lays the stacked encoder out per layer."""
    cfg, jp = whisper.cfg, whisper.jp
    p = model.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    assert sorted(p) == sorted(jp) == sorted(whisper.tp)
    assert len(p["enc_blocks"]) == cfg.enc_layers
    assert len(p["blocks"]) == cfg.n_layers
    for key in ("enc_blocks", "blocks"):
        for grp, sub in jp[key].items():
            for k, a in sub.items():
                assert tuple(p[key][0][grp][k].shape) == a.shape[1:], \
                    (key, grp, k)
                assert np.array_equal(whisper.tp[key][1][grp][k].numpy(),
                                      np.asarray(a[1])), (key, grp, k)
    assert torch.all(p["enc_final_norm"]["w"] == 1)
    assert torch.all(p["blocks"][0]["ln_cross"]["b"] == 0)


def test_cross_attention_and_cached(whisper):
    """``cross_attention`` and ``cross_attention_cached`` of every
    decoder layer against the JAX package's (no bias, no RoPE); the
    cached form from float32 and from bfloat16 encoder K/V."""
    cfg, jcfg = whisper.cfg, whisper.jcfg
    rng = np.random.default_rng(33)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    for i in range(cfg.n_layers):
        jc = jax.tree.map(lambda a: a[i], whisper.jp["blocks"])["cross"]
        tc = whisper.tp["blocks"][i]["cross"]
        _close(attn.cross_attention(tc, cfg, t(x), t(enc)),
               jattn.cross_attention(jc, jcfg, jnp.asarray(x),
                                     jnp.asarray(enc)), msg=f"layer {i}")
        xk = jnp.einsum("bsd,dhk->bhsk", jnp.asarray(enc), jc["wk"])
        xv = jnp.einsum("bsd,dhk->bhsk", jnp.asarray(enc), jc["wv"])
        for dt in (jnp.float32, jnp.bfloat16):
            want = jattn.cross_attention_cached(
                jc, jcfg, jnp.asarray(x1), xk.astype(dt), xv.astype(dt))
            got = attn.cross_attention_cached(
                tc, cfg, t(x1), t(np.asarray(xk.astype(jnp.float32))).to(
                    getattr(torch, dt.__name__)),
                t(np.asarray(xv.astype(jnp.float32))).to(
                    getattr(torch, dt.__name__)))
            _close(got, want, msg=f"cached layer {i} {dt.__name__}")


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_encoder_matches_jax(whisper, backend):
    """The port's encoder (``model._encode``; non-causal self-attention in
    every layer) against the JAX package's encoder half of
    ``_forward_encdec``."""
    got = model._encode(whisper.cfg, whisper.tp, t(whisper.enc), backend)
    _close(got, whisper.enc_out, msg=backend)


def test_layer_attention_vs_pallas_interpret(whisper):
    """Every layer's attention core on the model's own activations: the
    port's ``mha`` on backend "cuda" (B7's plain version on the CPU)
    against the JAX package's ``mha(backend="pallas")`` in interpret mode,
    atol 2e-5: the encoder's layers non-causal over 32 frames, the
    decoder's causal."""
    cfg, tp = whisper.cfg, whisper.tp

    def check(mixer, h, causal, msg):
        s = h.shape[1]
        pos = torch.arange(s)[None].expand(h.shape[0], s)
        q, k, v = attn._qkv(mixer, cfg, h, pos)
        want = j_mha(*(jnp.asarray(a.contiguous().numpy())
                       for a in (q, k, v)), causal=causal, window=-1,
                     backend="pallas", block_q=16, block_k=16)
        _close(mha(q, k, v, causal=causal, backend="cuda"), want, 2e-5, msg)

    x = t(whisper.enc)
    pos = torch.arange(x.shape[1])[None].expand(2, -1)
    for i, blk in enumerate(tp["enc_blocks"]):
        check(blk["mixer"], common.norm(blk["ln1"], x, cfg.norm_kind,
                                        cfg.norm_eps), False,
              f"encoder layer {i}")
        x = model._enc_block(cfg, blk, x, pos, "reference")
    enc_out = model._encode(cfg, tp, t(whisper.enc), "reference")
    x = tp["embed"][t(whisper.toks).long()]
    pos = torch.arange(S)[None].expand(2, S)
    for i, blk in enumerate(tp["blocks"]):
        check(blk["mixer"], common.norm(blk["ln1"], x, cfg.norm_kind,
                                        cfg.norm_eps), True,
              f"decoder layer {i}")
        x = model._dec_block(cfg, blk, x, pos, enc_out, "reference")


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_whisper_forward_and_loss(whisper, backend):
    """``forward`` (encoder, then decoder with cross-attention) and
    ``loss_fn`` against the JAX package's on "reference": logits, zero
    aux, the loss, equal argmax; no kernel launch on CPU tensors."""
    tb = {"enc_embeds": t(whisper.enc), "tokens": t(whisper.toks),
          "labels": t(whisper.labels)}
    n0 = dict(kernels.LAUNCHES)
    got, aux = model.forward(whisper.cfg, whisper.tp, tb, backend=backend)
    assert got.shape == (2, S, whisper.cfg.vocab)
    assert float(aux) == whisper.aux == 0
    _close(got, whisper.fwd, msg=backend)
    assert np.array_equal(got.argmax(-1).numpy(), whisper.fwd.argmax(-1))
    _close(model.loss_fn(whisper.cfg, whisper.tp, tb, backend=backend),
           whisper.loss)
    assert kernels.LAUNCHES == n0


def _decode(whisper, cache):
    """The port's S-step teacher-forced decode; (logits, cache) a step."""
    out = []
    for i in range(S):
        lg, cache = model.decode_step(
            whisper.cfg, whisper.tp, cache, t(whisper.toks[:, i]),
            torch.full((2,), i, dtype=torch.int32))
        out.append((lg, {k: v.clone() for k, v in cache.items()}))
    return out


def _assert_decode_matches_jax(got, want):
    for i, ((tl, tc), (jl, jc)) in enumerate(zip(got, want)):
        _close(tl, jl, msg=f"step {i}")
        assert np.array_equal(tl.argmax(-1).numpy(), jl.argmax(-1))
        assert sorted(tc) == sorted(jc)
        for k in jc:
            _close(tc[k], jc[k], msg=f"{k} step {i}")


def test_whisper_decode_zero_cross_cache(whisper):
    """Reference fault F6: from ``init_cache`` as it comes (the cross
    cache zero, in the JAX layout [L, B, Hkv, enc_seq, hd]), the port's
    decode equals the JAX package's at every step -- and so disagrees
    with ``forward``, which attends to the encoder's output."""
    cache = model.init_cache(whisper.cfg, 2, S, torch.float32, device="cpu")
    assert tuple(cache["cross_k"].shape) == (
        whisper.cfg.n_layers, 2, whisper.cfg.n_kv_heads,
        whisper.cfg.enc_seq, whisper.cfg.head_dim)
    assert not torch.any(cache["cross_k"]) and not torch.any(
        cache["cross_v"])
    got = _decode(whisper, cache)
    _assert_decode_matches_jax(got, whisper.dec[False])
    lg = np.stack([g[0].numpy() for g in got], 1)
    assert np.abs(lg - whisper.fwd).max() > 1e-2       # F6 shows


def test_whisper_decode_filled_cross_cache(whisper):
    """With each layer's cross K/V of the encoder's output written into
    the cache (the port's own encoder and projections), the teacher-
    forced decode equals the JAX package's from its filled cache, and
    reproduces ``forward`` at atol 2e-3 / rtol 1e-3 with equal argmax."""
    cache = model.init_cache(whisper.cfg, 2, S, torch.float32, device="cpu")
    enc_out = model._encode(whisper.cfg, whisper.tp, t(whisper.enc),
                            "reference")
    xk, xv = _cross_kv(whisper.cfg, whisper.tp, enc_out)
    cache["cross_k"].copy_(xk)
    cache["cross_v"].copy_(xv)
    got = _decode(whisper, cache)
    _assert_decode_matches_jax(got, whisper.dec[True])
    lg = np.stack([g[0].numpy() for g in got], 1)
    np.testing.assert_allclose(lg, whisper.fwd, atol=2e-3, rtol=1e-3)
    assert np.array_equal(lg.argmax(-1), whisper.fwd.argmax(-1))
