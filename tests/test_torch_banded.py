"""Banded attention (``attention.banded_attention``, ``model.
_forward_banded``) against the JAX package on the CPU, at reduced gemma3-1b
(window 8, five local layers then a global one).

The JAX package's parameters are carried across with
``model.params_from_numpy``; every input is drawn from a seed with numpy.
Tolerances, float32, those of tests/test_torch_models.py: atol 1e-5 on
attention outputs, per-layer outputs and logits (the two frameworks' CPU
matmuls and reductions sum in other orders), 2e-5 where backend "cuda"
runs the flash-attention plain version in the global layers (B7's
tolerance, tests/test_kernels.py:28); gradients within 5e-5 relative L2
of the masked forward's (the bound tests/test_torch_train.py holds the
port's gradients to JAX's by).  The JAX side is jitted once per module.
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
from repro.models import model as JM
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.tree import leaves as t_leaves
from repro_torch.core.tree import map_tree
from repro_torch.models import attention as attn
from repro_torch.models import model
from torch_parity import t

ARCH = "gemma3-1b"
TOL = 1e-5
FLASH_TOL = 2e-5
GRAD_TOL = 5e-5
SEQ = 20                       # 2.5 windows of 8: the last block padded
LAYERS = 14                    # two superblocks of six, a tail of two


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bd():
    """JAX's banded forward and loss, jitted once, and the parameters
    carried across."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 512, (2, SEQ)).astype(np.int32)
    labels = rng.integers(0, 512, (2, SEQ)).astype(np.int32)
    jcfg = j_reduced(j_get_arch(ARCH)).replace(n_layers=LAYERS,
                                               banded_local=True)
    cfg = reduced(get_arch(ARCH)).replace(n_layers=LAYERS, banded_local=True)
    jp = jax.jit(lambda k: JM.init_params(jcfg, k)[0])(
        jax.random.PRNGKey(LAYERS))
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    logits, loss = jax.jit(lambda p: (JM.forward(jcfg, p, jb)[0],
                                      JM.loss_fn(jcfg, p, jb)))(jp)
    band = jax.jit(jattn.banded_attention, static_argnums=(1, 4))
    return types.SimpleNamespace(
        jcfg=jcfg, cfg=cfg, jp=jp, band=band,
        tp=model.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu"),
        logits=np.asarray(logits), loss=np.asarray(loss), tokens=tokens,
        labels=labels)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=0, err_msg=msg)


@pytest.mark.parametrize("s", [5, 16, 13], ids=["s<w", "s=2w", "padded"])
def test_banded_attention_matches_jax(bd, s):
    """``banded_attention`` against JAX's (window 8): a sequence shorter
    than the window, two whole blocks, and one padded to a block; and
    against the port's masked attention at the same window."""
    r = bd
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    jmix = jax.tree.map(lambda a: a[0], r.jp["blocks"]["mixer"])
    want = r.band(jmix, r.jcfg, jnp.asarray(x), jnp.asarray(pos), 8)
    got = attn.banded_attention(r.tp["blocks"][0]["mixer"], r.cfg, t(x),
                                t(pos), 8)
    _close(got, want)
    masked = attn.attention(r.tp["blocks"][0]["mixer"], r.cfg, t(x), t(pos),
                            8)
    _close(got, masked)


@pytest.mark.parametrize("remat", [True, False])
def test_banded_forward_matches_jax(bd, remat):
    """The banded forward (superblocks of six, then the tail) against
    JAX's ``forward`` with ``banded_local``, with the parameters tracked by
    autograd so that ``remat`` recomputes each superblock; then each
    layer, on the model's own activations, against the port's non-banded
    block (masked attention at the same window)."""
    r = bd
    params = map_tree(lambda a: a.clone(), r.tp)
    for p in t_leaves(params):
        p.requires_grad_()
    tok = t(bd.tokens)
    logits, aux = model.forward(r.cfg, params, {"tokens": tok}, remat=remat)
    _close(logits.detach(), r.logits)
    assert float(aux) == 0.0
    with torch.no_grad():
        x = params["embed"][tok.to(torch.int64)]
        pos = model._arange_positions(2, SEQ, "cpu")
        for l, (blk, (kind, use_moe, w)) in enumerate(
                zip(params["blocks"], model.layer_plan(r.cfg))):
            band, _ = model._block_apply(r.cfg, blk, x, pos, w, kind,
                                         use_moe, "reference", banded=True)
            plain, _ = model._block_apply(r.cfg, blk, x, pos, w, kind,
                                          use_moe, "reference")
            _close(band, plain, msg=f"layer {l} (window {w})")
            x = band


def test_banded_forward_cuda_backend_matches_jax(bd):
    """Backend "cuda" (the flash-attention plain version on CPU tensors in
    the global layers) against JAX's banded forward."""
    r = bd
    with torch.no_grad():
        logits, _ = model.forward(r.cfg, r.tp, {"tokens": t(bd.tokens)},
                                  backend="cuda")
    _close(logits, r.logits, FLASH_TOL)


def test_banded_gradients_match_the_masked_forward(bd):
    """The loss (against JAX's banded loss) and its gradient through the
    banded forward, remat on, leaf by leaf against the gradient through
    the port's masked forward (``banded_local`` off), whose gradients
    tests/test_torch_train.py holds to JAX's."""
    batch = {"tokens": t(bd.tokens), "labels": t(bd.labels)}

    def loss_and_grads(cfg):
        params = map_tree(lambda a: a.clone().requires_grad_(), bd.tp)
        loss = model.loss_fn(cfg, params, batch)
        flat = iter(torch.autograd.grad(loss, list(t_leaves(params))))
        return loss.detach(), map_tree(lambda _: next(flat), params)

    loss, grads = loss_and_grads(bd.cfg)
    _close(loss, bd.loss)
    _, want = loss_and_grads(bd.cfg.replace(banded_local=False))
    errs = map_tree(lambda g, w: float(torch.linalg.vector_norm(g - w)
                                       / torch.linalg.vector_norm(w)),
                    grads, want)
    assert max(t_leaves(errs)) < GRAD_TOL, errs
