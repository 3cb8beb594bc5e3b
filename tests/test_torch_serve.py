"""The port's tiered paged KV cache (``core/paged_kv.py``) and serving
engine (``serve/engine.py``) against the JAX package on the CPU.

Tolerances: every ``paged_kv`` function, fed the same inputs, leaves a
state bit-equal to the JAX package's (pools, summaries with their
+-finfo.max sentinels, tier, tracker, counters) and returns bit-equal
selections and gathers.  ``ServeEngine`` on ``reduced(phi4-mini-3.8b)``
(and on reduced granite and qwen2-vl) with the configs of
tests/test_serve.py: generated tokens, every integer
leaf of the engine state, the counters and the obs histograms equal; the
page pools and summaries equal in placement (which entries are unwritten
zeros or sentinels) and within atol 1e-5 in value -- the K/V written
there are the model's float32 projections, which torch's and XLA's CPU
matmuls round apart (measured: at most 4e-6); ``obs.ev_score`` at rtol
1e-6 (a float32 sum over buckets in another order).  The port runs
backend "cuda" on CPU tensors (the kernels' plain versions) and
"reference"; its kernels are held to those on the card in
tests/test_torch_kernels.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch
from repro.configs.base import reduced as j_reduced
from repro.core import paged_kv as jpk
from repro.core import tiers as jtiers
from repro.models import model as JM
from repro.serve import engine as jserve
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import engine, paged_kv, prng, tiers
from repro_torch.core.paged_kv import PagedKVState
from repro_torch.models import model
from repro_torch.serve.engine import Request, ServeEngine, paged_decode_step
from torch_parity import assert_trees_equal, leaves, t

JMCFG = j_reduced(j_get_arch("phi4-mini-3.8b"))
MCFG = reduced(get_arch("phi4-mini-3.8b"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the tensors are small, and the test workers run
    side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kv_kw(dtype="float32", **kw):
    base = dict(n_layers=2, kv_heads=2, head_dim=8, page_tokens=4,
                fast_pages=8, slow_pages=256, max_seqs=4,
                max_pages_per_seq=16, topk_pages=4, recent_pages=2,
                dtype=dtype)
    base.update(kw)
    return base


def _rand_kv(rng, cfg, *lead):
    shape = (cfg.n_layers, *lead, cfg.kv_heads, cfg.head_dim)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


# ------------------------------------------------------------ paged_kv

STEPS = 32


@functools.lru_cache(maxsize=None)
def _jax_trajectory(dtype):
    """The JAX package's paged-KV functions (jitted) on a seeded op
    stream: init, a 13-token prefill, then STEPS appends for every
    sequence (some lanes invalid), compactions whenever fewer than
    max_seqs fast slots are free, and a select_pages + gather_pages every
    fifth step.  Returns [(op, inputs, outputs as numpy)]."""
    cfg = jpk.PagedKVConfig(**_kv_kw(dtype))
    jit = lambda f, *static: jax.jit(f, static_argnums=static)
    init, bulk = jit(jpk.init, 0), jit(jpk.bulk_insert, 1)
    append, compact = jit(jpk.append_tokens, 1), jit(jpk.compact, 1)
    select, gather = jit(jpk.select_pages, 1), jit(jpk.gather_pages, 1)
    tail = jit(jpk.tail_page_keys, 1)
    need = jit(jpk.needs_compaction, 1)
    rng = np.random.default_rng(0)
    get = jax.device_get
    js = init(cfg)
    out = [("init", (), get(js))]
    k, v = _rand_kv(rng, cfg, 16)
    js = bulk(js, cfg, jnp.int32(1), jnp.asarray(k), jnp.asarray(v),
              jnp.int32(13))
    out.append(("bulk_insert", (k, v), get(js)))
    seq_ids = jnp.arange(cfg.max_seqs, dtype=jnp.int32)
    key = jax.random.PRNGKey(7)
    for step in range(STEPS):
        k, v = _rand_kv(rng, cfg, cfg.max_seqs)
        valid = rng.random(cfg.max_seqs) > 0.2
        js = append(js, cfg, seq_ids, jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(valid))
        out.append(("append", (k, v, valid), get((js, tail(js, cfg)))))
        while int(jtiers.free_fast_slots(js.tier)) < cfg.max_seqs:
            key, sub = jax.random.split(key)
            flag = bool(need(js, cfg))
            js, _ = compact(js, cfg, sub)
            out.append(("compact", (flag,), get(js)))
        if step % 5 == 4:
            q = rng.normal(size=(cfg.n_layers, cfg.max_seqs, 4,
                                 cfg.head_dim)).astype(np.float32)
            pidx, pm = select(js, cfg, seq_ids, jnp.asarray(q))
            js, kk, vv, tm = gather(js, cfg, seq_ids, pidx, pm)
            out.append(("select_gather", (q,), get((pidx, pm, js, kk, vv,
                                                    tm))))
    keys = jnp.arange(cfg.max_seqs * cfg.max_pages_per_seq, dtype=jnp.int32)
    out.append(("slots_of", (), get((jpk.fast_slots_of(js, keys),
                                     jpk.slow_slots_of(js, keys)))))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_paged_kv_functions_match_jax(backend, dtype):
    """init, bulk_insert, append_tokens (fresh pages, in-page writes,
    reopened demoted tail pages), compact (with its Movement replay),
    tail_page_keys, needs_compaction, fast/slow_slots_of, select_pages
    and gather_pages, op by op on the JAX package's stream: every leaf
    bit-equal."""
    cfg = paged_kv.PagedKVConfig(**_kv_kw(dtype))
    seq_ids = torch.arange(cfg.max_seqs, dtype=torch.int32)
    key = prng.PRNGKey(7)
    n_comp = 0
    st = None
    for op, args, want in _jax_trajectory(dtype):
        if op == "init":
            st = paged_kv.init(cfg, device="cpu")
            got = st
        elif op == "bulk_insert":
            st = paged_kv.bulk_insert(st, cfg, torch.tensor(1), t(args[0]),
                                      t(args[1]), torch.tensor(13),
                                      backend=backend)
            got = st
        elif op == "append":
            k, v, valid = args
            st = paged_kv.append_tokens(st, cfg, seq_ids, t(k), t(v),
                                        t(valid), backend=backend)
            got = (st, paged_kv.tail_page_keys(st, cfg))
        elif op == "compact":
            assert bool(paged_kv.needs_compaction(st, cfg)) == args[0]
            key, sub = prng.split(key, 2)
            st, _ = paged_kv.compact(st, cfg, sub, backend=backend)
            got = st
            n_comp += 1
        elif op == "select_gather":
            pidx, pm = paged_kv.select_pages(st, cfg, seq_ids, t(args[0]))
            st, kk, vv, tm = paged_kv.gather_pages(st, cfg, seq_ids, pidx,
                                                   pm, backend=backend)
            got = (pidx, pm, st, kk, vv, tm)
        else:
            keys = torch.arange(cfg.max_seqs * cfg.max_pages_per_seq,
                                dtype=torch.int32)
            got = (paged_kv.fast_slots_of(st, keys),
                   paged_kv.slow_slots_of(st, keys))
        assert_trees_equal(want, engine.state_to_numpy(got))
    assert n_comp > 0 and int(st.tier.ctr.demoted) > 0
    assert int(st.tier.ctr.reads[1]) > 0           # slow reads happened


def test_select_pages_ties_at_infinity():
    """Recent pages tie at +inf and absent ones at -inf: the lower page
    index comes first among equals, as XLA's top_k orders them (a stable
    descending sort), when top-k covers more pages than exist."""
    kw = _kv_kw(topk_pages=12, recent_pages=3)
    jcfg, cfg = jpk.PagedKVConfig(**kw), paged_kv.PagedKVConfig(**kw)
    rng = np.random.default_rng(1)
    js = jpk.init(jcfg)
    st = paged_kv.init(cfg, device="cpu")
    bulk = jax.jit(jpk.bulk_insert, static_argnums=1)
    for sid, n in ((0, 9), (2, 22), (3, 1)):
        k, v = _rand_kv(rng, cfg, 24)
        js = bulk(js, jcfg, jnp.int32(sid), jnp.asarray(k), jnp.asarray(v),
                  jnp.int32(n))
        st = paged_kv.bulk_insert(st, cfg, torch.tensor(sid), t(k), t(v),
                                  torch.tensor(n))
    seq_ids = np.array([0, 1, 2, 3], np.int32)
    q = rng.normal(size=(2, 4, 2, 8)).astype(np.float32)
    jp_, jm = jax.jit(jpk.select_pages, static_argnums=1)(
        js, jcfg, jnp.asarray(seq_ids), jnp.asarray(q))
    pidx, pm = paged_kv.select_pages(st, cfg, t(seq_ids), t(q))
    assert_trees_equal((np.asarray(jp_), np.asarray(jm)),
                       (pidx.numpy(), pm.numpy()))
    # sequence 1 is empty: every score -inf, pages 0..11 in order
    assert pidx[1].tolist() == list(range(12)) and not pm[1].any()
    # sequence 0: its 3 recent pages (+inf) lead, in page order
    assert pidx[0, :3].tolist() == [0, 1, 2]


# -------------------------------------------------- paged vs dense decode

def test_paged_decode_matches_dense_cache():
    """The port's tests/test_serve.py:26-50: with top-k covering all
    pages, the tiered paged decode equals the dense-cache decode (atol
    3e-3, rtol 1e-3 as there) even after pages were demoted to the slow
    pool and read back from it."""
    params = model.init_params(MCFG, torch.Generator().manual_seed(0),
                               device="cpu")
    cfg = paged_kv.PagedKVConfig(
        n_layers=MCFG.n_layers, kv_heads=MCFG.n_kv_heads,
        head_dim=MCFG.head_dim, page_tokens=4, fast_pages=8, slow_pages=1024,
        max_seqs=2, max_pages_per_seq=64, topk_pages=32, recent_pages=2,
        dtype="float32")
    kv = paged_kv.init(cfg, device="cpu")
    cache = model.init_cache(MCFG, 2, 64, torch.float32, device="cpu")
    toks = np.random.default_rng(1).integers(1, MCFG.vocab, 40)
    seq_ids = torch.arange(2, dtype=torch.int32)
    key = prng.PRNGKey(2)
    for step in range(40):
        tt = torch.full((2,), int(toks[step]), dtype=torch.int32)
        pos = torch.full((2,), step, dtype=torch.int32)
        dl, cache = model.decode_step(MCFG, params, cache, tt, pos)
        while int(tiers.free_fast_slots(kv.tier)) < 2:
            key, sub = prng.split(key, 2)
            kv, _ = paged_kv.compact(kv, cfg, sub)
        pl, kv = paged_decode_step(MCFG, cfg, params, kv, tt, seq_ids, pos,
                                   torch.ones(2, dtype=torch.bool))
        np.testing.assert_allclose(pl.numpy(), dl.numpy(), atol=3e-3,
                                   rtol=1e-3, err_msg=f"step {step}")
    assert int(kv.tier.ctr.demoted) > 0
    assert int(kv.tier.ctr.hits[1]) > 0


# ------------------------------------------------------------ ServeEngine

# tests/test_serve.py:58 and :72 (fast_pages, max_seqs, topk, requests,
# prompt length, max_new), the second also at compaction_quantum 4
SERVE_CASES = {"all_requests": (48, 4, 8, 6, 24, 12, 0),
               "memory_pressure": (16, 4, 4, 4, 40, 8, 0),
               "memory_pressure_q4": (16, 4, 4, 4, 40, 8, 4)}


def _serve_kv(C, fast_pages, max_seqs, topk, mcfg=JMCFG):
    return C(n_layers=mcfg.n_layers, kv_heads=mcfg.n_kv_heads,
             head_dim=mcfg.head_dim, page_tokens=4, fast_pages=fast_pages,
             slow_pages=1024, max_seqs=max_seqs, max_pages_per_seq=64,
             topk_pages=topk, recent_pages=2, dtype="float32")


def _prompts(n, plen):
    rng = np.random.default_rng(0)
    return [list(rng.integers(1, 400, plen)) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_params():
    return JM.init_params(JMCFG, jax.random.PRNGKey(0))[0]


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    """The JAX engine's run of one case: (tokens, state, counters, obs
    snapshot, ticks)."""
    fp, ms, topk, n, plen, mnew, q = SERVE_CASES[case]
    eng = jserve.ServeEngine(JMCFG, _serve_kv(jpk.PagedKVConfig, fp, ms,
                                              topk), _jax_params(),
                             compaction_quantum=q)
    reqs = [jserve.Request(rid=i, prompt=p, max_new=mnew)
            for i, p in enumerate(_prompts(n, plen))]
    for r in reqs:
        eng.submit(r)
    ticks = eng.run(max_ticks=400)
    return ([r.out for r in reqs], jax.device_get(eng.est), eng.counters,
            eng.obs_snapshot(), ticks)


def _port_params():
    return model.params_from_numpy(MCFG, jax.tree.map(np.asarray,
                                                      _jax_params()),
                                   device="cpu")


def _assert_engine_states(want, got):
    """Integer leaves bit-equal; the page payloads equal in placement and
    within atol 1e-5; ev_score within rtol 1e-6; other floats bit-equal."""
    a, b = leaves(want), leaves(got)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        if p.startswith(".payload.") and x.dtype.kind == "f":
            assert np.array_equal(x == 0, y == 0), p
            np.testing.assert_allclose(y, x, atol=1e-5, rtol=0, err_msg=p)
        elif p == ".obs.ev_score":
            np.testing.assert_allclose(y, x, rtol=1e-6, atol=0, err_msg=p)
        else:
            assert_trees_equal(x, y)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_engine_matches_jax(case, backend):
    """``ServeEngine`` end to end against the JAX package's: the same
    tokens for every request, the same number of ticks, every engine
    leaf (tier, tracker, policy, counters, in-flight carry, obs) and the
    counters; the obs histograms bit-equal."""
    fp, ms, topk, n, plen, mnew, q = SERVE_CASES[case]
    jtokens, jstate, jctr, jobs, jticks = _jax_run(case)
    eng = ServeEngine(MCFG, _serve_kv(paged_kv.PagedKVConfig, fp, ms, topk),
                      _port_params(), backend=backend, compaction_quantum=q,
                      device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=mnew)
            for i, p in enumerate(_prompts(n, plen))]
    for r in reqs:
        eng.submit(r)
    assert eng.run(max_ticks=400) == jticks
    assert [r.out for r in reqs] == jtokens
    assert all(len(r.out) == mnew for r in reqs)
    assert eng.stats["retired"] == n
    assert eng.counters == jctr
    _assert_engine_states(jstate, engine.state_to_numpy(eng.est))
    obs = eng.obs_snapshot()
    for k in ("hist", "hist_sum", "timeline"):
        assert_trees_equal(jobs[k], obs[k])
    if case.startswith("memory_pressure"):
        assert jctr["compactions"] > 0 and jctr["demoted"] > 0


GRANITE = "granite-moe-3b-a800m"


@functools.lru_cache(maxsize=None)
def _granite_run():
    """The JAX engine serving reduced granite (attention + MoE in both
    layers, 8 experts top 2) through the memory_pressure case."""
    fp, ms, topk, n, plen, mnew, q = SERVE_CASES["memory_pressure"]
    jcfg = j_reduced(j_get_arch(GRANITE))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(5))[0]
    eng = jserve.ServeEngine(jcfg, _serve_kv(jpk.PagedKVConfig, fp, ms,
                                             topk), jp)
    reqs = [jserve.Request(rid=i, prompt=p, max_new=mnew)
            for i, p in enumerate(_prompts(n, plen))]
    for r in reqs:
        eng.submit(r)
    ticks = eng.run(max_ticks=400)
    return (jax.tree.map(np.asarray, jp), [r.out for r in reqs],
            jax.device_get(eng.est), eng.counters, ticks)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_serve_engine_moe_matches_jax(backend):
    """``ServeEngine`` over reduced granite (``paged_decode_step``'s MoE
    branch: the decode batch of 4 sequences routes through
    ``moe_ffn``, capacity 2 an expert, so tokens drop in both packages
    alike) against the JAX package's: the same tokens, ticks, counters
    and engine leaves (``_assert_engine_states``)."""
    fp, ms, topk, n, plen, mnew, q = SERVE_CASES["memory_pressure"]
    tree, jtokens, jstate, jctr, jticks = _granite_run()
    cfg = reduced(get_arch(GRANITE))
    eng = ServeEngine(cfg, _serve_kv(paged_kv.PagedKVConfig, fp, ms, topk),
                      model.params_from_numpy(cfg, tree, device="cpu"),
                      backend=backend, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=mnew)
            for i, p in enumerate(_prompts(n, plen))]
    for r in reqs:
        eng.submit(r)
    assert eng.run(max_ticks=400) == jticks
    assert [r.out for r in reqs] == jtokens
    assert eng.counters == jctr
    _assert_engine_states(jstate, engine.state_to_numpy(eng.est))


VLM = "qwen2-vl-2b"


@functools.lru_cache(maxsize=None)
def _vlm_run():
    """The JAX engine serving reduced qwen2-vl (M-RoPE with t = h = w =
    pos in the paged decode, biases on q/k/v seeded away from their zero
    init) through the memory_pressure case."""
    fp, ms, topk, n, plen, mnew, q = SERVE_CASES["memory_pressure"]
    jcfg = j_reduced(j_get_arch(VLM))
    tree = jax.tree.map(np.asarray,
                        JM.init_params(jcfg, jax.random.PRNGKey(6))[0])
    rng = np.random.default_rng(34)
    mixer = tree["blocks"]["mixer"]
    for k in ("bq", "bk", "bv"):
        mixer[k] = (0.1 * rng.normal(size=mixer[k].shape)).astype(np.float32)
    eng = jserve.ServeEngine(jcfg, _serve_kv(jpk.PagedKVConfig, fp, ms,
                                             topk, jcfg),
                             jax.tree.map(jnp.asarray, tree))
    reqs = [jserve.Request(rid=i, prompt=p, max_new=mnew)
            for i, p in enumerate(_prompts(n, plen))]
    for r in reqs:
        eng.submit(r)
    ticks = eng.run(max_ticks=400)
    return (tree, [r.out for r in reqs], jax.device_get(eng.est),
            eng.counters, eng.obs_snapshot(), ticks)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_serve_engine_vlm_matches_jax(backend):
    """``ServeEngine`` over reduced qwen2-vl (``paged_decode_step`` reaches
    ``_qkv``'s M-RoPE branch with 2-D positions) against the JAX
    package's: the same tokens, ticks, counters, engine leaves
    (``_assert_engine_states``) and obs histograms; pages are demoted."""
    fp, ms, topk, n, plen, mnew, q = SERVE_CASES["memory_pressure"]
    tree, jtokens, jstate, jctr, jobs, jticks = _vlm_run()
    cfg = reduced(get_arch(VLM))
    eng = ServeEngine(cfg, _serve_kv(paged_kv.PagedKVConfig, fp, ms, topk,
                                     cfg),
                      model.params_from_numpy(cfg, tree, device="cpu"),
                      backend=backend, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=mnew)
            for i, p in enumerate(_prompts(n, plen))]
    for r in reqs:
        eng.submit(r)
    assert eng.run(max_ticks=400) == jticks
    assert [r.out for r in reqs] == jtokens
    assert all(len(r.out) == mnew for r in reqs)
    assert eng.counters == jctr
    assert jctr["compactions"] > 0 and jctr["demoted"] > 0
    _assert_engine_states(jstate, engine.state_to_numpy(eng.est))
    obs = eng.obs_snapshot()
    for k in ("hist", "hist_sum", "timeline"):
        assert_trees_equal(jobs[k], obs[k])


def test_serve_engine_refuses_audio():
    """Whisper's decode needs its cross-attention, for which the paged
    decode step has no place: the engine raises (the JAX engine would
    serve it and skip the cross-attention without a word; ROADMAP)."""
    cfg = reduced(get_arch("whisper-small"))
    params = model.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="uniform-attention"):
        ServeEngine(cfg, paged_kv.PagedKVConfig(**_kv_kw()), params,
                    device="cpu")


def test_serve_engine_refuses_hybrid():
    """The engine serves uniform-attention families only, as the JAX
    package's does: a hybrid (jamba) model raises."""
    cfg = reduced(get_arch("jamba-v0.1-52b"))
    params = model.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="uniform-attention"):
        ServeEngine(cfg, paged_kv.PagedKVConfig(**_kv_kw()), params,
                    device="cpu")


def test_serve_host_reads_per_tick():
    """A tick's host reads: the maintenance loop's (one at entry, one per
    compaction) and the JAX tick's three (sequence lengths before and
    after, the argmax)."""
    fp, ms, topk, n, plen, mnew, q = SERVE_CASES["memory_pressure"]
    eng = ServeEngine(MCFG, _serve_kv(paged_kv.PagedKVConfig, fp, ms, topk),
                      _port_params(), device="cpu")
    for i, p in enumerate(_prompts(n, plen)):
        eng.submit(Request(rid=i, prompt=p, max_new=mnew))
    while eng.queue or eng.active:
        h0, c0 = engine.HOST_READS.n, eng.stats["compactions"]
        eng.step()
        assert engine.HOST_READS.n - h0 == 4 + eng.stats["compactions"] - c0


def test_state_from_numpy_takes_paged_kv():
    """A JAX serving state with a bfloat16 ``PagedKVState`` payload comes
    across bit for bit (``payload_types``) and back."""
    cfg = _serve_kv(jpk.PagedKVConfig, 16, 2, 4)._replace(dtype="bfloat16")
    eng = jserve.ServeEngine(JMCFG, cfg, _jax_params())
    for i, p in enumerate(_prompts(2, 10)):
        eng.submit(jserve.Request(rid=i, prompt=p, max_new=2))
    for _ in range(6):
        eng.step()
    want = jax.device_get(eng.est)
    ecfg = engine.EngineConfig(tier=cfg.tier())
    got = engine.state_from_numpy(want, ecfg, device="cpu",
                                  payload_types=(PagedKVState,))
    assert got.payload.k_fast.dtype == torch.bfloat16
    assert_trees_equal(want, engine.state_to_numpy(got))


def _defaults():
    cfg = paged_kv.PagedKVConfig(**_kv_kw())
    gen = torch.Generator()
    vlm, audio = reduced(get_arch(VLM)), reduced(get_arch("whisper-small"))
    return {
        "ServeEngine": lambda: ServeEngine(
            MCFG, cfg, model.init_params(MCFG, gen, device="cpu")),
        "ServeEngine(vlm)": lambda: ServeEngine(
            vlm, cfg, model.init_params(vlm, gen, device="cpu")),
        "model.init_params": lambda: model.init_params(MCFG, gen),
        "model.init_params(vlm)": lambda: model.init_params(vlm, gen),
        "model.init_params(audio)": lambda: model.init_params(audio, gen),
        "model.init_cache": lambda: model.init_cache(MCFG, 1, 8),
        "model.init_cache(audio)": lambda: model.init_cache(audio, 1, 8),
        "model.params_from_numpy": lambda: model.params_from_numpy(
            MCFG, jax.tree.map(np.asarray, _jax_params())),
        "model.params_from_numpy(audio)": lambda: model.params_from_numpy(
            audio, jax.tree.map(np.asarray, JM.init_params(
                j_reduced(j_get_arch("whisper-small")),
                jax.random.PRNGKey(0))[0])),
        "paged_kv.init": lambda: paged_kv.init(cfg),
    }


@pytest.mark.parametrize("name", sorted(_defaults()))
def test_entry_points_default_to_the_card(name):
    """The slice's entry points resolve ``device=None`` to the card: with
    none they raise, they never build on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        _defaults()[name]()
