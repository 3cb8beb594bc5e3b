"""Kernels B1 (clock_update), B2 (msc_score), B3-B5 (the tier_compact
row movers select_gather_rows, scatter_rows, gather_rows), B6
(paged_attention), B7 (flash_attention), B8 (rwkv6_scan) and B9
(mamba_scan) of the port; on the card also the vlm and audio forwards
and a short vlm serve.

On the CPU: each wrapper takes its plain PyTorch version, held against
the JAX package's kernel wrappers (``backend="reference"`` and the Pallas
kernel in interpret mode) -- B1 bit-exact, B2 within rtol 1e-5 (the
tolerance of tests/test_kernels.py) with equal argmax; the movers' plain
versions are held to JAX in tests/test_torch_mirror.py; B6's and B7's
plain versions within atol 2e-5 in float32 and 2e-2 in bfloat16 of the
Pallas kernels in interpret mode (tests/test_kernels.py:28,51); B8's
within atol 1e-4 of JAX's ``wkv`` on both its backends
(tests/test_kernels.py:325); B9's within atol 1e-4 of JAX's
``selective_scan`` on both its backends (tests/test_kernels.py:340).
On a card (marker ``cuda``, skipped without one): each CUDA kernel held
against its plain version on the same inputs.  The machine with the card
has no JAX, so the JAX package is imported only inside the CPU tests; run
the card tests there with
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import tracker
from repro_torch.kernels.clock_update.ops import tracker_access
from repro_torch.kernels.msc_score.ops import score_candidates
from torch_parity import assert_bit_equal, t


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")


# ----------------------------------------------------------- clock update

@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
@pytest.mark.parametrize("cap,batch,tile", [
    (1024, 256, 256), (512, 128, 64), (1021, 256, None), (331, 64, None)])
def test_clock_update_plain_vs_jax(cap, batch, tile, jax_backend):
    """The sweeps of tests/test_kernels.py:82-100 through the port's
    wrapper (backend "cuda" on CPU tensors takes the plain version)."""
    import jax.numpy as jnp
    from repro.core import tracker as jtracker
    from repro.kernels.clock_update.ops import tracker_access as j_access
    rng = np.random.default_rng([cap, batch, tile or 0,
                                 jax_backend == "pallas"])
    before = kernels.LAUNCHES["clock_update"]
    js, ts = jtracker.init(cap), tracker.init(cap, "cpu")
    for _ in range(4):
        keys = rng.integers(0, 4 * cap, batch).astype(np.int32)
        locs = rng.integers(0, 2, batch).astype(np.int8)
        valid = rng.random(batch) > 0.1
        kw = {"tile": tile} if jax_backend == "pallas" else {}
        js = j_access(js, *map(jnp.asarray, (keys, locs, valid)),
                      backend=jax_backend, **kw)
        ts = tracker_access(ts, t(keys), t(locs), t(valid), backend="cuda")
        for a, b in zip(js, ts):
            assert_bit_equal(np.asarray(a), b.numpy())
    assert kernels.LAUNCHES["clock_update"] == before   # plain on CPU


@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
@pytest.mark.parametrize("span", [2, 4])
@pytest.mark.parametrize("cap,batch", [(331, 700), (331, 4096), (1021, 700),
                                       (1021, 4096)])
def test_clock_update_passes_vs_jax(cap, batch, span, jax_backend):
    """The kernel's claim/mark/apply passes in plain PyTorch
    (``clock_update_passes``) bit-exact to the JAX package's
    ``tracker_access`` (both its backends; the Pallas kernel in
    interpret mode) and to ``tracker.access_batched``, on batches
    whose keys come from a range of ``span`` x the batch over a small
    table: most slots take several accesses and many winners repeat, so
    "a duplicate of the winner in its slot" is held to "the key occurs
    >= 2 times" where no card is."""
    import jax.numpy as jnp
    from repro.core import tracker as jtracker
    from repro.kernels.clock_update.ops import tracker_access as j_access
    from repro_torch.kernels.clock_update.ref import clock_update_passes
    rng = np.random.default_rng([cap, batch, span, jax_backend == "pallas"])
    js, ts = jtracker.init(cap), tracker.init(cap, "cpu")
    dups = 0
    for _ in range(4):
        keys = rng.integers(0, span * batch, batch).astype(np.int32)
        locs = rng.integers(0, 2, batch).astype(np.int8)
        valid = rng.random(batch) > 0.1
        js = j_access(js, *map(jnp.asarray, (keys, locs, valid)),
                      backend=jax_backend)
        plain = tracker.access_batched(ts, t(keys), t(locs), t(valid))
        ts = clock_update_passes(ts, t(keys), t(locs), t(valid))
        for a, b, c in zip(js, ts, plain):
            assert_bit_equal(np.asarray(a), b.numpy())
            assert torch.equal(b, c)
        dups += int((np.unique(keys[valid], return_counts=True)[1] > 1)
                    .sum())
    assert dups > batch // 8       # the batches repeat keys


def _msc_inputs(rng, nb=64, k=8, width=8192):
    """Candidates and bucket statistics as the engine keeps them: the
    tracked fast keys of a bucket (the clock histogram row) are a subset
    of its fast keys.  (Rows whose histogram exceeds the bucket's count
    push the pinned fraction p towards its 0.999 clip, where 1 / (1 - p)
    magnifies any change in the order of the sums: see
    ``test_msc_score_kernel_near_pin_clip_on_card``.)"""
    lo = rng.integers(0, width // 2, k).astype(np.int32)
    hi = (lo + rng.integers(1, width // 4, k)).astype(np.int32)
    hist = rng.integers(0, 30, (nb, 4)).astype(np.int32)
    return [lo, hi, rng.integers(0, 500, k).astype(np.int32),
            (hist.sum(1) + rng.integers(0, 100, nb)).astype(np.int32),
            rng.integers(0, 400, nb).astype(np.int32),
            rng.integers(0, 50, nb).astype(np.int32), hist,
            np.asarray([0.1, 0.4, 0.9, 1.0], np.float32)], width // nb


@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
@pytest.mark.parametrize("nb,k", [(64, 8), (256, 8), (16, 4)])
def test_msc_score_plain_vs_jax(nb, k, jax_backend):
    import jax.numpy as jnp
    from repro.kernels.msc_score.ops import score_candidates as j_score
    rng = np.random.default_rng([nb, k, jax_backend == "pallas"])
    for _ in range(8):
        args, bw = _msc_inputs(rng, nb, k, width=nb * 37)
        want = np.asarray(j_score(*map(jnp.asarray, args), bucket_width=bw,
                                  backend=jax_backend))
        got, best = score_candidates(*map(t, args), bucket_width=bw,
                                     backend="cuda")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
        assert int(best) == int(np.argmax(want))


def _tie_candidates(rng, args, want):
    """Copy the best candidate's (lo, hi, t_f) over one candidate before it
    and one after it (where there are such): exact ties at the maximum."""
    k, m = args[0].shape[0], int(np.argmax(want))
    dup = [rng.integers(0, m)] if m > 0 else []
    dup += [rng.integers(m + 1, k)] if m + 1 < k else []
    for a in args[:3]:
        a[dup] = a[m]
    return args


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("nb,k", [(64, 8), (256, 8), (16, 4), (64, 32)])
def test_msc_pick_plain_vs_jax(nb, k, ties):
    """``pick_best_ref``, the kernel's butterfly pick in plain PyTorch,
    equal to ``jnp.argmax`` of the JAX package's scores; with ``ties``
    the best candidate is copied over others before and after it, so the
    maximum occurs several times and the first index must win."""
    import jax.numpy as jnp
    from repro.kernels.msc_score.ops import score_candidates as j_score
    from repro_torch.kernels.msc_score.ref import pick_best_ref
    rng = np.random.default_rng([nb, k, ties, 41])
    n_tied = 0
    for _ in range(8):
        args, bw = _msc_inputs(rng, nb, k, width=nb * 37)
        score = lambda a: np.asarray(j_score(*map(jnp.asarray, a),
                                             bucket_width=bw,
                                             backend="reference"))
        want = score(args)
        if ties:
            want = score(_tie_candidates(rng, args, want))
            n_tied += int((want == want.max()).sum() > 1)
        got = pick_best_ref(t(want))
        assert got.dtype == torch.int64 and got.dim() == 0
        assert int(got) == int(jnp.argmax(jnp.asarray(want)))
    assert n_tied == (8 if ties else 0)


@pytest.mark.parametrize("scores", [
    [1.0], [0.0] * 8, [2.0, 5.0, 5.0, 1.0], [5.0, 1.0, 5.0, 5.0],
    [0.0, float("nan"), 3.0, float("nan")], [float("-inf")] * 3,
    list(range(31, -1, -1)), [1.0] * 31 + [2.0]])
def test_msc_pick_plain_vs_jnp_argmax(scores):
    """``pick_best_ref`` against ``jnp.argmax`` on score vectors at the
    edges of its order: one candidate, all equal, ties at either end,
    NaN, -inf everywhere (below no padding lane), 32 candidates."""
    import jax.numpy as jnp
    from repro_torch.kernels.msc_score.ref import pick_best_ref
    x = np.asarray(scores, np.float32)
    assert int(pick_best_ref(t(x))) == int(jnp.argmax(jnp.asarray(x)))


# ---------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("cap,batch", [(1 << 20, 4096), (1021, 256),
                                       (331, 700), (1021, 4096)])
def test_clock_update_kernel_on_card(cap, batch):
    """B1 bit-exact to ``access_batched`` on the card; (1021, 4096) puts
    many duplicates behind most slot winners."""
    _needs_card()
    from repro_torch.kernels.clock_update.ops import clock_update
    dev = torch.device("cuda")
    rng = np.random.default_rng([cap, batch])
    state = tracker.init(cap, dev)
    n0 = kernels.LAUNCHES["clock_update"]
    for i in range(6):
        keys = torch.from_numpy(rng.integers(0, 2 * cap, batch)
                                .astype(np.int32)).to(dev)
        locs = torch.from_numpy(rng.integers(0, 2, batch)
                                .astype(np.int8)).to(dev)
        valid = torch.from_numpy(rng.random(batch) > 0.1).to(dev)
        want = tracker.access_batched(state, keys, locs, valid)
        got = clock_update(tracker.TrackerState(*[x.clone() for x in state]),
                           keys, locs, valid)
        torch.cuda.synchronize()
        for a, b in zip(want, got):
            assert torch.equal(a, b)
        state = want
    assert kernels.LAUNCHES["clock_update"] == n0 + 6


@pytest.mark.cuda
@pytest.mark.parametrize("nb,k", [(256, 8), (64, 32)])
def test_msc_score_kernel_on_card(nb, k):
    _needs_card()
    from repro_torch.kernels.msc_score.ops import msc_scores
    from repro_torch.kernels.msc_score.ref import msc_scores_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng([nb, k])
    for _ in range(16):
        args, bw = _msc_inputs(rng, nb, k, width=nb * 391)
        cargs = [t(a).cuda() for a in args]
        want = msc_scores_ref(*cargs, bucket_width=bw)
        got, best = msc_scores(*cargs, bucket_width=bw)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5)
        assert best.dtype == torch.int64 and best.dim() == 0
        assert int(best) == int(torch.argmax(want))


def _msc_inputs_near_clip(rng, nb, k, width):
    """Bucket counts just around the pinned mass ``hist @ probs``, so the
    histogram rows exceed the bucket's fast count (a tracker entry whose
    location is fast may be stale) and each candidate's pinned fraction
    p lands within 1% of its 0.999 clip, on either side."""
    lo = rng.integers(0, width // 2, k).astype(np.int32)
    hi = (lo + rng.integers(1, width // 4, k)).astype(np.int32)
    hist = rng.integers(0, 30, (nb, 4)).astype(np.int32)
    probs = np.asarray([0.1, 0.4, 0.9, 1.0], np.float32)
    fast = np.rint(hist @ probs.astype(np.float64)
                   * rng.uniform(0.99, 1.012, nb)).astype(np.int32)
    return [lo, hi, rng.integers(0, 500, k).astype(np.int32), fast,
            rng.integers(0, 400, nb).astype(np.int32),
            rng.integers(0, 50, nb).astype(np.int32), hist, probs], \
        width // nb


def _pinned_fraction(args, bw):
    """Each candidate's pinned fraction p, in float64 (clipped as the
    kernel clips it)."""
    lo, hi, _, fast, _, _, hist, probs = [np.asarray(a, np.float64)
                                          for a in args]
    edges = np.arange(fast.shape[0], dtype=np.float64) * bw
    w = np.clip((np.minimum(edges + bw, hi[:, None])
                 - np.maximum(edges, lo[:, None])) / bw, 0.0, 1.0)
    return np.clip((w @ (hist @ probs)) / np.maximum(w @ fast, 1.0),
                   0.0, 0.999)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,k", [(256, 8), (64, 32)])
def test_msc_score_kernel_near_pin_clip_on_card(nb, k):
    """Near p = 0.999 the cost's factor 1 / (1 - p) magnifies the
    rounding of the sums behind p by p / (1 - p); the kernel sums in
    another order than the plain version.  Bound: the rtol 1e-5 of the
    other cases plus the worst-case rounding of the two nb-term float32
    sums of p (2 * nb * 2**-24, relative) times p / (1 - p).  The chosen
    candidate must be the same."""
    _needs_card()
    from repro_torch.kernels.msc_score.ops import msc_scores
    from repro_torch.kernels.msc_score.ref import msc_scores_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(17)
    near = 0
    for _ in range(16):
        args, bw = _msc_inputs_near_clip(rng, nb, k, width=nb * 391)
        p = _pinned_fraction(args, bw)
        near += int(((p > 0.99) & (p < 0.999)).sum())
        cargs = [t(a).cuda() for a in args]
        want = msc_scores_ref(*cargs, bucket_width=bw).cpu().numpy()
        got, best = msc_scores(*cargs, bucket_width=bw)
        got = got.cpu().numpy()
        rtol = 1e-5 + 2 * nb * 2.0**-24 * p / (1 - p)
        assert (np.abs(got - want) <= rtol * np.abs(want)).all()
        assert int(best) == int(np.argmax(want))
    assert near > 0          # the inputs reach the magnified regime


def _cuda_activities(fn, calls: int) -> tuple:
    """CUDA activities (kernels, copies, fills) per call of ``fn`` under
    the profiler, their names, and the CPU operators the calls ran."""
    from torch.profiler import ProfilerActivity, profile
    # the first trace warms CUPTI up; a later one that holds no device
    # activity at all (CUPTI delivered no record) is taken again
    for attempt in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        dev = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name != "Command Buffer Full"]
        if attempt > 0 and dev:
            break
    return len(dev) / calls, sorted(e.name[:60] for e in dev), \
        {e.name for e in events}


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("nb,k", [(256, 8), (64, 32), (16, 1)])
def test_msc_score_pick_on_card(nb, k, ties):
    """B2's own pick: ``best`` equal to the plain argmax of the plain
    scores on tie-free draws; with the best candidate copied over others
    (exact ties, the kernel's scores of equal candidates bit-equal), the
    first index among them, as ``pick_best_ref`` and ``torch.argmax``
    give it on the kernel's scores.  One CUDA activity per
    ``score_candidates`` call (the kernel: no argmax, no copy)."""
    _needs_card()
    from repro_torch.kernels.msc_score.ref import msc_scores_ref, pick_best_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng([nb, k, ties, 7])
    n0 = kernels.LAUNCHES["msc_score"]
    for _ in range(16):
        args, bw = _msc_inputs(rng, nb, k, width=nb * 391)
        if ties and k > 1:
            plain = msc_scores_ref(*map(t, args), bucket_width=bw).numpy()
            args = _tie_candidates(rng, args, plain)
        cargs = [t(a).cuda() for a in args]
        got, best = score_candidates(*cargs, bucket_width=bw)
        want = msc_scores_ref(*cargs, bucket_width=bw)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5)
        if ties and k > 1:
            top = got == got.max()
            assert int(top.sum()) >= 2
            assert int(best) == int(top.nonzero()[0, 0])
        assert int(best) == int(torch.argmax(got)) == int(pick_best_ref(got))
        if not ties:
            assert int(best) == int(torch.argmax(want))
    assert kernels.LAUNCHES["msc_score"] == n0 + 16
    per_call, names, _ = _cuda_activities(
        lambda: score_candidates(*cargs, bucket_width=bw), 8)
    assert per_call == 1, names


@pytest.mark.cuda
def test_select_range_launches_no_argmax_on_card():
    """``select_range`` on backend "cuda" takes ``best`` from B2 (one
    launch) and runs no ``argmax``; on "reference" it runs the plain
    scorer and ``argmax``; the two picks agree."""
    _needs_card()
    from repro_torch.configs.prismdb_kv import paper_tier_config
    from repro_torch.core import msc, prng, tiers
    cfg = paper_tier_config(1)
    state = tiers.init(cfg, "cuda")
    key = prng.PRNGKey(3)
    n0 = kernels.LAUNCHES["msc_score"]
    _, _, best = msc.select_range(state, cfg, key, backend="cuda")
    _, _, ops_cuda = _cuda_activities(
        lambda: msc.select_range(state, cfg, key, backend="cuda"), 1)
    _, _, want = msc.select_range(state, cfg, key, backend="reference")
    _, _, ops_ref = _cuda_activities(
        lambda: msc.select_range(state, cfg, key, backend="reference"), 1)
    assert kernels.LAUNCHES["msc_score"] == n0 + 1 + 2
    assert "aten::argmax" not in ops_cuda and "aten::argmax" in ops_ref
    assert int(best) == int(want)


def test_wrappers_refuse_cpu_tensors():
    """The kernel entry points validate before they build or launch: a
    CPU tensor is refused, never silently taken by the plain version."""
    from repro_torch.kernels.clock_update.ops import clock_update
    from repro_torch.kernels.msc_score.ops import msc_scores
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError):
        clock_update(tracker.init(16, "cpu"),
                     torch.zeros(4, dtype=torch.int32),
                     torch.zeros(4, dtype=torch.int8),
                     torch.ones(4, dtype=torch.bool))
    args, bw = _msc_inputs(np.random.default_rng(16), 16, 4)
    with pytest.raises(ValueError):
        msc_scores(*map(t, args), bucket_width=bw)
    assert kernels.LAUNCHES == before


# ------------------------------------------------------ tier_compact movers

def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _pools(rng, dev, w, dtype, offset):
    """A fast and a slow pool of random rows, optionally as views that
    start one row into a larger buffer (so the row addresses are only
    as aligned as the row width allows)."""
    dt = getattr(torch, dtype)
    mk = lambda n: torch.from_numpy(rng.normal(size=(n + offset, w))
                                    .astype(np.float32)).to(dev, dt)[offset:]
    return mk(37), mk(301)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w", [2, 4, 8, 1152])
def test_tier_compact_kernels_on_card(w, dtype, offset):
    """B3, B4 and B5 against their plain versions, bit for bit: indices
    at both ends of each pool, out-of-range gather indices (clamped),
    invalid scatter rows left untouched, destinations whose old rows
    differ from the rows written there."""
    _needs_card()
    from repro_torch.kernels.tier_compact import ops, ref
    rng = np.random.default_rng(w * 10 + offset)
    dev = torch.device("cuda")
    fast, slow = _pools(rng, dev, w, dtype, offset)
    nf, ns, m = fast.shape[0], slow.shape[0], 200
    src_slow = rng.random(m) < 0.5
    idx = np.where(src_slow, rng.integers(0, ns, m), rng.integers(0, nf, m))
    idx[:4] = [0, nf - 1, 0, ns - 1]
    src_slow[:4] = [False, False, True, True]
    idx[4:6] = [-5, 10 * ns]                  # clamped like a JAX gather
    idx_t = torch.from_numpy(idx.astype(np.int32)).to(dev)
    sl_t = torch.from_numpy(src_slow).to(dev)
    n0 = dict(kernels.LAUNCHES)

    got = ops.select_gather_rows(fast, slow, sl_t, idx_t)
    want = ref.select_gather_rows_ref(fast, slow, sl_t, idx_t)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    got = ops.gather_rows(slow, idx_t)
    want = ref.gather_rows_ref(slow, idx_t)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))

    # scatter: unique destinations, both ends of the pool among them
    dst = np.concatenate([[0, ns - 1],
                          rng.permutation(np.arange(1, ns - 1))[:m - 2]])
    valid = rng.random(m) > 0.3
    rows = torch.from_numpy(rng.normal(size=(m, w)).astype(np.float32)) \
        .to(dev, slow.dtype)
    dst_t = torch.from_numpy(dst.astype(np.int32)).to(dev)
    v_t = torch.from_numpy(valid).to(dev)
    before = slow.clone()
    got = ops.scatter_rows(slow.clone(), dst_t, rows, v_t)
    want = ref.scatter_rows_ref(slow.clone(), dst_t, rows, v_t)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    written = torch.from_numpy(dst[valid]).long().to(dev)
    assert torch.equal(_bits(got[written]), _bits(rows[v_t]))
    assert not torch.equal(_bits(before[written]), _bits(rows[v_t]))
    untouched = torch.ones(ns, dtype=torch.bool, device=dev)
    untouched[written] = False
    assert torch.equal(_bits(got[untouched]), _bits(before[untouched]))
    assert kernels.LAUNCHES["select_gather_rows"] == \
        n0["select_gather_rows"] + 1
    assert kernels.LAUNCHES["gather_rows"] == n0["gather_rows"] + 1
    assert kernels.LAUNCHES["scatter_rows"] == n0["scatter_rows"] + 1


@pytest.mark.cuda
def test_apply_movement_rows_kernels_on_card():
    """The Movement replay through the kernels equals the plain movers on
    an embedding-width Movement (promotion sources recycled by the run
    write: the order of gathers and scatters matters)."""
    _needs_card()
    from repro_torch.core.compaction import Movement
    from repro_torch.kernels.tier_compact.ops import apply_movement_rows
    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    fast, slow = _pools(rng, dev, 1152, "float32", 0)
    nf, ns, m = fast.shape[0], slow.shape[0], 64
    p_valid = rng.random(m) < 0.4
    p_valid[nf:] = False
    m_dst = rng.permutation(ns)[:m]
    mv = Movement(
        m_src_tier=torch.from_numpy(rng.integers(0, 2, m).astype(np.int32)),
        m_src_slot=torch.from_numpy(rng.integers(0, ns, m).astype(np.int32)),
        m_dst_slot=torch.from_numpy(m_dst.astype(np.int32)),
        m_valid=torch.from_numpy(rng.random(m) > 0.2),
        p_src_slot=torch.from_numpy(np.where(p_valid, m_dst, -1)
                                    .astype(np.int32)),
        p_dst_slot=torch.from_numpy(np.where(
            p_valid, np.resize(rng.permutation(nf), m), -1).astype(np.int32)),
        p_valid=torch.from_numpy(p_valid))
    mv = mv._replace(**{k: v.to(dev) for k, v in mv._asdict().items()
                        if torch.is_tensor(v)})
    want = apply_movement_rows(fast.clone(), slow.clone(), mv,
                               backend="reference")
    got = apply_movement_rows(fast.clone(), slow.clone(), mv, backend="cuda")
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert torch.equal(_bits(a), _bits(b))


def test_mover_wrappers_refuse_cpu_tensors():
    """The tier_compact launch wrappers validate before they build or
    launch: CPU tensors are refused, never taken by the plain versions."""
    from repro_torch.kernels.tier_compact import ops
    before = dict(kernels.LAUNCHES)
    pool = torch.zeros((8, 4))
    idx = torch.zeros(3, dtype=torch.int32)
    flag = torch.ones(3, dtype=torch.bool)
    with pytest.raises(ValueError):
        ops.gather_rows(pool, idx)
    with pytest.raises(ValueError):
        ops.select_gather_rows(pool, pool, flag, idx)
    with pytest.raises(ValueError):
        ops.scatter_rows(pool, idx, torch.zeros((3, 4)), flag)
    assert kernels.LAUNCHES == before


# ------------------------------------------------ flash / paged attention

FLASH_SHAPES = [            # tests/test_kernels.py:12-18
    (2, 4, 2, 64, 64, 32, True, -1),
    (1, 8, 2, 33, 33, 64, True, -1),
    (2, 2, 2, 17, 80, 16, True, 16),
    (1, 4, 1, 5, 5, 128, False, -1),
    (1, 4, 4, 48, 48, 8, True, 8),
]
PAGED_SHAPES = [            # tests/test_kernels.py:36-39
    (2, 4, 2, 32, 16, 8, 4),
    (1, 8, 8, 64, 8, 4, 3),
    (3, 6, 2, 128, 32, 16, 8),
]


def _qkv(rng, b, hq, hkv, sq, sk, d):
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,win", FLASH_SHAPES)
def test_flash_attention_plain_vs_jax(b, hq, hkv, sq, sk, d, causal, win,
                                      dtype):
    """``mha`` on backend "cuda" with CPU tensors (B7's plain version) vs
    the JAX package's ``mha(backend="pallas")`` in interpret mode on the
    same inputs (bf16 inputs rounded the same way on both sides)."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ops import mha as j_mha
    from repro_torch.kernels.flash_attention.ops import mha
    rng = np.random.default_rng(b * 1000 + sq + d)
    arrs = _qkv(rng, b, hq, hkv, sq, sk, d)
    jdt = getattr(jnp, dtype)
    want = j_mha(*(jnp.asarray(a, jdt) for a in arrs), causal=causal,
                 window=win, backend="pallas", block_q=32, block_k=32)
    before = kernels.LAUNCHES["flash_attention"]
    got = mha(*(t(a).to(getattr(torch, dtype)) for a in arrs),
              causal=causal, window=win, backend="cuda")
    assert kernels.LAUNCHES["flash_attention"] == before   # plain on CPU
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,d,P,T,K", PAGED_SHAPES)
def test_paged_attention_plain_vs_jax(b, hq, hkv, d, P, T, K, pool_dtype):
    """``decode_attention`` on backend "cuda" with CPU tensors (B6's
    plain version) vs the JAX package's ``decode_attention(backend=
    "pallas")`` in interpret mode (float32 queries; bf16 pools are
    widened alike on both sides: atol 2e-5)."""
    import jax.numpy as jnp
    from repro.kernels.paged_attention.ops import decode_attention as j_dec
    from repro_torch.kernels.paged_attention.ops import decode_attention
    rng = np.random.default_rng(P * 100 + K)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    kp = rng.normal(size=(P, T, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(P, T, hkv, d)).astype(np.float32)
    bt = rng.integers(-1, P, size=(b, K)).astype(np.int32)
    tm = rng.random((b, K, T)) > 0.2
    bt[:, 0], tm[:, 0, 0] = 0, True
    jdt = getattr(jnp, pool_dtype)
    want = j_dec(jnp.asarray(q), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
                 jnp.asarray(bt), jnp.asarray(tm), backend="pallas")
    tdt = getattr(torch, pool_dtype)
    before = kernels.LAUNCHES["paged_attention"]
    got = decode_attention(t(q), t(kp).to(tdt), t(vp).to(tdt), t(bt), t(tm),
                           backend="cuda")
    assert kernels.LAUNCHES["paged_attention"] == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_paged_attention_plain_sees_nothing_gives_zero():
    """A sequence whose pages are all absent or masked gives 0, as the
    JAX package's plain version does."""
    import jax.numpy as jnp
    from repro.kernels.paged_attention.ref import paged_attention_ref as j_ref
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 4, 16)).astype(np.float32)
    kp = rng.normal(size=(6, 4, 2, 16)).astype(np.float32)
    bt = np.array([[-1, -1, -1], [2, -1, 5]], np.int32)
    tm = np.ones((2, 3, 4), bool)
    tm[1] = False
    got = paged_attention_ref(t(q), t(kp), t(kp), t(bt), t(tm)).numpy()
    want = np.asarray(j_ref(*map(jnp.asarray, (q, kp, kp, bt, tm))))
    assert np.all(got == 0) and np.all(want == 0)


MERGE_CASES = {             # [B, Hq, Hkv, D, P, T, K]
    "paged0": PAGED_SHAPES[0], "paged1": PAGED_SHAPES[1],
    "paged2": PAGED_SHAPES[2], "group_sees_nothing": (3, 6, 2, 32, 24, 8, 13),
    "nothing_seen": (3, 6, 2, 32, 24, 8, 13),
    "k_below_groups": (3, 6, 2, 32, 24, 8, 3)}


@pytest.mark.parametrize("groups", [1, 4, 8])
@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_paged_attention_merge_plain_vs_jax(case, groups):
    """``merge_partials_ref`` (B6's split of the page walk over W warps,
    page j to warp j % W, each with its own online softmax, merged once)
    against ``paged_attention_ref`` and the JAX package's
    ``decode_attention(backend="pallas")`` in interpret mode, atol 2e-5
    (float32), for W 1, 4 and 8: on PAGED_SHAPES; with one group that
    sees no page (absent pages; and, for a second sequence, a group whose
    tokens are all masked); with every page absent (0, no NaN); and with
    fewer pages than groups."""
    import jax.numpy as jnp
    from repro.kernels.paged_attention.ops import decode_attention as j_dec
    from repro_torch.kernels.paged_attention.ref import (merge_partials_ref,
                                                         paged_attention_ref)
    b, hq, hkv, d, P, T, K = MERGE_CASES[case]
    rng = np.random.default_rng([groups, K, P, len(case)])
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    kp = rng.normal(size=(P, T, hkv, d)).astype(np.float32)
    vp = rng.normal(size=(P, T, hkv, d)).astype(np.float32)
    bt = rng.integers(-1, P, size=(b, K)).astype(np.int32)
    tm = rng.random((b, K, T)) > 0.2
    bt[:, 0], tm[:, 0, 0] = 0, True
    group = np.arange(K) % groups
    if case == "group_sees_nothing":
        bt[:, group == groups - 1 if groups > 1 else np.arange(K) >= K // 2] \
            = -1
        if groups > 1:
            tm[1, group == 0] = False
    elif case == "nothing_seen":
        bt[:] = -1
    want = np.asarray(j_dec(*map(jnp.asarray, (q, kp, vp, bt, tm)),
                            backend="pallas"))
    got = merge_partials_ref(t(q), t(kp), t(vp), t(bt), t(tm), groups)
    plain = paged_attention_ref(t(q), t(kp), t(vp), t(bt), t(tm))
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-5)
    if case == "nothing_seen":
        assert np.all(got.numpy() == 0) and np.all(want == 0)


def test_attention_wrappers_refuse_cpu_tensors():
    """The flash_attention and paged_attention launch wrappers validate
    before they build or launch: CPU tensors are refused."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import paged_attention
    before = dict(kernels.LAUNCHES)
    x = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError):
        flash_attention(x, x, x)
    with pytest.raises(ValueError):
        paged_attention(torch.zeros((1, 2, 8)), torch.zeros((3, 4, 2, 8)),
                        torch.zeros((3, 4, 2, 8)),
                        torch.zeros((1, 2), dtype=torch.int32),
                        torch.ones((1, 2, 4), dtype=torch.bool))
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,win", FLASH_SHAPES + [
    (1, 4, 1, 300, 300, 256, True, 64),      # gemma3: head dim 256, local
    (1, 4, 1, 130, 130, 256, True, -1),
    (2, 6, 2, 70, 70, 80, True, 33),         # head dim below its template
    (1, 3, 1, 9, 40, 128, True, 4),          # right-aligned short queries
    (1, 6, 2, 37, 37, 128, True, -1),        # 111 rows: not a multiple of 16
    (2, 4, 4, 50, 100, 64, True, 16),        # Sk off the 64-key tile
    (1, 5, 1, 23, 150, 80, False, -1),       # 115 rows, Sk 150, no mask
    (1, 2, 1, 70, 70, 256, True, -1),        # head dim 256, 140 rows
    (2, 8, 2, 200, 200, 256, True, 48),      # head dim 256, window, ragged
    (1, 2, 1, 33, 33, 20, True, -1),         # rows not 16-byte aligned
    (2, 12, 12, 1500, 1500, 64, False, -1),  # whisper-small's encoder:
                                             # 1,500 rows off the 64 tile
    (2, 12, 12, 448, 448, 64, True, -1),     # whisper-small's decoder
    (2, 12, 2, 2048, 2048, 128, True, -1),   # qwen2-vl-2b: GQA group 6
])
def test_flash_attention_kernel_on_card(b, hq, hkv, sq, sk, d, causal, win,
                                        dtype):
    """B7 against its plain version on the card (atol 2e-5 in float32,
    2e-2 in bfloat16), contiguous inputs and the model's transposed
    projections (strided, no copy)."""
    _needs_card()
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(b * 1000 + sq + d)
    dt = getattr(torch, dtype)
    q, k, v = (t(a).to("cuda", dt) for a in _qkv(rng, b, hq, hkv, sq, sk, d))
    # the same values laid out [B, S, H, D] and viewed as [B, H, S, D]
    qs, ks, vs = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    want = attention_ref(q, k, v, causal=causal, window=win)
    n0 = kernels.LAUNCHES["flash_attention"]
    for args in ((q, k, v), (qs, ks, vs)):
        got = flash_attention(*args, causal=causal, window=win)
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == "float32" else 2e-2
        assert got.dtype == dt and got.shape == q.shape
        assert float((got.float() - want.float()).abs().max()) <= tol
    assert kernels.LAUNCHES["flash_attention"] == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,win", [(64, 4), (128, -1), (256, 8)])
def test_flash_attention_row_sees_no_key_on_card(d, win, dtype):
    """More queries than keys, causal: the first Sq - Sk rows (qpos < 0)
    see no key and give 0 (the plain version gives NaN there); every
    other row within the tolerance of the plain version."""
    _needs_card()
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    sq, sk = 90, 20
    rng = np.random.default_rng([d, win + 1, dtype == "bfloat16"])
    dt = getattr(torch, dtype)
    q, k, v = (t(a).to("cuda", dt) for a in _qkv(rng, 2, 4, 2, sq, sk, d))
    got = flash_attention(q, k, v, causal=True, window=win).float()
    want = attention_ref(q, k, v, causal=True, window=win).float()
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert torch.all(got[:, :, :sq - sk] == 0)
    assert torch.isnan(want[:, :, :sq - sk]).all()
    assert float((got[:, :, sq - sk:] - want[:, :, sq - sk:]).abs().max()) \
        <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,win", [
    (1, 4, 1, 1100, 1100, 256, True, -1),    # causal: empty halves too
    (1, 4, 1, 1100, 1100, 256, True, 1000),  # window edges in both halves
    (1, 2, 1, 70, 1030, 128, False, -1),     # no mask, Sk off the tile
    (2, 6, 2, 300, 1200, 80, True, -1),      # head dim below its template
    (1, 4, 2, 1300, 1100, 64, True, -1),     # rows that see no key
])
def test_flash_attention_split_keys_on_card(b, hq, hkv, sq, sk, d, causal,
                                            win):
    """bf16 launches with few row tiles and long key ranges split each
    row tile's keys over two blocks, which merge their partial results:
    within 2e-2 of the plain version, and 0 where a row sees no key."""
    _needs_card()
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    dev = torch.device("cuda")
    assert ops._split(torch.bfloat16, b, hq, hkv, sq, sk, d, win, dev)[0] \
        == 2
    rng = np.random.default_rng([b, hq, sq, sk, d, win + 1])
    q, k, v = (t(a).to(dev, torch.bfloat16)
               for a in _qkv(rng, b, hq, hkv, sq, sk, d))
    for _ in range(2):   # the second call finds the counters reset
        got = ops.flash_attention(q, k, v, causal=causal, window=win).float()
        want = attention_ref(q, k, v, causal=causal, window=win).float()
        torch.cuda.synchronize()
        blind = max(0, sq - sk) if causal else 0
        assert torch.all(got[:, :, :blind] == 0)
        assert float((got[:, :, blind:] - want[:, :, blind:]).abs().max()) \
            <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d,causal,win", [(64, True, -1), (128, True, 48),
                                          (128, False, -1), (256, True, -1)])
def test_flash_attention_bf16_large_outputs_on_card(d, causal, win):
    """bf16 outputs of 4 to 8, from sharp scores over few keys, held at
    atol 2e-2 to the float32 result on the same (bf16) values, as the
    Pallas kernel computes it with P in float32: rounding the output
    takes up to 1.56e-2 there, so P itself must be kept to well under
    bf16's precision."""
    _needs_card()
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rng = np.random.default_rng([d, win + 1, causal])
    b, hq, hkv, sq, sk = 2, 4, 2, 128, 256
    q = t(2 * rng.standard_normal((b, hq, sq, d))).to("cuda", torch.bfloat16)
    k = t(2 * rng.standard_normal((b, hkv, sk, d))).to("cuda",
                                                       torch.bfloat16)
    v = t(4.5 + 3 * rng.random((b, hkv, sk, d))).to("cuda", torch.bfloat16)
    got = flash_attention(q, k, v, causal=causal, window=win).float()
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=win)
    torch.cuda.synchronize()
    assert float(want.min()) >= 4 and float(want.max()) < 8
    assert float((got - want).abs().max()) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,d,P,T,K", PAGED_SHAPES + [
    (16, 24, 8, 128, 128, 16, 16),           # the serve phase's shapes
    (2, 8, 2, 256, 9, 5, 6),
    (1, 6, 2, 36, 9, 5, 4),                  # bf16 rows not 16-byte words
    (2, 2, 1, 10, 5, 3, 2)])                 # no 16-byte words at all
def test_paged_attention_kernel_on_card(b, hq, hkv, d, P, T, K, pool_dtype,
                                        q_dtype):
    """B6 against its plain version on the card (atol 2e-5 for float32
    queries, 2e-2 for bf16), on contiguous pools and on one layer of
    slot-major [L, P, T, H, D] pools (pages L rows apart); a sequence
    that sees nothing gives 0.  D 36 (bf16) and D 10 take the kernel's
    scalar loads."""
    _needs_card()
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    rng = np.random.default_rng(P * 100 + K)
    pdt, qdt = getattr(torch, pool_dtype), getattr(torch, q_dtype)
    q = t(rng.normal(size=(b, hq, d)).astype(np.float32)).to("cuda", qdt)
    pools = t(rng.normal(size=(P, 3, 2, T, hkv, d)).astype(np.float32)) \
        .to("cuda", pdt)
    bt = rng.integers(-1, P, size=(b, K)).astype(np.int32)
    tm = rng.random((b, K, T)) > 0.2
    bt[-1] = -1                                # sees nothing
    bt = t(bt).cuda()
    tm = t(tm).cuda()
    n0 = kernels.LAUNCHES["paged_attention"]
    for kp, vp in ((pools[:, 0, 0].contiguous(), pools[:, 0, 1].contiguous()),
                   (pools[:, 1, 0], pools[:, 1, 1])):
        want = paged_attention_ref(q, kp, vp, bt, tm)
        got = paged_attention(q, kp, vp, bt, tm)
        torch.cuda.synchronize()
        tol = 2e-5 if q_dtype == "float32" else 2e-2
        assert got.dtype == qdt
        assert float((got.float() - want.float()).abs().max()) <= tol
        assert float(got[-1].float().abs().max()) == 0.0
    assert kernels.LAUNCHES["paged_attention"] == n0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 7, 64, "absent"])
def test_paged_attention_pages_on_card(k, pool_dtype, q_dtype):
    """B6 at the serve phase's G 3, D 128 and 16-token pages with one page
    a sequence, fewer pages than the block's 8 warps (7), 8 a warp (64),
    and every page of every sequence absent (output 0, no NaN), against
    its plain version (tolerances of
    ``test_paged_attention_kernel_on_card``)."""
    _needs_card()
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    b, hq, hkv, d, P, T = 3, 24, 8, 128, 80, 16
    K = 4 if k == "absent" else k
    rng = np.random.default_rng([K, pool_dtype == "float32",
                                 q_dtype == "float32"])
    pdt, qdt = getattr(torch, pool_dtype), getattr(torch, q_dtype)
    q = t(rng.normal(size=(b, hq, d)).astype(np.float32)).to("cuda", qdt)
    kp, vp = (t(rng.normal(size=(P, T, hkv, d)).astype(np.float32))
              .to("cuda", pdt) for _ in range(2))
    bt = rng.integers(-1, P, size=(b, K)).astype(np.int32)
    if k == "absent":
        bt[:] = -1
    tm = t(rng.random((b, K, T)) > 0.2).cuda()
    bt = t(bt).cuda()
    got = paged_attention(q, kp, vp, bt, tm)
    want = paged_attention_ref(q, kp, vp, bt, tm)
    torch.cuda.synchronize()
    assert got.dtype == qdt and bool(torch.isfinite(got.float()).all())
    tol = 2e-5 if q_dtype == "float32" else 2e-2
    assert float((got.float() - want.float()).abs().max()) <= tol
    if k == "absent":
        assert float(got.float().abs().max()) == 0.0


# ------------------------------------------------------------- rwkv6 scan

RWKV_SHAPES = [(2, 2, 37, 16), (1, 4, 64, 32)]     # tests/test_kernels.py:314


def _rwkv_inputs(rng, b, h, tt, d):
    """r, k, v normal, w in (0.4, 0.9), u normal, as
    tests/test_kernels.py:318-322 draws them."""
    return (rng.normal(size=(b, h, tt, d)).astype(np.float32),
            rng.normal(size=(b, h, tt, d)).astype(np.float32),
            rng.normal(size=(b, h, tt, d)).astype(np.float32),
            (rng.random((b, h, tt, d)) * 0.5 + 0.4).astype(np.float32),
            rng.normal(size=(h, d)).astype(np.float32))


@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
@pytest.mark.parametrize("b,h,tt,d", RWKV_SHAPES)
def test_rwkv6_scan_plain_vs_jax(b, h, tt, d, jax_backend):
    """``rwkv6_ref``, and ``wkv`` on backend "cuda" with CPU tensors (the
    plain version, no launch), against the JAX package's ``wkv`` on
    "reference" and on "pallas" (interpret mode, chunk 16): atol 1e-4."""
    import jax.numpy as jnp
    from repro.kernels.rwkv6_scan.ops import wkv as j_wkv
    from repro_torch.kernels.rwkv6_scan.ops import wkv
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_ref
    arrs = _rwkv_inputs(np.random.default_rng(b * 100 + tt), b, h, tt, d)
    kw = {"chunk": 16} if jax_backend == "pallas" else {}
    want = np.asarray(j_wkv(*map(jnp.asarray, arrs), backend=jax_backend,
                            **kw))
    before = kernels.LAUNCHES["rwkv6_scan"]
    for got in (rwkv6_ref(*map(t, arrs)), wkv(*map(t, arrs), backend="cuda")):
        assert got.dtype == torch.float32 and got.shape == (b, h, tt, d)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert kernels.LAUNCHES["rwkv6_scan"] == before      # plain on CPU


@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
@pytest.mark.parametrize("b,h,tt,d", RWKV_SHAPES + [(1, 2, 48, 64)])
def test_rwkv6_split_plain_vs_jax(b, h, tt, d, jax_backend):
    """``rwkv6_split_ref``, B8's summation in plain PyTorch (S before its
    update times r, plus v times the per-step dot beta = r . (u * k)),
    against the JAX package's ``wkv`` on "reference" and on "pallas"
    (interpret mode, chunk 16): atol 1e-4."""
    import jax.numpy as jnp
    from repro.kernels.rwkv6_scan.ops import wkv as j_wkv
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_split_ref
    arrs = _rwkv_inputs(np.random.default_rng([b, h, tt, d, 17]), b, h, tt,
                        d)
    kw = {"chunk": 16} if jax_backend == "pallas" else {}
    want = np.asarray(j_wkv(*map(jnp.asarray, arrs), backend=jax_backend,
                            **kw))
    got = rwkv6_split_ref(*map(t, arrs))
    assert got.dtype == torch.float32 and got.shape == (b, h, tt, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_rwkv6_scan_wrapper_refuses_cpu_tensors():
    """The rwkv6_scan launch wrapper validates before it builds or
    launches: CPU tensors are refused, never taken by the plain
    version."""
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
    before = dict(kernels.LAUNCHES)
    x = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError):
        rwkv6_scan(x, x, x, x, torch.zeros((2, 8)))
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,tt,d", RWKV_SHAPES + [
    (2, 64, 2048, 64),                       # rwkv6-7b's prefill shape
    (3, 5, 1, 64), (1, 3, 9, 40),            # one step; D off the 16 grid
    (2, 3, 19, 37)])                         # D odd: no float4 loads
def test_rwkv6_scan_kernel_on_card(b, h, tt, d):
    """B8 against its plain version on the card (atol 1e-4, the JAX
    package's tolerance for this kernel), on contiguous inputs and on
    ``time_mix``'s layout (values laid out [B, T, H, D], viewed as
    [B, H, T, D]: strided, no copy); ``wkv`` casts bf16 inputs to float32
    and returns r's dtype."""
    _needs_card()
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan, wkv
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_ref
    arrs = [t(a).cuda() for a in _rwkv_inputs(
        np.random.default_rng(b * 100 + tt), b, h, tt, d)]
    want = rwkv6_ref(*arrs)
    strided = [x.transpose(1, 2).contiguous().transpose(1, 2)
               for x in arrs[:4]] + [arrs[4]]
    n0 = kernels.LAUNCHES["rwkv6_scan"]
    for args in (arrs, strided):
        got = rwkv6_scan(*args)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-4
    assert kernels.LAUNCHES["rwkv6_scan"] == n0 + 2
    bf = [x.to(torch.bfloat16) for x in arrs]
    got = wkv(*bf, backend="cuda")
    assert got.dtype == torch.bfloat16
    want = rwkv6_ref(*bf)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * max(
        1.0, float(want.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,tt,d", [(2, 4, 70, 64), (1, 3, 9, 40)])
def test_rwkv6_scan_unaligned_on_card(b, h, tt, d):
    """B8 on r, k, w that start one float past a 16-byte boundary: the
    instance without float4 loads, bit-equal to the float4 instance on
    the same values and within atol 1e-4 of the plain version."""
    _needs_card()
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_ref
    arrs = [t(a).cuda() for a in _rwkv_inputs(
        np.random.default_rng([b, h, tt, d, 5]), b, h, tt, d)]
    shifted = []
    for x in arrs[:4]:
        buf = torch.empty(x.numel() + 1, device="cuda")
        buf[1:] = x.flatten()
        shifted.append(buf[1:].view(x.shape))
    got = rwkv6_scan(*shifted, arrs[4])
    aligned = rwkv6_scan(*arrs)
    torch.cuda.synchronize()
    assert shifted[0].data_ptr() % 16 != 0
    assert torch.equal(got, aligned)
    assert float((got - rwkv6_ref(*arrs)).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_rwkv6_forward_on_card():
    """Reduced rwkv6-7b on the card: ``forward`` on backend "cuda" (B8
    once per layer) against "reference" (the plain scan), atol 1e-4 on
    the logits with equal argmax, and a decode step continuing from the
    cuda forward's position 0 equal to the forward there."""
    _needs_card()
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.models import model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_arch("rwkv6-7b"))
    params = model.init_params(cfg, torch.Generator("cuda").manual_seed(3))
    gen = torch.Generator("cuda").manual_seed(4)
    for blk in params["blocks"]:
        u = blk["mixer"]["time_mix"]["u"]
        u.copy_(0.5 * torch.randn(u.shape, generator=gen, device="cuda"))
    toks = torch.randint(0, cfg.vocab, (2, 45), generator=gen, device="cuda")
    n0 = kernels.LAUNCHES["rwkv6_scan"]
    got, _ = model.forward(cfg, params, {"tokens": toks}, backend="cuda")
    assert kernels.LAUNCHES["rwkv6_scan"] == n0 + cfg.n_layers
    want, _ = model.forward(cfg, params, {"tokens": toks},
                            backend="reference")
    assert kernels.LAUNCHES["rwkv6_scan"] == n0 + cfg.n_layers
    assert float((got - want).abs().max()) <= 1e-4
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    cache = model.init_cache(cfg, 2, 45, torch.float32)
    lg, _ = model.decode_step(cfg, params, cache, toks[:, 0],
                              torch.zeros(2, dtype=torch.int32,
                                          device="cuda"))
    assert float((lg - got[:, 0]).abs().max()) <= 1e-4


# ------------------------------------------------------------- mamba scan

MAMBA_SHAPES = [(2, 29, 32, 8), (1, 64, 64, 16)]    # tests/test_kernels.py:327


def _mamba_inputs(rng, bb, tt, di, n):
    """x normal, dt in (0, 0.1), A in (-1, 0), B, C and D normal, as
    tests/test_kernels.py:331-336 draws them."""
    return (rng.normal(size=(bb, tt, di)).astype(np.float32),
            (rng.random((bb, tt, di)) * 0.1).astype(np.float32),
            (-rng.random((di, n))).astype(np.float32),
            rng.normal(size=(bb, tt, n)).astype(np.float32),
            rng.normal(size=(bb, tt, n)).astype(np.float32),
            rng.normal(size=(di,)).astype(np.float32))


@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
@pytest.mark.parametrize("bb,tt,di,n", MAMBA_SHAPES)
def test_mamba_scan_plain_vs_jax(bb, tt, di, n, jax_backend):
    """``mamba_ref``, and ``selective_scan`` on backend "cuda" with CPU
    tensors (the plain version, no launch), against the JAX package's
    ``selective_scan`` on "reference" and on "pallas" (interpret mode,
    block_d 16, chunk 16, as tests/test_kernels.py:338): atol 1e-4."""
    import jax.numpy as jnp
    from repro.kernels.mamba_scan.ops import selective_scan as j_scan
    from repro_torch.kernels.mamba_scan.ops import selective_scan
    from repro_torch.kernels.mamba_scan.ref import mamba_ref
    arrs = _mamba_inputs(np.random.default_rng(bb * 100 + tt), bb, tt, di,
                         n)
    kw = {"block_d": 16, "chunk": 16} if jax_backend == "pallas" else {}
    want = np.asarray(j_scan(*map(jnp.asarray, arrs), backend=jax_backend,
                             **kw))
    before = kernels.LAUNCHES["mamba_scan"]
    for got in (mamba_ref(*map(t, arrs)),
                selective_scan(*map(t, arrs), backend="cuda")):
        assert got.dtype == torch.float32 and got.shape == (bb, tt, di)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert kernels.LAUNCHES["mamba_scan"] == before       # plain on CPU


def test_mamba_scan_wrapper_refuses_cpu_tensors():
    """The mamba_scan launch wrapper validates before it builds or
    launches: CPU tensors are refused, never taken by the plain
    version."""
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    before = dict(kernels.LAUNCHES)
    x = torch.zeros((1, 4, 8))
    bc = torch.zeros((1, 4, 2))
    with pytest.raises(ValueError):
        mamba_scan(x, x, torch.zeros((8, 2)), bc, bc, torch.zeros(8))
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("bb,tt,di,n", MAMBA_SHAPES + [
    (2, 2048, 8192, 16),                     # jamba's prefill shape
    (3, 1, 256, 16),                         # one step
    (2, 37, 300, 16), (1, 45, 1000, 5)])     # T off the chunk, Di ragged
def test_mamba_scan_kernel_on_card(bb, tt, di, n):
    """B9 against its plain version on the card (atol 1e-4, the JAX
    package's tolerance for this kernel), with B and C contiguous and as
    ``mamba_layer`` passes them (column slices of one [Bb, T, r + 2N]
    projection: strided, no copy); ``selective_scan`` casts bf16 inputs
    to float32 and returns x's dtype."""
    _needs_card()
    from repro_torch.kernels.mamba_scan.ops import mamba_scan, selective_scan
    from repro_torch.kernels.mamba_scan.ref import mamba_ref
    arrs = [t(a).cuda() for a in _mamba_inputs(
        np.random.default_rng(bb * 100 + tt), bb, tt, di, n)]
    want = mamba_ref(*arrs)
    proj = torch.zeros((bb, tt, 3 + 2 * n), device="cuda")
    proj[..., 3:3 + n], proj[..., 3 + n:] = arrs[3], arrs[4]
    strided = arrs[:3] + [proj[..., 3:3 + n], proj[..., 3 + n:], arrs[5]]
    n0 = kernels.LAUNCHES["mamba_scan"]
    for args in (arrs, strided):
        got = mamba_scan(*args)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-4
    assert kernels.LAUNCHES["mamba_scan"] == n0 + 2
    bf = [x.to(torch.bfloat16) for x in arrs]
    got = selective_scan(*bf, backend="cuda")
    assert got.dtype == torch.bfloat16
    want = mamba_ref(*bf)
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * max(
        1.0, float(want.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 8, 16])
def test_mamba_scan_states_on_card(n):
    """B9 at every states-a-lane instance, a channel's N states split over
    two lanes (N 1, 3, 4, 8, 16: 1, 2, 2, 4 and 8 states a lane, states
    past N idle), at Di 45 (two warps of 16 channels and a partial one
    of 13) and T 37 (off the chunk), with B and C column slices at an
    odd offset of a projection whose row stride, 3 + 2N, is no multiple
    of 4: atol 1e-4 against the plain version."""
    _needs_card()
    from repro_torch.kernels.mamba_scan.ops import mamba_scan
    from repro_torch.kernels.mamba_scan.ref import mamba_ref
    bb, tt, di = 2, 37, 45
    arrs = [t(a).cuda() for a in _mamba_inputs(
        np.random.default_rng([n, di]), bb, tt, di, n)]
    want = mamba_ref(*arrs)
    proj = torch.zeros((bb, tt, 3 + 2 * n), device="cuda")
    proj[..., 3:3 + n], proj[..., 3 + n:] = arrs[3], arrs[4]
    bm, cm = proj[..., 3:3 + n], proj[..., 3 + n:]
    assert bm.stride(1) % 4 != 0 and cm.stride(1) % 4 != 0
    got = mamba_scan(arrs[0], arrs[1], arrs[2], bm, cm, arrs[5])
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_hybrid_forward_on_card():
    """Reduced jamba on the card: ``forward`` on backend "cuda" (B9 in the
    7 mamba layers, B7 in the attention layer) against "reference" (the
    plain scan and the masked softmax), atol 1e-4 on the logits with
    equal argmax, and at capacity_factor 8 a decode step from an empty
    cache equal to the forward's position 0."""
    _needs_card()
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.models import model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_arch("jamba-v0.1-52b")).replace(capacity_factor=8.0)
    params = model.init_params(cfg, torch.Generator("cuda").manual_seed(5))
    gen = torch.Generator("cuda").manual_seed(6)
    toks = torch.randint(0, cfg.vocab, (2, 45), generator=gen, device="cuda")
    n0 = dict(kernels.LAUNCHES)
    got, _ = model.forward(cfg, params, {"tokens": toks}, backend="cuda")
    assert kernels.LAUNCHES["mamba_scan"] == n0["mamba_scan"] + 7
    assert kernels.LAUNCHES["flash_attention"] == n0["flash_attention"] + 1
    want, _ = model.forward(cfg, params, {"tokens": toks},
                            backend="reference")
    assert kernels.LAUNCHES["mamba_scan"] == n0["mamba_scan"] + 7
    assert float((got - want).abs().max()) <= 1e-4
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    cache = model.init_cache(cfg, 2, 45, torch.float32)
    lg, _ = model.decode_step(cfg, params, cache, toks[:, 0],
                              torch.zeros(2, dtype=torch.int32,
                                          device="cuda"))
    assert float((lg - got[:, 0]).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_vlm_and_whisper_forward_on_card():
    """Reduced qwen2-vl (patch embeddings, stub M-RoPE positions) and
    reduced whisper on the card: ``forward`` on backend "cuda" (B7 in
    every attention layer, whisper's encoder layers non-causal) against
    "reference", atol 1e-4 on the logits with equal argmax."""
    _needs_card()
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.models import model
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(7)
    for name in ("qwen2-vl-2b", "whisper-small"):
        cfg = reduced(get_arch(name))
        params = model.init_params(cfg, torch.Generator("cuda").manual_seed(8))
        toks = torch.randint(0, cfg.vocab, (2, 45), generator=gen,
                             device="cuda")
        if cfg.family == "audio":
            batch = {"tokens": toks, "enc_embeds": 0.02 * torch.randn(
                (2, cfg.enc_seq, cfg.d_model), generator=gen, device="cuda")}
            n_attn = cfg.enc_layers + cfg.n_layers
        else:
            tt = torch.arange(45, device="cuda")
            batch = {"embeds": 0.02 * torch.randn(
                (2, 45, cfg.d_model), generator=gen, device="cuda"),
                "positions": torch.stack([tt, tt % 7, tt % 5], -1)[None]
                .expand(2, 45, 3)}
            n_attn = cfg.n_layers
        n0 = kernels.LAUNCHES["flash_attention"]
        got, _ = model.forward(cfg, params, batch, backend="cuda")
        assert kernels.LAUNCHES["flash_attention"] == n0 + n_attn, name
        want, _ = model.forward(cfg, params, batch, backend="reference")
        assert float((got - want).abs().max()) <= 1e-4, name
        assert torch.equal(got.argmax(-1), want.argmax(-1)), name


@pytest.mark.cuda
def test_vlm_serve_on_card():
    """A short ``ServeEngine`` run of reduced qwen2-vl on the card, 4
    requests of 40 + 8 tokens through a fast pool that holds fewer pages
    than are live: backend "cuda" (B1-B5 launch) and "reference" give the
    same tokens, every request retires, pages are demoted."""
    _needs_card()
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.core.paged_kv import PagedKVConfig
    from repro_torch.models import model
    from repro_torch.serve.engine import Request, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_arch("qwen2-vl-2b"))
    params = model.init_params(cfg, torch.Generator("cuda").manual_seed(9))
    kv = PagedKVConfig(n_layers=cfg.n_layers, kv_heads=cfg.n_kv_heads,
                       head_dim=cfg.head_dim, page_tokens=4, fast_pages=16,
                       slow_pages=1024, max_seqs=4, max_pages_per_seq=64,
                       topk_pages=4, recent_pages=2, dtype="bfloat16")
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, cfg.vocab, 40).tolist() for _ in range(4)]
    outs = {}
    for backend in ("cuda", "reference"):
        eng = ServeEngine(cfg, kv, params, backend=backend)
        reqs = [Request(rid=i, prompt=p, max_new=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        kernels.reset_launches()
        eng.run(max_ticks=400)
        assert all(len(r.out) == 8 for r in reqs)
        assert eng.counters["demoted"] > 0
        launched = {k for k, n in kernels.LAUNCHES.items() if n}
        want = {"clock_update", "msc_score", "select_gather_rows",
                "scatter_rows", "gather_rows"} if backend == "cuda" else set()
        assert launched == want, backend
        outs[backend] = [r.out for r in reqs]
    assert outs["cuda"] == outs["reference"]


# ----------------------------------------------------- N-tier storage plane

_CFG3_KW = dict(key_space=1 << 11, fast_slots=128, slow_slots=1 << 10,
                value_width=2, max_runs=32, run_size=64,
                bloom_bits_per_run=1 << 12, tracker_slots=1 << 9,
                n_buckets=32, pin_threshold=0.1,
                tier_slots=(128, 256, 1 << 10))


@pytest.mark.cuda
@pytest.mark.parametrize("quantum", [0, 3])
def test_three_tier_workload_on_card(quantum):
    """tests/test_tier_list.py's 3-tier config through ``run_workload`` on
    the card, backend "cuda" (B1, B2; B3 and B4 at quantum 3), against
    backend "reference" on the CPU: StepStats, counters and every tier
    leaf equal, both boundaries compacted."""
    _needs_card()
    from repro_torch import workloads as W
    from repro_torch.core import engine
    from repro_torch.core.db import PrismDB
    from repro_torch.core.tiers import TierConfig
    cfg = TierConfig(**_CFG3_KW)
    rng = np.random.default_rng(0)
    pre = [rng.integers(0, cfg.key_space, 100).astype(np.int32)
           for _ in range(12)]
    runs = {}
    kernels.reset_launches()
    for backend, device in (("cuda", "cuda"), ("reference", "cpu")):
        db = PrismDB(cfg, seed=3, backend=backend, device=device,
                     compaction_quantum=quantum)
        for k in pre:
            db.put(k)
        db.reset_workload(seed=1)
        runs[backend] = (db, db.run_workload(W.ycsb("A"), 16, 64))
    (dc, sc), (dr, sr) = runs["cuda"], runs["reference"]
    for x, y in zip(sc, sr):
        assert torch.equal(x.cpu(), y)
    assert dc.counters == dr.counters
    assert min(dc.counters["comp_by_boundary"]) > 0
    a = engine.state_to_numpy(dc.estate.tier)
    b = engine.state_to_numpy(dr.estate.tier)
    from torch_parity import leaves
    for (p, x), (_, y) in zip(leaves(a), leaves(b)):
        assert_bit_equal(x, y, p)
    path = ["clock_update", "msc_score"] + (
        ["select_gather_rows", "scatter_rows"] if quantum else [])
    for name in path:
        assert kernels.LAUNCHES[name] > 0, name


@pytest.mark.cuda
def test_apply_movement_boundary_on_card():
    """A deep merge's Movement (``compact_boundary`` at boundary 1) and a
    slab merge's (``compact_once``) replayed on per-tier row pools on the
    card through B3, B4 and B5, bit-equal to the plain movers on the
    same pools."""
    _needs_card()
    from repro_torch.core import compaction, engine, prng
    from repro_torch.core.db import PrismDB
    from repro_torch.core.tiers import TierConfig
    from repro_torch.kernels.tier_compact.ops import apply_movement_boundary
    cfg = TierConfig(**_CFG3_KW)
    db = PrismDB(cfg, seed=3, device="cuda")
    rng = np.random.default_rng(1)
    for _ in range(12):
        db.put(rng.integers(0, cfg.key_space, 100).astype(np.int32))
    mvs = [(1, compaction.compact_boundary(engine.dealias(db.estate.tier),
                                           cfg, 1, with_movement=True)[2]),
           (0, compaction.compact_once(engine.dealias(db.estate.tier), cfg,
                                       prng.PRNGKey(5),
                                       with_movement=True)[2])]
    for b, mv in mvs:
        assert int(mv.m_valid.sum()) > 0
        pools = [t(rng.standard_normal((n, 5)).astype(np.float32))
                 for n in cfg.tier_sizes]
        want = apply_movement_boundary([p.clone() for p in pools], mv._replace(
            **{f: getattr(mv, f).cpu() for f in mv._fields}), b,
            backend="reference")
        n0 = kernels.LAUNCHES["scatter_rows"]
        got = apply_movement_boundary([p.cuda() for p in pools], mv, b,
                                      backend="cuda")
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["scatter_rows"] == n0 + 2
        for x, y in zip(want, got):
            assert torch.equal(x, y.cpu())
