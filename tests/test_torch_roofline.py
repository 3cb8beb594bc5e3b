"""The port's roofline (``roofline/op_cost.py``, ``roofline/analysis.py``)
on the CPU.

``op_cost``: exact on a matmul (2 m n k FLOPs, inputs and output bytes)
and on elementwise operations (bytes); equal on meta and on real CPU
tensors through reduced models; ``StepCounted`` (the plain scans counted
from 2, 3 and 4 steps) equal to the whole loop, forward and backward.
``analysis``: ``model_flops``, ``attention_flops`` and
``active_params_per_token`` equal the JAX package's exactly for every
arch x applicable shape, and ``from_record`` gives JAX's fields with the
H100's datasheet constants in place of the TPU's.  All integer or exact
float arithmetic: no tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import get_arch as j_get_arch
from repro.roofline import analysis as janalysis
from repro_torch.configs.base import (SHAPES, all_archs, applicable_shapes,
                                      get_arch, reduced)
from repro_torch.kernels.mamba_scan.ref import mamba_ref
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_ref
from repro_torch.distributed.sharding import axis_rules, use_mesh
from repro_torch.launch import dryrun
from repro_torch.models import model
from repro_torch.roofline import analysis
from repro_torch.roofline.op_cost import StepCounted, op_cost


@pytest.mark.parametrize("device", ["meta", "cpu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_cost_matmul_and_elementwise_exact(device, dtype):
    m, n, k = 8, 24, 40
    a = torch.ones(m, k, device=device, dtype=dtype)
    b = torch.ones(k, n, device=device, dtype=dtype)
    size = torch.tensor([], dtype=dtype).element_size()
    _, c = op_cost(torch.mm, a, b)
    assert c["flops"] == 2 * m * n * k
    assert c["bytes"] == (m * k + k * n + m * n) * size
    x = torch.ones(3, m, k, device=device, dtype=dtype)
    _, c = op_cost(lambda: x @ b)             # a view, then one mm
    assert c["flops"] == 2 * 3 * m * n * k
    assert c["bytes"] == (3 * m * k + k * n + 3 * m * n) * size
    _, c = op_cost(lambda: (a * 2).add_(a).exp())
    # mul: read a, write; add_: read both, write; exp: read, write
    assert c["flops"] == 0
    assert c["bytes"] == 7 * m * k * size
    assert c["by_op"]["aten.add_.Tensor"] == {
        "count": 1, "flops": 0, "bytes": 3 * m * k * size}


@pytest.mark.parametrize("arch", ["gemma3-1b", "jamba-v0.1-52b",
                                  "whisper-small", "granite-moe-3b-a800m"])
def test_op_cost_equal_on_meta_and_cpu(arch):
    """A reduced forward counts the same on meta tensors as on real CPU
    tensors (the scans' loops run whole on both)."""
    cfg = reduced(get_arch(arch))
    counts = []
    for dev in ("meta", "cpu"):
        gen = None if dev == "meta" else torch.Generator().manual_seed(0)
        p = model.init_params(cfg, gen, device=dev)
        batch = {"tokens": torch.zeros(2, 12, dtype=torch.int64,
                                       device=dev)}
        if cfg.family == "audio":
            batch["enc_embeds"] = torch.zeros(2, cfg.enc_seq, cfg.d_model,
                                              device=dev)
        with torch.no_grad():
            _, c = op_cost(lambda: model.forward(cfg, p, batch)[0])
        counts.append(c)
    assert counts[0] == counts[1]
    assert counts[0]["flops"] > 0


@pytest.mark.parametrize("t", [3, 9, 21])
@pytest.mark.parametrize("scan", ["rwkv6", "mamba"])
def test_step_counted_equals_the_whole_loop(scan, t):
    """``StepCounted`` counts a plain scan, forward and backward, exactly
    as running every step does."""
    mk = lambda *s: torch.empty(*s, device="meta").requires_grad_()
    if scan == "rwkv6":
        fn, steps, out_dim = rwkv6_ref, {0: 2, 1: 2, 2: 2, 3: 2}, 2
        args = [mk(2, 3, t, 4) for _ in range(4)] + [mk(3, 4)]
    else:
        fn, steps, out_dim = mamba_ref, {0: 1, 1: 1, 3: 1, 4: 1}, 1
        args = [mk(2, t, 6), mk(2, t, 6), mk(6, 3), mk(2, t, 3),
                mk(2, t, 3), mk(6)]

    def fwd_bwd(f):
        def run(*a):
            out = f(*a)
            torch.autograd.grad(out.sum(), a)
        return run

    for whole, counted in ((fn, StepCounted(fn, steps, out_dim)),
                           (fwd_bwd(fn), fwd_bwd(StepCounted(fn, steps,
                                                             out_dim)))):
        _, a = op_cost(whole, *args)
        _, b = op_cost(counted, *args)
        assert (a["flops"], a["bytes"]) == (b["flops"], b["bytes"])


def _cells():
    return [(a, s.name) for a in sorted(all_archs())
            for s in applicable_shapes(get_arch(a))]


def test_model_flops_equal_the_jax_package():
    """Every arch x applicable shape: the analytic counts bit-equal."""
    for arch, sname in _cells():
        cfg, jcfg = get_arch(arch), j_get_arch(arch)
        shape, jshape = SHAPES[sname], J_SHAPES[sname]
        assert dataclasses.astuple(shape) == dataclasses.astuple(jshape)
        assert analysis.model_flops(cfg, shape) == \
            janalysis.model_flops(jcfg, jshape), (arch, sname)
        assert analysis.active_params_per_token(cfg, shape.kind) == \
            janalysis.active_params_per_token(jcfg, shape.kind)
        for kind in ("train", "prefill", "decode"):
            assert analysis.attention_flops(
                cfg, shape.global_batch, shape.seq_len, kind) == \
                janalysis.attention_flops(jcfg, shape.global_batch,
                                          shape.seq_len, kind)


def test_f11_whisper_decode_counts_the_encoder_self_attention():
    """Reference fault F11: ``attention_flops`` adds the encoder's
    self-attention, enc_layers x 4 x enc_seq^2 x h x hd x batch / 2, for
    every kind (the JAX package's ``roofline/analysis.py:94``), though
    ``active_params_per_token`` takes the encoder as cached in decode.
    For whisper-small ``decode_32k`` that term is 96.4% of
    ``model_flops``, which is 27.91x the count without it; the count
    without it is op_cost's FLOPs of the decode cell exactly.  The
    port's counts stay bit-equal to JAX's."""
    cfg, shape = get_arch("whisper-small"), SHAPES["decode_32k"]
    mf = analysis.model_flops(cfg, shape)
    assert mf == janalysis.model_flops(j_get_arch("whisper-small"),
                                       J_SHAPES["decode_32k"])
    enc = (cfg.enc_layers * 4 * cfg.enc_seq ** 2 * cfg.n_heads
           * cfg.head_dim * shape.global_batch / 2)
    assert round(mf / (mf - enc), 2) == 27.91
    assert round(enc / mf, 3) == 0.964
    cell = dryrun.lower_cell("whisper-small", "decode_32k", False)
    with axis_rules(cell["rules"]), use_mesh(cell["mesh"]):
        _, cost = op_cost(cell["fn"], *cell["args"])
    assert cost["flops"] == mf - enc


def test_hardware_constants_are_the_h100_datasheet():
    assert analysis.HW == {"peak_flops": 989e12, "peak_flops_f32": 67e12,
                           "hbm_bw": 3.35e12, "link_bw": 900e9}
    assert "H100" in analysis.__doc__ and "datasheet" in analysis.__doc__


def test_from_record_is_jax_with_the_h100_constants(tmp_path):
    """A dry-run record of the port (nulls where it has no counterpart)
    through both ``from_record``s; JAX's is fed the record with the null
    fields left out, which the port's treats alike.  The record's
    collectives (the DTensor run's) give the collective term at the
    NVLink rate, and its buffer sizes (rank 0's, from the same run) the
    memory: arguments + output + temp - alias, rank 0's peak."""
    rec = dryrun.run_cell("gemma3-1b", "decode_32k", False, str(tmp_path))
    ma = rec["memory_analysis"]
    assert rec["ok"] and ma["generated_code_size_in_bytes"] is None
    assert all(ma[k + "_size_in_bytes"] > 0
               for k in ("output", "temp", "alias"))
    drop = lambda d: {k: v for k, v in d.items() if v is not None}
    jrec = {**drop(rec), "memory_analysis": drop(rec["memory_analysis"])}
    cfg, shape = get_arch("gemma3-1b"), SHAPES["decode_32k"]
    got = analysis.from_record(rec, cfg, shape)
    want = janalysis.from_record(jrec, j_get_arch("gemma3-1b"),
                                 J_SHAPES["decode_32k"])
    same = ("arch", "shape", "mesh", "devices", "hlo_flops", "hlo_bytes",
            "coll_bytes", "model_flops", "flops_ratio", "mem_gb")
    for f in same:
        assert getattr(got, f) == getattr(want, f), f
    assert got.compute_s == want.hlo_flops / 989e12
    assert got.memory_s == want.hlo_bytes / 3.35e12
    assert got.coll_bytes == rec["hlo_cost"]["collective_bytes"] > 0
    assert got.collective_s == got.coll_bytes / 900e9
    assert got.dominant == max((got.compute_s, "compute"),
                               (got.memory_s, "memory"),
                               (got.collective_s, "collective"))[1]
    assert got.mem_gb == (ma["argument_size_in_bytes"]
                          + ma["output_size_in_bytes"]
                          + ma["temp_size_in_bytes"]
                          - ma["alias_size_in_bytes"]) / 1e9
    assert ma["argument_size_in_bytes"] / 1e9 < got.mem_gb
    assert analysis.load_all(str(tmp_path)) == [got]
    assert analysis.HEADER == janalysis.HEADER
    assert got.row().count("|") == want.row().count("|")
    np.testing.assert_equal(got.bound_s, max(got.compute_s, got.memory_s,
                                             got.collective_s))
