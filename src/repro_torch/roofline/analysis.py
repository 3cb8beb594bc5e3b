"""Roofline terms per (arch x shape x mesh) from the port's dry-run records
(the port's copy of the JAX package's ``roofline/analysis.py``).

Hardware constants: NVIDIA H100 80GB HBM3 (SXM), NVIDIA's datasheet
figures, dense rates without sparsity, at the card's full 700 W power
limit (the card the port runs on reports power limit 700.00 W in
``nvidia-smi``; PERF.md).  They are not measured:
  peak bf16 compute   989 TFLOP/s per card (tensor cores)
  peak f32 compute     67 TFLOP/s per card (outside the tensor cores)
  HBM3 bandwidth      3.35 TB/s per card
  NVLink bandwidth    900 GB/s per card (all links together)

Terms (per device: rank 0 of the mesh, from the record's ``hlo_cost``,
which the dry run counts on DTensors; a record without it falls back to
``cost_analysis``'s even split of the global count):
  compute_s    = flops / PEAK_FLOPS (bf16: the dry run's dtype)
  memory_s     = bytes / HBM_BW (op_cost's unfused bytes: an upper bound)
  collective_s = collective_bytes / LINK_BW (rank 0's collectives, each
                 kind's result bytes, JAX's convention; every axis at the
                 NVLink rate, "pod" included)
MODEL_FLOPS is the analytic useful-work count (6*N*D train / 2*N*D
inference, MoE uses active params) -- the MODEL_FLOPS / (flops *
n_devices) ratio exposes remat and redundant compute.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

from repro_torch.configs.base import SHAPES, get_arch

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
PEAK_FLOPS_F32 = 67e12       # float32, CUDA cores
HBM_BW = 3.35e12
LINK_BW = 900e9              # NVLink 4, per card

HW = {"peak_flops": PEAK_FLOPS, "peak_flops_f32": PEAK_FLOPS_F32,
      "hbm_bw": HBM_BW, "link_bw": LINK_BW}


def _get(d: dict, key: str, default=0.0):
    """``d[key]``, or ``default`` where the key is absent or null."""
    v = d.get(key)
    return default if v is None else v


# ------------------------------------------------- analytic model flops

def _layer_params(cfg) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    ffn_dense = (3 if cfg.ffn_kind == "swiglu" else 2) * d * cfg.d_ff
    e = cfg.n_experts_padded or cfg.n_experts
    moe_active = cfg.top_k * 3 * d * cfg.d_ff + d * e if cfg.moe else 0
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    dtr = max(d // 16, 8)
    mamba = (2 * d * di + cfg.ssm_conv * di + di * (dtr + 2 * n)
             + dtr * di + di * d)
    rwkv = 5 * d * d + d * d + 2 * (d * 5 * 32 + 5 * 32 * d) \
        + (d * 64 + 64 * d) + 2 * int(3.5 * d) // 32 * 32 * d + d * d
    return {"attn": attn, "ffn": ffn_dense, "moe": moe_active,
            "mamba": mamba, "rwkv": rwkv}


def active_params_per_token(cfg, kind: str = "train") -> float:
    """Active (per-token) parameter count, excluding embeddings but
    including the logits head matmul.  For audio decode the encoder and the
    cross K/V projections are cached, not recomputed."""
    p = _layer_params(cfg)
    total = 0.0
    for li, lk in enumerate(cfg.layer_types):
        if lk == "attn":
            total += p["attn"]
        elif lk == "mamba":
            total += p["mamba"]
        else:
            total += p["rwkv"]
        if lk != "rwkv":
            use_moe = cfg.moe and (li % cfg.moe_every == cfg.moe_every - 1)
            total += p["moe"] if use_moe else p["ffn"]
    if cfg.family == "audio":
        if kind != "decode":
            total += cfg.enc_layers * (p["attn"] + p["ffn"])  # encoder
            total += cfg.n_layers * p["attn"]                 # cross qkvo
        else:
            total += cfg.n_layers * p["attn"] / 2             # cross q+o
    total += cfg.d_model * cfg.vocab                          # logits head
    return total


def attention_flops(cfg, batch: int, seq: int, kind: str) -> float:
    """Quadratic attention term, fwd: two matmuls (QK^T, PV) of
    2*S*ctx*H*hd each; causal avg ctx = S/2; window avg ctx ~ w.
    decode: one token against ctx keys."""
    h, hd = cfg.n_heads, cfg.head_dim
    total = 0.0
    for li, lk in enumerate(cfg.layer_types):
        if lk != "attn":
            continue
        w = cfg.layer_windows[li]
        if kind == "decode":
            ctx = min(seq, w) if w > 0 else seq
            total += 4 * ctx * h * hd * batch
        else:
            ctx = min(seq, w) if w > 0 else seq / 2
            total += 4 * seq * ctx * h * hd * batch
    if cfg.family == "audio":
        total += cfg.enc_layers * 4 * cfg.enc_seq ** 2 * h * hd * batch / 2
        s_dec = 1 if kind == "decode" else seq
        total += cfg.n_layers * 4 * s_dec * cfg.enc_seq * h * hd * batch
    return total


def model_flops(cfg, shape) -> float:
    """Useful-work FLOPs of one step of this cell (whole cluster)."""
    n_act = active_params_per_token(cfg, shape.kind)
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n_act * toks \
            + 3.0 * attention_flops(cfg, shape.global_batch, shape.seq_len,
                                    "train")
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n_act * toks \
            + attention_flops(cfg, shape.global_batch, shape.seq_len,
                              "prefill")
    toks = shape.global_batch
    return 2.0 * n_act * toks \
        + attention_flops(cfg, shape.global_batch, shape.seq_len, "decode")


# ----------------------------------------------------------- the table

@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    model_flops: float
    flops_ratio: float
    mem_gb: float

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> str:
        return (f"| {self.arch} | {self.shape} | {self.mesh} | "
                f"{self.compute_s * 1e3:.2f} | {self.memory_s * 1e3:.2f} | "
                f"{self.collective_s * 1e3:.2f} | {self.dominant} | "
                f"{self.flops_ratio:.2f} | {self.mem_gb:.2f} |")


def from_record(rec: dict, cfg, shape) -> Roofline:
    """A record's roofline; a null field counts as absent."""
    hc = rec.get("hlo_cost") or {}
    ca = rec.get("cost_analysis") or {}
    flops = _get(hc, "flops", _get(ca, "flops"))
    bytes_ = _get(hc, "bytes", _get(ca, "bytes accessed"))
    coll = _get(hc, "collective_bytes")
    n = _get(rec, "devices", 256)
    mf = model_flops(cfg, shape)
    c_s = flops / PEAK_FLOPS
    m_s = bytes_ / HBM_BW
    k_s = coll / LINK_BW
    dom = max((c_s, "compute"), (m_s, "memory"), (k_s, "collective"))[1]
    ma = rec.get("memory_analysis") or {}
    mem = (_get(ma, "argument_size_in_bytes", 0)
           + _get(ma, "output_size_in_bytes", 0)
           + _get(ma, "temp_size_in_bytes", 0)
           - _get(ma, "alias_size_in_bytes", 0))
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        devices=n, compute_s=c_s, memory_s=m_s, collective_s=k_s,
        dominant=dom, hlo_flops=flops, hlo_bytes=bytes_, coll_bytes=coll,
        model_flops=mf, flops_ratio=mf / max(flops * n, 1.0),
        mem_gb=mem / 1e9)


def load_all(artdir: str, mesh: str = "single") -> list:
    out = []
    for fn in sorted(os.listdir(artdir)):
        if not fn.endswith(f"_{mesh}.json"):
            continue
        with open(os.path.join(artdir, fn)) as f:
            rec = json.load(f)
        if not rec.get("ok"):
            continue
        cfg = get_arch(rec["arch"])
        shape = SHAPES[rec["shape"]]
        out.append(from_record(rec, cfg, shape))
    return out


HEADER = ("| arch | shape | mesh | compute (ms) | memory (ms) | "
          "collective (ms) | bound | MODEL/HLO flops | mem GB/dev |\n"
          "|---|---|---|---|---|---|---|---|---|")
