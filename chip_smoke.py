#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port of PrismDB on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printed as one JSON line:
  1. device   -- nvidia-smi name/power limit, build of every CUDA kernel
                 (one nvcc per source, all started together); then the
                 sass line: each flash_attention instance's tensor-core
                 instructions (cuobjdump -sass) and registers and spills
                 (ptxas), every bf16 instance on HMMA/HGMMA, no D 128/256
                 instance spilling
  2. kernels  -- each kernel against its plain PyTorch version on the card
                 at the main paths' shapes (clock_update and the three
                 tier_compact movers bit-exact, clock_update also against
                 the exact ordered access_seq on a batch without slot
                 collisions, clock_update's wrapper
                 making no CUDA activity but its kernel's launches,
                 msc_score rtol 1e-5 with its own pick equal to the
                 plain argmax (and the first of equal maxima) and one
                 CUDA activity a call; flash_attention at phi4-mini's
                 prefill and gemma3-1b's shapes, atol 2e-5 f32 / 2e-2
                 bf16;
                 rwkv6_scan at rwkv6-7b's prefill shape and a ragged
                 one, atol 1e-4; mamba_scan at jamba's prefill shape
                 and a ragged one, atol 1e-4), with
                 CUDA-event times, the plain version's and a library
                 call's where one computes the same function, and the
                 card's bound for the same work
  2a. prefill -- phi4-mini-3.8b at full width (float32 weights from a
                 seed): forward and loss_fn on backend "cuda" (the
                 flash_attention kernel once per layer) and "reference";
                 tokens/s, peak memory, argmax agreement (>= 99.9%, every
                 flip a near-tie)
  2b. serve   -- the same model through ServeEngine over the tiered paged
                 KV cache, two waves of requests, backend "cuda" then
                 "reference": every request retires, pages are demoted
                 and read back from the slow pool, B1-B5 launch, the
                 legs' tokens are bit-equal and their tier states equal
                 or parted only at an msc_score near-tie; the
                 paged_attention kernel on the live pools of one layer
  2c. rwkv_prefill -- rwkv6-7b at full width (float32 weights from a
                 seed): with u drawn non-zero, forward and loss_fn on
                 backend "cuda" (the rwkv6_scan kernel once per layer)
                 and "reference" (the plain scan), timed, and every
                 layer's two outputs from the same input held within
                 RWKV_LAYER_TOL (the decode form of time_mix too); with
                 the published init (u zero), the argmax gate of prefill
  2d. rwkv_decode -- the published-init weights through decode_step from
                 a float32 cache: a teacher-forced prefix held against the
                 "cuda" forward's logits at every position (the recurrent
                 step against the kernel's scan), then greedy tokens
  2e. jamba_prefill -- jamba-v0.1-52b at full width, one 8-layer period
                 (float32 weights from a seed): forward and loss_fn on
                 backend "cuda" (mamba_scan in the 7 mamba layers,
                 flash_attention in the attention layer) and "reference";
                 every block's two outputs from the same input held
                 within JAMBA_LAYER_TOL, with the MoE layers' drops and
                 top-2 agreement; the argmax gate of prefill, where a
                 1e-7 perturbation of the input does not fail it itself
  2f. jamba_decode -- the same weights at capacity_factor 8 through
                 decode_step from a float32 cache: a teacher-forced
                 prefix held against the "cuda" forward's logits, then
                 greedy tokens
  2g. vlm_prefill -- qwen2-vl-2b at full width (float32 weights from a
                 seed): forward and loss_fn from patch embeddings and the
                 stub frontend's M-RoPE positions on backend "cuda" (the
                 flash_attention kernel once per layer, GQA group 6) and
                 "reference", both profiled; the argmax gate of prefill,
                 and every layer's kernel core (atol ATTN_CORE_TOL) and
                 block (BLOCK_TOL) on the model's own activations
  2h. vlm_serve -- the same model through ServeEngine as in serve,
                 VLM_SERVE_SHAPE: every request retires, pages demoted and
                 read back, B1-B5 launch, the legs' tokens bit-equal, B6
                 on one layer's live pools
  2i. whisper_prefill -- whisper-small at full width: the encoder-decoder
                 forward on backend "cuda" (flash_attention in the 12
                 non-causal encoder layers over 1,500 frames and the 12
                 causal decoder layers) and "reference"; the argmax gate
                 and the per-layer gate of vlm_prefill, encoder included
  2j. whisper_decode -- the cross cache filled from the port's encoder
                 output (the JAX package leaves it zero), a teacher-forced
                 prefix held against the forward's logits, then greedy
                 tokens, ms a token
  2k. train   -- gemma3-1b at full width (float32 weights from a seed)
                 trained TRAIN_STEPS AdamW steps through
                 repro_torch.launch.train.main on backend "reference"
                 with remat: finite, falling losses, no kernel launched,
                 step ms, tokens/s, model TFLOP/s, peak memory, a
                 profiled step's busy share; gates: float32 gradients
                 against float64 (TRAIN_GRAD_LAYERS layers), micro-batch
                 equivalence, checkpoint restart, the error-feedback
                 identity of compressed steps, the refusal of kernels
                 under autograd
  2l. launch_serve -- repro_torch.launch.serve.main at its defaults on the
                 card (backend "cuda"), each tick timed; the same weights,
                 pools and requests through a ServeEngine on "reference":
                 every request retires, equal tokens, tier states equal
                 or parted only at an msc_score near-tie, B1 launches
                 (B2 too where a compaction ran); tokens/s, tick p50,
                 host reads a tick, launches
  2m. banded_prefill -- gemma3-1b at full width with banded_local (float32
                 weights from a seed), 2 x 4,096 tokens: the banded
                 "cuda" forward (B7 in the 4 global layers, the plain
                 S x 2w band in the 22 local ones) and the masked one (B7
                 in all 26), timed and profiled; every layer on the
                 model's own activations (band against the masked
                 softmax, B7 against its plain version); the argmax gate
                 between the two; then the dry run's prediction for this
                 cell on a 1x1 local mesh (a one-rank NCCL group): the
                 argument bytes against the bytes held, a table laid out
                 by the spec's placements, op_cost's FLOPs beside
                 model_flops, mfu_f32
  2n. pipeline -- stablelm-12b at full width (float32 weights from a
                 seed) through distributed.pipeline.pipelined_forward on
                 "cuda": 2 stages of 20 layers in turn on the card, 2
                 microbatches, against one forward: B7 once per layer
                 per microbatch, every stage boundary equal to the
                 forward's residual for its rows (BLOCK_TOL a layer), the
                 argmax gate; times, bubble share, peak memory
  2o. moe_ep_local -- qwen3-moe-235b-a22b at full width, 4 of 94 layers:
                 each MoE layer on the model's own activations through
                 the global dispatch and ep_local on a 1x1 DeviceMesh
                 (ep 1: the DeviceMesh dispatch, no collective runs) and
                 on a stand-in of 4 model ranks: kept pairs
                 equal, outputs within MOE_TOL, aux equal, ep_local's
                 dropped 0 (F8) beside the global drops; the whole
                 forward under both through the argmax gate
  2p. starcoder2_prefill -- starcoder2-15b at full width (40 layers,
                 63.8 GB): the gates of vlm_prefill on tokens
  2q. examples -- examples/quickstart_torch.py, workloads_demo_torch.py
                 and serve_tiered_torch.py in process on the card: the
                 first two print what their CPU "reference" runs print,
                 the third passes its asserts; B1 (and B3-B5 under
                 serving) launch
  3. parity   -- the engine at paper_tier_config(scale=1) on one op
                 stream: backend "cuda" on the card vs "reference" on the
                 card and on the CPU; state, counters and per-op results
                 bit-equal; again at compaction_quantum DRAIN_Q, whose tier
                 state and results must also equal run to completion's
  4. main     -- PrismDB(paper_tier_config(SCALE), backend="cuda") through
                 put/get/delete/scan_ops: preload 50% of the key space,
                 YCSB-A, YCSB-C and a scan segment; main_quantum, the same
                 at compaction_quantum=DRAIN_Q, bit-equal to main in end
                 state and per-op results; then main_full and
                 main_full_quantum, the same at the paper's full size
                 (100.7 M keys) with a fixed preload of FULL_PRELOAD_KEYS
                 (end states compared by per-leaf checksums); throughput,
                 modeled p50/p99/p999, host reads per step, peak memory,
                 kernel launches, device busy share; read-back of a sample
                 of preloaded keys (value == key) and of deleted keys
  4b. workloads -- PrismDB(paper_tier_config(SCALE)), 50% preload, through
                 run_workload: YCSB A-F, the three Twitter clusters,
                 hotset-shift and flash-crowd, WORKLOAD_BATCHES batches
                 each, backend "cuda" then "reference" on the card:
                 StepStats, per-op results and end states equal (or
                 parted only at an msc_score near-tie), YCSB-E returns
                 scan keys, device-to-host copies (counted at the
                 dispatcher; the profiler's count reported) equal the
                 engine's host reads, acknowledged writes read back;
                 per segment ops/s, step p50/p90, compactions, host reads
                 a step, launches
  4c. three_tier -- three_tier_config(SCALE) (DRAM / XPoint / QLC slots
                 and costs of the JAX package's tier-sweep-n3), preloaded,
                 YCSB-A and YCSB-C through run_workload on "cuda" and
                 "reference": both boundaries compact, per-boundary
                 events equal commits, tiers within their slots, no
                 orphaned row, read-back of preloaded and deleted keys,
                 one deep compaction's device time; three_tier_quantum,
                 the "cuda" leg at compaction_quantum=DRAIN_Q, whose
                 per-op results and end state equal three_tier's
  4d. partitioned -- PartitionedDB(paper_tier_config(SCALE), PART_P): main's
                 preload routed, PART_SEGMENT routed batches alternating
                 put and get, then one tenant a partition (PART_TENANTS)
                 through run_workload, on "cuda" and "reference" (per-
                 partition counters, drops, tier states and obs
                 histograms equal, or parted only at an msc_score
                 near-tie) and the routed part at quantum DRAIN_Q (B3/B4
                 launch, tier state equal); partition 0 equals a lone
                 engine fed its rows; routed writes read back; BATCH
                 identical keys drop all but the pad; the merged
                 histogram mass equals the routed valid lanes plus the
                 tenants' ops; the snapshot to chiprun_out/
                 partitioned.jsonl; a maybe_trace window holding B1 and
                 B2 kernel events; ops/s, p50/p90 and host reads a
                 client batch and a tenant step
  5. embed    -- the embedding row store at gemma3-1b's width through
                 engine_init + prepare_step, backend "cuda", "cuda" with
                 the plain movers, and "reference": every lookup equal to
                 the initial table, the end states equal; steps/s,
                 compactions, launches; embed_4096, the same at
                 EMBED_DIAG_TOKENS a batch without the plain-movers leg,
                 where the "reference" leg may
                 part from the "cuda" one only at a compaction whose
                 candidates the msc_score kernel and the plain scorer rank
                 differently on a near-tie
  6. dryrun   -- the port's dry run of every arch x applicable shape x
                 mesh, baseline and opt, on the meta device in two host
                 processes started before the kernel checks: every cell
                 of both variants ok (the opt moe cells on ep_local); the
                 banded_prefill cell's check
Then the kernels line, the nvidia-smi line, and the final ok line.  The
sizes are the module constants below; PERF.md ("Scale used") says why.

Exits non-zero, printing no result, when no CUDA device is available,
when the port's sources are missing, or when any phase fails.  Long
reports go to chiprun_out/.
"""
from __future__ import annotations

import collections
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
FULL_SCALE = 1536              # paper §7: 100.7 M keys
BATCH = 4096                   # client batch (ops per engine step)
CLOCK_LAUNCHES = 3             # B1's claim, mark and apply launches
# The 50%-preload recipe runs at 1536 / 128: the largest halving of the
# full scale whose run directory does not overflow (ROADMAP Queue 3) and
# whose preload fits the time limit.
SCALE = FULL_SCALE // 128
SEGMENT = 64                   # client batches per YCSB segment at SCALE
# The full-size state is preloaded with a fixed key count: past the fast
# tier's 0.98 high watermark (10,961,113 keys), so compactions run, and
# well inside the time limit (a 50% preload does not fit it).  The
# preload is set-up, loaded in puts of FULL_PRELOAD_BATCH keys: a step's
# host time hardly grows with its batch, and 2,688 client batches took
# 31-53 s a leg; the segments run at the client batch.
FULL_PRELOAD_KEYS = 2688 * BATCH          # 11,010,048 keys
FULL_PRELOAD_BATCH = 8 * BATCH
FULL_SEGMENT = 16
FULL_PROFILE_STEPS = 2         # profiler bookkeeping grows per traced op
DRAIN_Q = 64                   # compaction_quantum of the quantized phases
# The embedding store at gemma3-1b's published width (vocab and d_model of
# src/repro/configs/gemma3_1b.py) with the store's default fast_rows:
# a 1.21 GB slow row pool and a 37.7 MB fast one.  Batches of
# EMBED_TOKENS = fast_rows / 4 tokens: at fast_rows / 2 the pinned hot
# rows keep free slots below the batch, and from the 24th batch on the
# rate limiter runs max_rounds (256) compactions every step (PERF.md).
EMBED_VOCAB, EMBED_DIM, EMBED_FAST_ROWS = 262_144, 1_152, 8_192
EMBED_TOKENS, EMBED_STEPS = 2048, 16
# The same store at fast_rows / 2 tokens a batch, with the msc_score
# kernel's choices held against the plain scorer's at every compaction:
# one batch into the rate limiter's thrash regime (batch 24 on, 256
# compactions a batch).  The first tie the two scorers break apart comes
# at batch 38 (PERF.md); those 14 more batches of thrash took a quarter
# of the whole smoke, so the smoke stops short of them.
EMBED_DIAG_TOKENS, EMBED_DIAG_STEPS = 4096, 25
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor-core peak
# H100 SXM special function units: 16 exponentials a clock an SM (CUDA C
# programming guide, throughput of exp2 for compute capability 9.0), 132
# SMs, 1.98 GHz boost clock (the clock nvidia-smi reads under B9's load)
SFU_EXP_PER_S = 16 * 132 * 1.98e9
# The model phases: phi4-mini-3.8b at its published width (src/repro/
# configs/phi4_mini_3_8b.py), float32 weights from MODEL_SEED (15.3 GB).
MODEL = "phi4-mini-3.8b"
MODEL_SEED, PREFILL_SEED, SERVE_SEED = 13, 14, 15
PREFILL_BATCH, PREFILL_SEQ = 2, 2048
# A flip of the argmax between the backends counts as a near-tie when the
# reference's top-two logit gap is below this (logits ~1 in magnitude;
# the backends differ only in the attention's, or the WKV scan's,
# summation order).
PREFILL_TIE = 1e-3
# flash_attention's kernel shapes [B, Hq, Hkv, S, D]: phi4-mini's prefill
# (the prefill phase's) and gemma3-1b's (head dim 256, 5:1 local layers
# of window 512; src/repro/configs/gemma3_1b.py)
PHI4_ATTN, GEMMA3_ATTN = (2, 24, 8, 2048, 128), (1, 4, 1, 4096, 256)
# ... and whisper-small's encoder (non-causal, the whisper_prefill phase's)
# and qwen2-vl-2b's prefill (the vlm_prefill phase's)
WHISPER_ENC_ATTN, QWEN2VL_ATTN = (2, 12, 12, 1500, 64), (2, 12, 2, 2048, 128)
# Serving: two waves of requests through the 16 slots of serve_kv_config
# (requests, prompt and new tokens each, the first of SERVE_TRACE_TICKS
# profiled ticks of the cuda leg, the tick whose live pools B6 is checked
# on).  The 16 live slots of 128 + 32 tokens hold 160 pages, past the
# fast pool's 128, so pages are demoted; prompts of 256 tokens doubled
# the phase's 320 ticks a leg for no further path.
ServeShape = collections.namedtuple(
    "ServeShape", "requests prompt new trace_at b6_at")
SERVE_SHAPE = ServeShape(24, 128, 32, 100, 200)
SERVE_TRACE_TICKS = 4
# rwkv6-7b at its published width (src/repro/configs/rwkv6_7b.py,
# arXiv:2404.05892: 32 layers, d 4,096, 64 heads of 64, channel mix
# 14,336, vocab 65,536 untied), float32 weights from RWKV_SEED (30.6 GB),
# u from RWKV_U_SEED; prefill of PREFILL_BATCH x PREFILL_SEQ tokens from
# RWKV_TOKENS_SEED; decode: RWKV_FORCED teacher-forced tokens, then
# RWKV_NEW greedy ones.
RWKV_MODEL = "rwkv6-7b"
RWKV_SEED, RWKV_U_SEED, RWKV_TOKENS_SEED = 16, 17, 18
RWKV_FORCED, RWKV_NEW = 64, 32
# Each layer's cuda and reference outputs from the same input, and the
# decode form of its time_mix against the kernel's sequence form, must
# agree within this (relative, Frobenius norm): they differ only in the
# WKV's float32 summation order, measured at most 1.5e-6 a layer at full
# width on the H100 (PERF.md).
RWKV_LAYER_TOL = 1e-5
# rwkv6_scan's kernel shapes [B, H, T, D]: rwkv6-7b's prefill (the
# rwkv_prefill phase's) and a ragged one (T off the chunk, D 16)
RWKV_SCAN, RWKV_RAGGED = (2, 64, 2048, 64), (2, 2, 37, 16)
# jamba-v0.1-52b at its published width (src/repro/configs/
# jamba_v0_1_52b.py, arXiv:2403.19887: d 4,096, 32 heads / 8 KV, d_ff
# 14,336, 16 experts top-2, vocab 65,536 untied, Di 8,192, N 16), cut to
# one 8-layer period (7 mamba layers, 1 attention layer, 4 MoE FFNs):
# 13.30 B parameters, 53.2 GB in float32 from JAMBA_SEED; the 32 layers
# (208 GB in float32, 104 GB in bf16) fit no card.  Prefill of
# PREFILL_BATCH x PREFILL_SEQ tokens from JAMBA_TOKENS_SEED at the
# published capacity_factor; decode at JAMBA_DECODE_CF, where no token
# can drop (E / k = 8), so decode and forward route alike: JAMBA_FORCED
# teacher-forced tokens, then JAMBA_NEW greedy ones.
JAMBA_MODEL, JAMBA_LAYERS = "jamba-v0.1-52b", 8
JAMBA_SEED, JAMBA_TOKENS_SEED = 19, 20
JAMBA_DECODE_CF = 8.0
JAMBA_FORCED, JAMBA_NEW = 64, 32
# Each block's cuda and reference outputs from the same input must agree
# within this (relative, Frobenius norm): they differ only in B9's (and
# in the attention block, B7's) float32 summation order.
JAMBA_LAYER_TOL = 1e-5
# The end-to-end argmax gate is well-posed where the "cuda" forward
# against itself, its embeddings perturbed by this (relative), passes it.
JAMBA_PERTURB = 1e-7
# mamba_scan's kernel shapes [Bb, T, Di, N]: jamba's prefill (the
# jamba_prefill phase's) and a ragged one (T off the chunk, Di off the
# block of 128)
MAMBA_SCAN, MAMBA_RAGGED = (2, 2048, 8192, 16), (2, 37, 300, 16)

# qwen2-vl-2b at its published width (src/repro/configs/qwen2_vl_2b.py,
# arXiv:2409.12191: 28 layers, d 1,536, 12 heads / 2 KV of 128, d_ff
# 8,960, vocab 151,936 tied, biases on q/k/v, M-RoPE sections 16/24/24),
# float32 weights from VLM_SEED (1.54 B parameters, 6.2 GB).  Prefill:
# patch embeddings [PREFILL_BATCH, PREFILL_SEQ, d] x 0.02 and labels from
# VLM_INPUT_SEED, with the stub frontend's positions (t, t % 7, t % 5),
# t = arange (src/repro/train/data.py:55-64).  Serving: VLM_SERVE_SHAPE
# through serve_kv_config's pools (the fast pool holds 128 of the 160
# pages that end up live).
VLM_MODEL = "qwen2-vl-2b"
VLM_SEED, VLM_INPUT_SEED, VLM_SERVE_SEED = 21, 22, 23
VLM_SERVE_SHAPE = ServeShape(16, 128, 32, 60, 120)
# whisper-small at its published width (src/repro/configs/whisper_small.py,
# arXiv:2212.04356: 12 encoder and 12 decoder layers, d 768, 12 heads of
# 64, d_ff 3,072, vocab 51,865 tied), float32 weights from WHISPER_SEED
# (0.24 B parameters, 1 GB).  Prefill: frame embeddings [PREFILL_BATCH,
# enc_seq 1,500, d] x 0.02 (src/repro/train/data.py:47-53) and
# WHISPER_TOKENS decoder tokens (the decoder's 448-token text context in
# the paper) from WHISPER_INPUT_SEED; decode from a cross cache filled
# with the port's encoder output: WHISPER_FORCED teacher-forced tokens,
# then WHISPER_NEW greedy ones.
WHISPER_MODEL = "whisper-small"
WHISPER_SEED, WHISPER_INPUT_SEED = 24, 25
WHISPER_TOKENS, WHISPER_FORCED, WHISPER_NEW = 448, 64, 32
# Per attention layer, on the model's own activations: B7 against its
# plain version on the layer's q, k, v (max abs, float32: the kernel
# tests' 2e-5), and the whole block on "cuda" against "reference" from
# the same input (relative, Frobenius norm).
ATTN_CORE_TOL, BLOCK_TOL = 2e-5, 1e-5
# Training: gemma3-1b at its published width (src/repro/configs/
# gemma3_1b.py, hf:google/gemma-3-1b-pt: 26 layers, d 1,152, 4 heads / 1
# KV of 256, d_ff 6,912, vocab 262,144 tied, 5 local (window 512) : 1
# global), float32 weights from TRAIN_SEED (1.00 B parameters; params,
# grads and both moments 16 GB), through repro_torch.launch.train.main:
# TRAIN_STEPS AdamW steps of TRAIN_BATCH x TRAIN_SEQ tokens (the window-
# 512 layers mask), backend "reference", remat on; step TRAIN_PROFILE_STEP
# under the profiler.  Gates: the float32 gradients against float64 at
# TRAIN_GRAD_LAYERS layers (batch 1 x TRAIN_SEQ), relative L2 per leaf
# within TRAIN_GRAD_TOL; micro_batches 2 against 1 on one batch (the JAX
# test's bounds, loss rtol 1e-5, params atol 2e-5); a checkpoint at step
# TRAIN_STEPS / 2 replayed to TRAIN_STEPS within 1e-6 of the
# uninterrupted run (deterministic algorithms, TRAIN_CKPT_LAYERS layers);
# two compressed steps whose applied gradient plus new residual equals
# the gradient plus the old residual within 1e-6 relative.
TRAIN_MODEL, TRAIN_SEED = "gemma3-1b", 26
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 4, 1024, 1e-3
TRAIN_PROFILE_STEP = 6
TRAIN_GRAD_LAYERS, TRAIN_GRAD_TOL = 2, 1e-4
# The checkpoint leg runs at one period of the 5:1 pattern: at all 26
# layers the 12 GB state's save, write and restore took about 30 s on the
# H100, near half the phase (PERF.md)
TRAIN_CKPT_LAYERS = 6
TRAIN_REDUCED = False              # True: the CPU rehearsal's reduced model
# The last slice's phases.  pipeline: stablelm-12b at its published
# width (src/repro/configs/stablelm_12b.py, hf:stabilityai/stablelm-2-12b:
# 40 layers, d 5,120, 32 heads / 8 KV of 160, d_ff 13,824, vocab 100,352
# untied), float32 weights from PIPE_SEED (12.1 B parameters, 48.6 GB),
# PREFILL_BATCH x PREFILL_SEQ tokens from PIPE_TOKENS_SEED through a
# PIPE_STAGES-stage GPipe of PIPE_MICRO microbatches on a stand-in mesh
# (the stages in turn on the card), against one forward.
PIPE_MODEL, PIPE_SEED, PIPE_TOKENS_SEED = "stablelm-12b", 28, 29
PIPE_STAGES, PIPE_MICRO = 2, 2
# A stage boundary is 20 blocks from the embeddings, each of whose GEMMs
# sums in another order than the forward's (a microbatch's 2,048 rows
# against the batch's 4,096): the relative error may grow by one block's
# BLOCK_TOL a block, so the gate is BLOCK_TOL times the stage's layers.
# moe_ep_local: qwen3-moe-235b-a22b at its published width (src/repro/
# configs/qwen3_moe_235b_a22b.py, hf:Qwen/Qwen3-235B-A22B: d 4,096, 64
# heads / 4 KV of 128, 128 experts top-8 of d_ff 1,536, vocab 151,936
# untied), depth cut 94 -> MOE_LAYERS (9.7 GB of experts a layer; 4
# layers are 44.8 GB in float32), float32 weights from MOE_SEED, tokens
# from MOE_TOKENS_SEED; ep_local on a 1x1 DeviceMesh (ep 1, so no
# collective runs) and on a stand-in of MOE_RANKS model ranks of 32 experts, against the global
# dispatch.  Their outputs differ only in float32 summation order (the
# experts' matmul shapes, a token's 8 outputs added in expert order):
# within MOE_TOL (relative, Frobenius norm); aux within MOE_AUX_TOL
# (relative: the mean over 4 equal ranks' values may round).
MOE_MODEL, MOE_LAYERS, MOE_SEED, MOE_TOKENS_SEED = \
    "qwen3-moe-235b-a22b", 4, 30, 31
MOE_RANKS, MOE_TOL, MOE_AUX_TOL = 4, 1e-5, 1e-6
# starcoder2_prefill: starcoder2-15b at its published width (src/repro/
# configs/starcoder2_15b.py, arXiv:2402.19173: 40 layers, d 6,144, 48
# heads / 4 KV of 128, GELU MLP of 24,576, biases on q/k/v, vocab 49,152
# untied), float32 weights from STARCODER_SEED (15.96 B parameters, 63.8
# GB: both legs fit, no depth cut), tokens from STARCODER_TOKENS_SEED.
STARCODER_MODEL, STARCODER_SEED, STARCODER_TOKENS_SEED = \
    "starcoder2-15b", 32, 33
# examples: the three examples/*_torch.py run in this process, each
# example's output on the card held to its CPU "reference" run's
EXAMPLES = ("quickstart_torch", "workloads_demo_torch",
            "serve_tiered_torch")


_T_START: list = []             # main's start time, once it has one


def emit(obj: dict) -> None:
    """Print one JSON line and append it to chiprun_out/smoke.jsonl, so
    every phase's line survives where only the end of the output is
    kept.  A phase's line gets ``t_s``, the seconds since main began."""
    if "phase" in obj and _T_START:
        obj = {**obj, "t_s": time.time() - _T_START[0]}
    line = json.dumps(obj)
    print(line, flush=True)
    OUT.mkdir(exist_ok=True)
    with open(OUT / "smoke.jsonl", "a") as f:
        f.write(line + "\n")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# ------------------------------------------------------------ phase 2

def _device_kernels(fn, calls: int) -> tuple:
    """CUDA activities (kernels, copies, fills) per call of ``fn`` over
    ``calls`` calls under the profiler, and their names."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    # the first trace warms CUPTI up; a later one that holds no device
    # activity at all (CUPTI delivered no record) is taken again
    for attempt in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name != "Command Buffer Full"]
        if attempt > 0 and dev:
            break
    return len(dev) / calls, sorted({e.name[:60] for e in dev})


def _kernel_ms(fn, calls: int, name: str) -> float:
    """Mean device time in ms of the CUDA kernels whose name holds
    ``name``, over ``calls`` calls of ``fn`` under the profiler: the
    kernel alone, without the host's launch time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(4):       # as _device_kernels: retake an empty trace
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and name in e.name]
        if attempt > 0 and us:
            return sum(us) / len(us) / 1e3
    raise AssertionError(f"the profiler saw no {name} kernel")


def check_clock_update(cfg, batch: int, rng) -> dict:
    """B1 against ``tracker.access_batched`` (and the kernel's passes in
    plain PyTorch, ``clock_update_passes``) on 8 batches of hot,
    colliding and random keys, and against the exact ordered
    ``tracker.access_seq`` on a batch whose keys share no slot, all
    bit-exact; the wrapper's time, the
    launches' alone and the CUDA activities a wrapper call makes (the
    kernel's own three launches, nothing else)."""
    import numpy as np
    import torch
    from repro_torch.core import tracker
    from repro_torch.kernels.clock_update import ops
    from repro_torch.kernels.clock_update.ref import clock_update_passes
    dev = torch.device("cuda")
    t = cfg.tracker_slots
    # keys that collide on a slot: draw many, keep groups sharing a slot
    pool = torch.from_numpy(rng.integers(0, cfg.key_space, 1 << 20)
                            .astype(np.int32)).to(dev)
    gen = lambda seed: torch.Generator(dev).manual_seed(seed)
    slots = tracker.slot_of(t, pool)
    order = torch.argsort(slots)
    s_sorted = slots[order]
    dup = torch.zeros_like(s_sorted, dtype=torch.bool)
    dup[1:] = s_sorted[1:] == s_sorted[:-1]
    dup[:-1] |= s_sorted[:-1] == s_sorted[1:]
    colliding = pool[order[dup]]
    state = tracker.init(t, dev)
    worst = 0
    for it in range(8):
        hot = torch.from_numpy(rng.integers(0, 4 * batch, batch // 4)
                               .astype(np.int32)).to(dev)
        coll = colliding[torch.randint(0, colliding.numel(), (batch // 4,),
                                       device=dev, generator=gen(it))]
        rnd = torch.from_numpy(rng.integers(0, cfg.key_space, batch // 2)
                               .astype(np.int32)).to(dev)
        keys = torch.cat([hot, coll, rnd])[torch.randperm(
            batch, device=dev, generator=gen(it))]
        locs = torch.from_numpy(rng.integers(0, 2, batch)
                                .astype(np.int8)).to(dev)
        valid = torch.from_numpy(rng.random(batch) > 0.05).to(dev)
        want = tracker.access_batched(state, keys, locs, valid)
        passes = clock_update_passes(state, keys, locs, valid)
        got = ops.clock_update(
            tracker.TrackerState(*[x.clone() for x in state]), keys, locs,
            valid)
        torch.cuda.synchronize()
        for a, b, c in zip(want, got, passes):
            worst = max(worst, int((a.to(torch.int64) - b.to(torch.int64))
                                   .abs().max()),
                        int((a.to(torch.int64) - c.to(torch.int64))
                            .abs().max()))
        state = want
    # the exact ordered reference, on a batch whose keys share no slot
    # (one key a slot, the first drawn), from the tables the batches left
    rnd = torch.from_numpy(rng.integers(0, cfg.key_space, batch)
                           .astype(np.int32)).to(dev)
    _, first = np.unique(tracker.slot_of(t, rnd).cpu().numpy(),
                         return_index=True)
    free = rnd[torch.from_numpy(np.sort(first)).to(dev)]
    free_locs = torch.from_numpy(rng.integers(0, 2, free.numel())
                                 .astype(np.int8)).to(dev)
    ones = torch.ones(free.numel(), dtype=torch.bool, device=dev)
    seq = tracker.access_seq(state, free, free_locs, ones)
    got = ops.clock_update(tracker.TrackerState(*[x.clone() for x in state]),
                           free, free_locs, ones)
    torch.cuda.synchronize()
    seq_err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in zip(seq, got))
    worst = max(worst, seq_err)
    if worst != 0:
        raise AssertionError(f"clock_update differs from access_batched "
                             f"or, on a collision-free batch, from "
                             f"access_seq (max abs err {worst})")
    touched = int(torch.unique(tracker.slot_of(t, keys[valid])).numel())
    scratch = tracker.TrackerState(*[x.clone() for x in state])
    call = lambda: ops.clock_update(scratch, keys, locs, valid)
    ms = cuda_ms(call, 200)
    per_call, names = _device_kernels(call, 16)
    if per_call != CLOCK_LAUNCHES:
        raise AssertionError(f"clock_update: a wrapper call makes "
                             f"{per_call} CUDA activities ({names}), its "
                             f"kernel {CLOCK_LAUNCHES} launches")
    # the launches alone (held scratch, no validation)
    lib = ops._lib()
    stream = torch.cuda.current_stream().cuda_stream
    sc = ops._scratch(dev, t, batch)
    launch_ms = cuda_ms(lambda: lib.clock_update_launch(
        keys.data_ptr(), locs.data_ptr(), valid.data_ptr(), batch,
        scratch.keys.data_ptr(), scratch.clock.data_ptr(),
        scratch.loc.data_ptr(), t, sc[0].data_ptr(), sc[1].data_ptr(),
        sc[2].data_ptr(), stream), 200)
    plain_ms = cuda_ms(lambda: tracker.access_batched(state, keys, locs,
                                                      valid), 20)
    nbytes = batch * (4 + 1 + 1) + touched * (6 + 6)
    return {"name": "clock_update", "route": "cuda",
            "source": "src/repro_torch/csrc/clock_update.cu",
            "replaces": "src/repro/kernels/clock_update/clock_update.py:85",
            "max_abs_err": float(worst), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
            "library_ms": None, "shape": {"T": t, "B": batch},
            "touched_slots": touched, "launch_only_ms": launch_ms,
            "access_seq_batch": int(free.numel()),
            "access_seq_max_abs_err": float(seq_err),
            "cuda_kernels_per_call": per_call,
            "kernel_launches": CLOCK_LAUNCHES, "cuda_kernel_names": names}


def _host_us(fn, n: int = 2000) -> float:
    """Mean host microseconds per call of ``fn`` (no device wait: for the
    pieces of a wrapper)."""
    for _ in range(20):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return 1e6 * (time.perf_counter() - t0) / n


def check_msc_score(cfg, rng) -> dict:
    """B2 against its plain version (``msc_scores_ref``) on 64 draws at the
    full-size config's K and B, scores within rtol 1e-5 and its own pick
    (``best``) equal to the plain argmax; then 16 draws with the best
    candidate copied over one candidate before it and one after, where
    the kernel's tied scores must be equal and ``best`` the first of
    them.  On every draw ``best`` equals ``pick_best_ref`` of the
    kernel's scores.  The wrapper's
    time as ``select_range`` calls it (``check=False``) and with its
    checks, the launch alone, the host cost of each piece of the wrapper,
    and the CUDA activities a call makes (the kernel's one launch)."""
    import numpy as np
    import torch
    from repro_torch.kernels.msc_score import ops
    from repro_torch.kernels.msc_score.ref import msc_scores_ref, pick_best_ref
    dev = torch.device("cuda")
    k, nb = cfg.power_k, cfg.n_buckets
    bw = max(cfg.key_space // nb, 1)
    worst_rel = worst_abs = 0.0
    best_equal = ties_first = 0
    for it in range(80):
        lo = rng.integers(0, cfg.key_space, k)
        hi = np.minimum(lo + rng.integers(1, cfg.key_space // 8, k),
                        cfg.key_space)
        args = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
            lo, hi, rng.integers(0, 4096, k),
            rng.integers(0, cfg.fast_slots // nb + 1, nb),
            rng.integers(0, cfg.slow_slots // nb + 1, nb),
            rng.integers(0, cfg.fast_slots // (4 * nb) + 1, nb),
            rng.integers(0, cfg.tracker_slots // (8 * nb) + 1, (nb, 4)))]
        probs = torch.from_numpy(np.sort(rng.random(4)).astype(
            np.float32)).to(dev)
        want = msc_scores_ref(*args, probs, bucket_width=bw)
        if it >= 64:   # exact ties: the best candidate copied before it
            m = int(torch.argmax(want))  # and after it
            tied = [m] + ([int(rng.integers(0, m))] if m > 0 else []) + (
                [int(rng.integers(m + 1, k))] if m + 1 < k else [])
            for a in args[:3]:
                a[tied] = int(a[m])
            want = msc_scores_ref(*args, probs, bucket_width=bw)
        got, best = ops.msc_scores(*args, probs, bucket_width=bw)
        torch.cuda.synchronize()
        diff = (want - got).abs()
        worst_abs = max(worst_abs, float(diff.max()))
        worst_rel = max(worst_rel, float((diff / want.abs().clamp(
            min=1e-30)).max()))
        if int(best) != int(pick_best_ref(got)):
            raise AssertionError("msc_score: the kernel's pick is not the "
                                 "first maximum of its own scores")
        if it < 64:
            best_equal += int(best) == int(torch.argmax(want))
        else:
            ties_first += int(best) == min(tied) and bool(
                (got[tied] == got.max()).all())
    if worst_rel > 1e-5:
        raise AssertionError(f"msc_score rel err {worst_rel} > 1e-5")
    if best_equal != 64 or ties_first != 16:
        raise AssertionError(f"msc_score: best is the plain argmax in "
                             f"{best_equal} of 64 draws, the first of equal "
                             f"maxima in {ties_first} of 16")
    call = lambda: ops.score_candidates(*args, probs, bucket_width=bw,
                                        check=False)
    ms = cuda_ms(call, 200)
    checked_ms = cuda_ms(lambda: ops.msc_scores(*args, probs,
                                                bucket_width=bw), 200)
    per_call, names = _device_kernels(call, 16)
    if per_call != 1:
        raise AssertionError(f"msc_score: a score_candidates call makes "
                             f"{per_call} CUDA activities ({names}), not 1")
    lib = ops._lib()
    stream = torch.cuda.current_stream().cuda_stream
    scores = torch.empty(k, dtype=torch.float32, device=dev)
    best = torch.empty((), dtype=torch.int64, device=dev)
    ptrs = [a.data_ptr() for a in args] + [probs.data_ptr()]
    launch = lambda: lib.msc_score_launch(*ptrs, k, nb, bw,
                                          scores.data_ptr(), best.data_ptr(),
                                          stream)
    launch_ms = cuda_ms(launch, 200)
    pieces = {
        "check_args": _host_us(lambda: ops.check_args(
            *args, probs, bucket_width=bw)),
        "empty_scores": _host_us(lambda: torch.empty(
            k, dtype=torch.float32, device=dev)),
        "empty_best": _host_us(lambda: torch.empty(
            (), dtype=torch.int64, device=dev)),
        "current_stream_object": _host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "raw_stream": _host_us(
            lambda: torch._C._cuda_getCurrentRawStream(
                args[0].device.index)),
        "launch_only": _host_us(launch),
        "wrapper": _host_us(call)}
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: msc_scores_ref(*args, probs,
                                              bucket_width=bw), 100)
    nbytes = k * 4 * 4 + nb * 3 * 4 + nb * 16 + 16 + 8
    ops_n = k * nb * 24
    bound_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    bound_ops = 1e3 * ops_n / F32_OPS_PER_S
    return {"name": "msc_score", "route": "cuda",
            "source": "src/repro_torch/csrc/msc_score.cu",
            "replaces": "src/repro/kernels/msc_score/msc_score.py:52",
            "max_abs_err": worst_abs, "max_rel_err": worst_rel, "ms": ms,
            "checked_ms": checked_ms, "launch_only_ms": launch_ms,
            "host_us": pieces, "cuda_kernels_per_call": per_call,
            "cuda_kernel_names": names,
            "best_equal_plain_argmax": f"{best_equal}/64",
            "ties_first_index": f"{ties_first}/16",
            "plain_ms": plain_ms, "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None, "shape": {"K": k, "B": nb}}


def _bits(x):
    import torch
    return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[x.element_size()])


def _max_abs_err(a, b) -> float:
    """0.0 when ``a`` and ``b`` hold the same bits, else their largest
    absolute difference (inf if the bits differ where the values agree)."""
    import torch
    if torch.equal(_bits(a), _bits(b)):
        return 0.0
    d = float((a.float() - b.float()).abs().max())
    return d if d > 0 else float("inf")


def check_tier_compact(full, embed, rng) -> list:
    """B3/B4/B5 against their plain versions on the card, bit for bit, at
    this slice's shapes: the key-value drain (q = DRAIN_Q rows of the
    full-size pools' 4 float32) for B3/B4, and an ``inflight_cap``-sized
    Movement of the embedding store (merged rows of ``dim`` float32 from
    and into its pools; promotions from the slow pool) for all three.
    Each row's numbers are the mirror's shapes; ``kv_drain`` has B3/B4 at
    the drain's.  Bound: the bytes each launch must move (rows read and
    written once, indices and flags read once) at HBM_BYTES_PER_S."""
    import numpy as np
    import torch
    from repro_torch.core import compaction
    from repro_torch.kernels.tier_compact import ops, ref
    dev = torch.device("cuda")
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    flag = lambda a: torch.from_numpy(np.asarray(a, bool)).to(dev)
    bound = lambda nbytes: 1e3 * nbytes / HBM_BYTES_PER_S

    def pools(nf, ns, w):
        gen = torch.Generator(dev).manual_seed(int(rng.integers(1 << 30)))
        return (torch.randn((nf, w), device=dev, generator=gen),
                torch.randn((ns, w), device=dev, generator=gen))

    def measure(fast, slow, m, n_pro):
        """Inputs, checks and times at one shape; returns per-kernel
        (max_abs_err, ms, plain_ms, bound_ms, library_ms)."""
        nf, ns, w = fast.shape[0], slow.shape[0], fast.shape[1]
        rb = w * fast.element_size()
        src_slow = rng.random(m) < 0.5
        idx = np.where(src_slow, rng.integers(0, ns, m),
                       rng.integers(0, nf, m))
        sl_t, idx_t = flag(src_slow), i32(idx)
        dst_t = i32(rng.choice(ns, m, replace=False))
        valid = rng.random(m) > 0.1
        v_t = flag(valid)
        rows = torch.randn((m, w), device=dev)
        out = {}
        # B3
        err = _max_abs_err(ops.select_gather_rows(fast, slow, sl_t, idx_t),
                           ref.select_gather_rows_ref(fast, slow, sl_t,
                                                      idx_t))
        out["select_gather_rows"] = (
            err, cuda_ms(lambda: ops.select_gather_rows(fast, slow, sl_t,
                                                        idx_t), 50),
            cuda_ms(lambda: ref.select_gather_rows_ref(fast, slow, sl_t,
                                                       idx_t), 20),
            bound(m * (2 * rb + 5)), None)
        # B4: into a copy of the slow pool; the library call is
        # index_copy_ of the valid rows (masked before timing)
        tgt = slow.clone()
        want = ref.scatter_rows_ref(slow.clone(), dst_t, rows, v_t)
        err = _max_abs_err(ops.scatter_rows(tgt, dst_t, rows, v_t), want)
        del want
        keep = torch.nonzero(v_t).squeeze(1)
        d_v, r_v = dst_t[keep].long(), rows[keep]
        nv = int(valid.sum())
        out["scatter_rows"] = (
            err, cuda_ms(lambda: ops.scatter_rows(tgt, dst_t, rows, v_t), 50),
            cuda_ms(lambda: ref.scatter_rows_ref(tgt, dst_t, rows, v_t), 20),
            bound(nv * (2 * rb + 4) + m),
            cuda_ms(lambda: tgt.index_copy_(0, d_v, r_v), 50))
        del tgt
        # B5: the promotion gather from the slow pool
        p_idx = i32(rng.integers(0, ns, n_pro))
        err = _max_abs_err(ops.gather_rows(slow, p_idx),
                           ref.gather_rows_ref(slow, p_idx))
        p_long = p_idx.long()
        out["gather_rows"] = (
            err, cuda_ms(lambda: ops.gather_rows(slow, p_idx), 50),
            cuda_ms(lambda: ref.gather_rows_ref(slow, p_idx), 20),
            bound(n_pro * (2 * rb + 4)),
            cuda_ms(lambda: torch.index_select(slow, 0, p_long), 50))
        torch.cuda.synchronize()
        return out

    etier = embed.tier()
    capm = compaction.inflight_cap(etier)
    cap_s = 2 * etier.run_size * max(etier.range_fanout_i, 1)
    fast, slow = pools(etier.fast_slots, etier.slow_slots, embed.dim)
    mirror = measure(fast, slow, capm, cap_s)
    del fast, slow
    fast, slow = pools(full.fast_slots, full.slow_slots, full.value_width)
    drain = measure(fast, slow, DRAIN_Q, DRAIN_Q)
    del fast, slow
    torch.cuda.empty_cache()
    rows = []
    for name, line in (("select_gather_rows", 74), ("scatter_rows", 106),
                       ("gather_rows", 38)):
        err, ms, plain_ms, bound_ms, lib_ms = mirror[name]
        if err != 0.0 or (name != "gather_rows" and drain[name][0] != 0.0):
            raise AssertionError(f"{name} differs from its plain version")
        row = {"name": name, "route": "cuda",
               "source": "src/repro_torch/csrc/tier_compact.cu",
               "replaces": "src/repro/kernels/tier_compact/"
                           f"tier_compact.py:{line}",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": "bytes",
               "library_ms": lib_ms,
               "shape": {"M": capm if name != "gather_rows" else cap_s,
                         "W": embed.dim, "fast_rows": etier.fast_slots,
                         "slow_rows": etier.slow_slots}}
        if name != "gather_rows":
            _, dms, dplain, dbound, dlib = drain[name]
            row["kv_drain"] = {"M": DRAIN_Q, "W": full.value_width,
                               "ms": dms, "plain_ms": dplain,
                               "bound_ms": dbound, "library_ms": dlib}
        rows.append(row)
    return rows


# ------------------------------------------------------------ streams

class Zipf:
    """Bounded zipfian ranks (Gray et al., as YCSB) scrambled onto the key
    space by an affine bijection, so hot keys spread over the runs."""

    def __init__(self, n: int, theta: float = 0.99):
        import numpy as np
        self.n, self.theta = n, theta
        z = 0.0
        for a in range(1, n + 1, 1 << 24):
            r = np.arange(a, min(n, a + (1 << 24) - 1) + 1, dtype=np.float64)
            z += float(np.sum(r ** -theta))
        self.zetan = z
        zeta2 = 1.0 + 0.5 ** theta
        self.alpha = 1.0 / (1.0 - theta)
        self.eta = (1 - (2.0 / n) ** (1 - theta)) / (1 - zeta2 / z)

    def keys(self, rng, size: int):
        import numpy as np
        u = rng.random(size)
        uz = u * self.zetan
        rank = np.floor(self.n * (self.eta * u - self.eta + 1) ** self.alpha)
        rank = np.where(uz < 1.0, 0, np.where(uz < 1.0 + 0.5 ** self.theta,
                                              1, rank))
        rank = np.clip(rank, 0, self.n - 1).astype(np.int64)
        return ((rank * 2654435761 + 12345) % self.n).astype(np.int32)


def make_stream(rng, zipf, batch: int, n: int, mix: str, device):
    """``n`` client batches of ``mix`` ("A": 50/50 get/put batches, "C":
    gets, "E": scans of length 1..100), uploaded to ``device`` up front
    (generation and upload are set-up, not engine time)."""
    import numpy as np
    import torch
    kinds = [mix if mix != "A" else ("get" if rng.random() < 0.5 else "put")
             for _ in range(n)]
    keys = torch.from_numpy(zipf.keys(rng, n * batch).reshape(n, batch))
    lens = torch.from_numpy(rng.integers(1, 101, (n, batch)).astype(np.int32))
    return kinds, keys.to(device), lens.to(device)


def drive(db, stream, walls=None, record=None) -> None:
    """Run a stream through the facade; with ``walls``, synchronise after
    each step and record its wall time; with ``record``, keep every
    per-op result (the device tensors: no copy, no host read)."""
    import torch
    kinds, keys, lens = stream
    for i, kind in enumerate(kinds):
        t0 = time.perf_counter()
        if kind == "put":
            db.put(keys[i])
            res = ()
        elif kind in ("get", "C"):
            res = db.get(keys[i])
        else:
            res = (db.scan_ops(keys[i], lens[i]),)
        if walls is not None:
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if record is not None:
            record.append(res)


# ------------------------------------------------------------ phase 3

def engine_parity(batch: int, quantum: int = 0, base=None) -> dict:
    """One op stream at scale 1 through backend "cuda" on the card and
    "reference" on the card and on the CPU, at ``quantum``: every state
    leaf, counter and per-op result must agree.  With ``base`` (the
    quantum-0 runs), the tier state and results must also equal those of
    run to completion (the any-quantum contract).  Returns the line and
    the runs."""
    import numpy as np
    from repro_torch.configs.prismdb_kv import paper_tier_config
    from repro_torch.core.db import PrismDB
    cfg = paper_tier_config(scale=1)
    runs = {}
    for backend, device in (("cuda", "cuda"), ("reference", "cuda"),
                            ("reference", "cpu")):
        db = PrismDB(cfg, seed=0, backend=backend, device=device,
                     compaction_quantum=quantum)
        rng = np.random.default_rng(11)
        zipf = Zipf(cfg.key_space)
        pre = rng.permutation(cfg.key_space // 2).astype(np.int32)
        for i in range(0, pre.size, batch):
            db.put(pre[i:i + batch])
        results = []
        for mix, n in (("A", 12), ("C", 4), ("E", 4), ("A", 4)):
            for _ in range(n):
                keys = zipf.keys(rng, batch)
                kind = mix if mix != "A" else ("get" if rng.random() < 0.5
                                               else "put")
                if kind == "put":
                    db.put(keys)
                elif kind in ("get", "C"):
                    results.append([x.cpu().numpy() for x in db.get(keys)])
                else:
                    lens = rng.integers(1, 101, batch).astype(np.int32)
                    results.append([db.scan_ops(keys, lens).cpu().numpy()])
        db.delete(pre[:batch])
        results.append([x.cpu().numpy() for x in db.get(pre[:batch])])
        runs[backend, device] = (db, results)
    dk, rk = runs["cuda", "cuda"]
    comp = dk.counters["compactions"]
    if comp == 0:
        raise AssertionError("parity run made no compaction")
    out = {"phase": "parity", "scale": 1, "quantum": quantum,
           "compactions": comp}
    for (backend, device), (dr, rr) in runs.items():
        if (backend, device) != ("cuda", "cuda"):
            out[f"{backend}_{device}"] = _same_run(dk, rk, dr, rr)
    if base is not None:
        d0, r0 = base["cuda", "cuda"]
        out["tier_leaves_equal_quantum_0"] = _same_tier(d0, dk)
        for x, y in zip(r0, rk):
            for a, b in zip(x, y):
                if not np.array_equal(a, b):
                    raise AssertionError("per-op results differ from "
                                         "quantum 0's")
    out["ok"] = True
    return out, runs


def _leaves(x, path=""):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        for f in x._fields:
            yield from _leaves(getattr(x, f), f"{path}.{f}")
    elif isinstance(x, tuple):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")
    elif x is not None:
        yield path, x


def _same_tier(da, db) -> int:
    """Raise unless two facades hold bit-equal tier states; returns the
    number of leaves compared."""
    import torch
    a = dict(_leaves(da.estate.tier))
    b = dict(_leaves(db.estate.tier))
    for name, x in a.items():
        if not torch.equal(_bits(x).cpu(), _bits(b[name]).cpu()):
            raise AssertionError(f"tier leaf {name} differs")
    return len(a)


def _same_results(ra, rb) -> int:
    """Raise unless two runs' recorded per-op results are bit-equal;
    returns the number of steps compared."""
    import torch
    if len(ra) != len(rb):
        raise AssertionError("the runs recorded different step counts")
    for x, y in zip(ra, rb):
        for a, b in zip(x, y):
            if not torch.equal(_bits(a), _bits(b)):
                raise AssertionError("per-op results differ")
    return len(ra)


def _digest(tier) -> dict:
    """Per-leaf checksums of a tier state on the card: the sum of the
    leaf's 32-bit words (bytes for 1-byte leaves) and their sum weighted
    by position (int64, wrapping).  Compares full-size states without
    holding two of them."""
    import torch
    names, sums = [], []
    for name, x in _leaves(tier):
        flat = _bits(x.reshape(-1))
        s = torch.zeros(2, dtype=torch.int64, device=x.device)
        for a in range(0, flat.numel(), 1 << 26):
            w = flat[a:a + (1 << 26)].to(torch.int64)
            pos = torch.arange(a, a + w.numel(), device=w.device) \
                % 65521 + 1
            s += torch.stack([w.sum(), (w * pos).sum()])
        names.append(name)
        sums.append(s)
    # one host read for the whole state
    return {n: tuple(v) for n, v in zip(names, torch.stack(sums).tolist())}


def _same_run(dk, rk, dr, rr) -> dict:
    """Raise unless two runs of one stream agree: counters, every state
    leaf bit for bit (the MSC scores ``obs.ev_score`` and, in flight,
    ``comp.score`` to rtol 1e-5: the msc_score kernel sums in another
    order) and every per-op result."""
    import numpy as np
    from repro_torch.core import engine
    if dk.counters != dr.counters:
        raise AssertionError("counters differ between the runs")

    sk = dict(_leaves(engine.state_to_numpy(dk.estate)))
    sr = dict(_leaves(engine.state_to_numpy(dr.estate)))
    score_err = 0.0
    for name, a in sk.items():
        b = sr[name]
        if name in (".obs.ev_score", ".comp.score"):
            err = float(np.max(np.abs(a - b) / np.maximum(np.abs(b),
                                                           1e-30)))
            if err > 1e-5:
                raise AssertionError(f"{name} rel err {err}")
            score_err = max(score_err, err)
        elif not np.array_equal(np.atleast_1d(a).view(np.uint8),
                                np.atleast_1d(b).view(np.uint8)):
            raise AssertionError(f"state leaf {name} differs")
    for x, y in zip(rk, rr):
        for a, b in zip(x, y):
            if not np.array_equal(a, b):
                raise AssertionError("per-op results differ")
    return {"leaves_equal": len(sk), "score_max_rel_err": score_err}


# ------------------------------------------------------------ phase 4

def _orphan_keys(db):
    """Keys in run-structured rows whose run id has no directory entry
    (the run directory was full when they were written): unreachable by
    gets."""
    import torch
    st = db.estate.tier
    return torch.cat([k[(r >= db.cfg.max_runs) & (k >= 0)]
                      for r, k in zip(st.runs, st.keys[1:])])


def _check_readback(db, keys, batch: int, what: str,
                    orphans_ok: bool = False) -> int:
    """Raise unless every key of ``keys`` is found with value == key.  A
    failure says how many of the lost keys sit in orphaned slow rows (the
    reference's run-directory overflow, ROADMAP Queue 3, F1) and how many
    do not (a fault of the port).  With ``orphans_ok`` it raises for the
    latter alone and returns the count of the former."""
    import torch
    lost = []
    for i in range(0, keys.numel(), batch):
        k = keys[i:i + batch]
        vals, found, _ = db.get(k)
        ok = found & (vals == k[:, None].to(torch.float32)).all(dim=1)
        lost.append(k[~ok])
    lost = torch.cat(lost)
    orphaned = int(torch.isin(lost, _orphan_keys(db)).sum()) \
        if lost.numel() else 0
    if lost.numel() > (orphaned if orphans_ok else 0):
        raise AssertionError(
            f"read-back {what}: {lost.numel()} of {keys.numel()} keys not "
            f"found with value == key; {orphaned} of them in slow rows no "
            f"run-directory entry covers (reference fault), "
            f"{lost.numel() - orphaned} elsewhere (port fault)")
    return orphaned


@contextlib.contextmanager
def _spans(targets=None):
    """Wrap host functions (``targets``: (module, name) pairs; by default
    the quantized path's) in profiler ranges named after them, for the
    length of a traced window; yields the names.  ``drain_tick`` holds
    ``drain_quantum`` and ``record_drain``."""
    from torch.profiler import record_function
    from repro_torch.core import compaction, engine
    from repro_torch.obs import state as obs_state
    if targets is None:
        targets = ((engine, "drain_tick"), (compaction, "drain_quantum"),
                   (obs_state, "record_drain"), (compaction, "inflight_read"),
                   (compaction, "defer_adjust"))
    saved = [(m, n, getattr(m, n)) for m, n in targets]

    def wrap(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    for m, n, fn in saved:
        setattr(m, n, wrap(n, fn))
    try:
        yield [n for _, n, _ in saved]
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def select_range_profile(db) -> dict:
    """One ``msc.select_range`` on ``db``'s state and backend under the
    profiler (after one untraced call): its device time in all, by the
    function of ``select_range`` that launched it, and by operator (the
    top 8; the whole table to chiprun_out/profile_select_range.txt)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import mapper, msc, prng, tracker
    state, cfg = db.estate.tier, db.cfg
    call = lambda: msc.select_range(state, cfg, prng.PRNGKey(11),
                                    backend=db.ecfg.backend)
    call()
    torch.cuda.synchronize()
    with _spans(((msc, "candidate_ranges"), (tracker, "clock_histogram"),
                 (mapper, "pin_probabilities"),
                 (msc, "bucket_clock_hist"))) as names, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    # an operator's kernels count for the innermost wrapped function
    # around it; B2, launched by ctypes under no operator, is named apart
    by_span = dict.fromkeys(names, 0.0)
    for e in prof.events():
        us = getattr(e, "self_device_time_total", 0) \
            if e.device_type == torch.autograd.DeviceType.CPU else 0
        p = e
        while us and p is not None and p.name not in names:
            p = p.cpu_parent
        if us and p is not None:
            by_span[p.name] += us / 1e3
    ka = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    kern = [e for e in ka if not e.key.startswith(("aten::", "cuda"))
            and e.key not in names and e.key != "Command Buffer Full"]
    device_ms = sum(map(dev_us, kern)) / 1e3
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_select_range.txt").write_text(ka.table(
        sort_by="self_cuda_time_total", row_limit=60))
    return {"window_ms": 1e3 * window, "device_ms": device_ms,
            "kernels": sum(e.count for e in kern),
            "device_ms_by_function": by_span,
            "msc_score_kernel_ms": sum(dev_us(e) for e in kern
                                       if "msc_score" in e.key) / 1e3,
            "device_ms_elsewhere": device_ms - sum(by_span.values()),
            "top_ops_ms": [(e.key[:60], dev_us(e) / 1e3, e.count) for e in
                           sorted((e for e in ka if e.key.startswith(
                               "aten::")), key=dev_us, reverse=True)[:8]],
            "top_kernels_ms": [(e.key[:60], dev_us(e) / 1e3, e.count)
                               for e in sorted(kern, key=dev_us,
                                               reverse=True)[:8]]}


def main_path(scale: int, batch: int, seg: int, n_pre: int, device=None,
              profile_steps: int = 8, quantum: int = 0, record=None,
              pre_batch: int = 0):
    """The recipe through ``PrismDB(..., compaction_quantum=quantum)``;
    returns the phase line and the facade.  ``record`` (a list) receives
    every per-op result of the segments and the profiled window.  The
    preload puts ``pre_batch`` keys a step (0: ``batch``)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs.prismdb_kv import paper_tier_config
    from repro_torch.core import engine
    from repro_torch.core.db import PrismDB
    from repro_torch.obs import export
    cfg = paper_tier_config(scale=scale)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(1)
    t0 = time.time()
    zipf = Zipf(cfg.key_space)
    db = PrismDB(cfg, seed=0, backend="cuda", device=device,  # None: card
                 compaction_quantum=quantum)
    torch.cuda.synchronize()
    t_init = time.time() - t0

    kernels.reset_launches()
    engine.HOST_READS.n = 0
    pre = torch.from_numpy(rng.permutation(n_pre).astype(np.int32)).to(
        db.device)
    t0 = time.time()
    pre_batch = pre_batch or batch
    tick = max(n_pre // pre_batch // 10, 1)
    for j, i in enumerate(range(0, n_pre, pre_batch)):
        db.put(pre[i:i + pre_batch])
        if j % tick == tick - 1:
            print(f"# preload {i + pre_batch}/{n_pre} keys "
                  f"{time.time() - t0:.1f}s compactions "
                  f"{int(db.estate.tier.ctr.compactions)}", file=sys.stderr,
                  flush=True)
    torch.cuda.synchronize()
    t_pre = time.time() - t0
    out = {"phase": "main", "scale": scale, "quantum": quantum,
           "key_space": cfg.key_space,
           "fast_slots": cfg.fast_slots, "tracker_slots": cfg.tracker_slots,
           "max_runs": cfg.max_runs, "batch": batch, "init_s": t_init,
           "preload_keys": n_pre, "preload_batch": pre_batch,
           "preload_s": t_pre,
           "preload_steps": db.dispatches,
           "preload_compactions": db.counters["compactions"],
           "preload_ms_per_step": 1e3 * t_pre / max(db.dispatches, 1),
           "preload_host_reads_per_step": engine.HOST_READS.n
           / max(db.dispatches, 1),
           "runs_active_after_preload": int(
               db.estate.tier.dir_active[0].sum()),
           "segments": {}}

    # read-back: a sample of preloaded keys holds value == key
    n_chk = min(65536, n_pre)
    sample = pre[torch.randperm(n_pre, device=db.device,
                                generator=torch.Generator(db.device)
                                .manual_seed(5))[:n_chk]]
    _check_readback(db, sample, batch, "after the preload")
    out["readback_keys"] = n_chk

    for mix in ("A", "C", "E"):
        stream = make_stream(rng, zipf, batch, seg, mix, db.device)
        snap0, c0 = db.obs_snapshot(), db.counters
        d0, h0 = db.dispatches, engine.HOST_READS.n
        walls: list = []
        torch.cuda.synchronize()
        t0 = time.time()
        drive(db, stream, walls, record)
        dt = time.time() - t0
        snap, c1 = db.obs_snapshot(), db.counters
        q = export.quantiles_from_hist(
            export.hist_delta(snap, snap0),
            sums=export.hist_sum_delta(snap, snap0))
        w = np.asarray(walls) * 1e3
        out["segments"][mix] = {
            "steps": seg, "ops": seg * batch, "wall_s": dt,
            "ops_per_s": seg * batch / dt,
            "step_ms_p50": float(np.percentile(w, 50)),
            "step_ms_p90": float(np.percentile(w, 90)),
            "step_ms_max": float(w.max()),
            "compactions": c1["compactions"] - c0["compactions"],
            "modeled_us_p50": q["p50"], "modeled_us_p99": q["p99"],
            "modeled_us_p999": q["p999"],
            "host_reads_per_step": (engine.HOST_READS.n - h0)
            / max(db.dispatches - d0, 1)}

    # device busy share and device-to-host copies over a YCSB-A window
    # (the profiler's bookkeeping grows with the ops traced: a full-size
    # compaction step traces thousands, so that window is kept short)
    from torch.profiler import ProfilerActivity, profile
    stream = make_stream(rng, zipf, batch, profile_steps, "A", db.device)
    torch.cuda.synchronize()
    h0 = engine.HOST_READS.n
    with _spans() as names, profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        drive(db, stream, record=record)
        torch.cuda.synchronize()
        window = time.time() - t0
    ka = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    busy_us = sum(dev_us(e) for e in ka if not e.key.startswith("aten::")
                  and not e.key.startswith("cuda")
                  and e.key not in names)
    # a range shows twice, as its host range (the time kept here) and as
    # its span on the device's timeline (no host time)
    span_us = {n: sum(e.cpu_time_total for e in ka if e.key == n)
               for n in names}
    span_calls = {n: max([e.count for e in ka if e.key == n], default=0)
                  for n in names}
    out["profile"] = {
        "window_s": window, "steps": profile_steps,
        "device_busy_share": busy_us / 1e6 / window,
        "host_reads": engine.HOST_READS.n - h0,
        "dtoh_copies": sum(e.count for e in ka if "DtoH" in e.key),
        # host time inside each quantized-path function (the profiler's
        # own per-op cost included), per traced step
        "span_host_ms_per_step": {
            n: span_us[n] / 1e3 / profile_steps for n in names},
        "span_calls": span_calls,
        "top": [(e.key[:60], dev_us(e)) for e in sorted(
            (e for e in ka if e.key not in names), key=dev_us,
            reverse=True)[:8]]}
    OUT.mkdir(exist_ok=True)
    (OUT / f"profile_scale{scale}_q{quantum}.txt").write_text(ka.table(
        sort_by="self_cuda_time_total", row_limit=60))

    # deletes: deleted keys are gone, the rest of the sample is intact
    gone = sample[:batch]
    db.delete(gone)
    _, found, _ = db.get(gone)
    if bool(found.any()):
        raise AssertionError("deleted keys still found")
    _check_readback(db, sample[batch:], batch, "after the segments")
    out.update({
        "delete_ok": True,
        "orphaned_slow_rows": int(_orphan_keys(db).numel()),
        "runs_active": int(db.estate.tier.dir_active[0].sum()),
        "compactions": db.counters["compactions"],
        "steps": db.dispatches,
        "host_reads_per_step": engine.HOST_READS.n / db.dispatches,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": dict(kernels.LAUNCHES)})
    path = ["clock_update", "msc_score"] + (
        ["select_gather_rows", "scatter_rows"] if quantum else [])
    for name in path:
        if kernels.LAUNCHES[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 "main path")
    return out, db


# ------------------------------------------------------------ phase 4b

# The paper's traffic through PrismDB.run_workload (repro_torch.workloads):
# each segment restarts the stream from its own seed, so a phased
# scenario runs all its phases
WORKLOAD_SEGMENTS = tuple(("ycsb", k) for k in "ABCDEF") + tuple(
    ("twitter", c) for c in ("cluster39", "cluster19", "cluster51")) + (
    ("scenario", "hotset-shift"), ("scenario", "flash-crowd"))
WORKLOAD_BATCHES = 8           # client batches per workload segment
WORKLOAD_SEED = 100
WORKLOAD_PROFILE_STEPS = 8     # a YCSB-A window under the profiler
# three tiers: DRAM / 3D XPoint / QLC at the equal-budget slot split and
# per-tier costs of benchmarks/paper_benchmarks.py:496-498,549-551
# (TIER_SWEEP_DRAM, _XPOINT, _QLC and the tier-sweep-n3 slots)
THREE_TIER_COST = ((0.2, 0.2, 0.2, 0.2), (6.0, 10.0, 0.5, 1.0),
                   (391.0, 391.0, 0.5, 1.0))
THREE_TIER_SEGMENTS = (("ycsb", "A"), ("ycsb", "C"))
THREE_TIER_BATCHES = 32
# half the key space, as main preloads: below the run-directory overflow
# of every lower tier (ROADMAP Queue 3, F1), which the phase checks
THREE_TIER_PRELOAD_FRAC = 2
# keys deleted in the read-back: a delete batch's tombstones need free
# tier-0 slots (the reference drops those that find none, ROADMAP Queue
# 3, F5), and below the high watermark tier 0 keeps at least 2% of its
# key_space / 32 slots free (491 at SCALE)
THREE_TIER_DELETES = 256


def three_tier_config(scale: int):
    """``paper_tier_config(scale)`` as DRAM / XPoint / QLC tiers of
    key_space / 32, / 16 and the whole key space; ``fast_slots`` follows
    tier 0 (the pin budget's capacity guard reads it)."""
    from repro_torch.configs.prismdb_kv import paper_tier_config
    cfg = paper_tier_config(scale)
    ks = cfg.key_space
    return cfg._replace(fast_slots=ks // 32,
                        tier_slots=(ks // 32, ks // 16, ks))


def _work(kind: str, name: str, key_space: int, n: int):
    from repro_torch import workloads as W
    if kind == "ycsb":
        return W.ycsb(name)
    if kind == "twitter":
        return W.twitter(name)
    return W.scenario(name, key_space, n)


@contextlib.contextmanager
def _stepped(walls: list, record: list):
    """While open, every ``engine.engine_step`` synchronises after itself,
    appends its wall time to ``walls`` and its OpResult (device tensors:
    no host read) to ``record``."""
    import torch
    from repro_torch.core import engine
    orig = engine.engine_step

    def step(*a, **kw):
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        record.append(tuple(out[1]))
        return out

    engine.engine_step = step
    try:
        yield
    finally:
        engine.engine_step = orig


def _workload_leg(cfg, backend: str, segments, n_batches: int, n_pre: int,
                  quantum: int = 0, cost=None, log=None, device=None):
    """One leg of a workload phase: ``PrismDB(cfg)`` on ``backend``,
    preloaded with ``n_pre`` keys, then each segment through
    ``run_workload`` with every step timed; on backend "cuda", a profiled
    window on a copy (``_dtoh_probe``).  Returns (line, db, records) with
    ``records`` the per-segment StepStats, per-op results, compaction
    counts and tier checksums."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import engine
    from repro_torch.core.db import PrismDB
    from repro_torch.obs.state import ObsConfig
    torch.cuda.reset_peak_memory_stats()
    db = PrismDB(cfg, seed=0, backend=backend, device=device,
                 compaction_quantum=quantum,
                 obs=ObsConfig(cost=cost) if cost else None)
    kernels.reset_launches()
    engine.HOST_READS.n = 0
    pre = torch.from_numpy(np.random.default_rng(1).permutation(n_pre)
                           .astype(np.int32)).to(db.device)
    rec = {"stats": [], "results": [], "comps": [], "digests": []}
    out = {"backend": backend, "preload_keys": n_pre, "segments": {}}
    # the near-tie log covers every slab compaction, the preload's too
    scoring = _score_log(log) if log is not None else \
        contextlib.nullcontext()
    with scoring:
        t0 = time.time()
        for i in range(0, n_pre, BATCH):
            db.put(pre[i:i + BATCH])
        torch.cuda.synchronize()
        out["preload_s"] = time.time() - t0
        out["preload_comp_by_boundary"] = db.counters["comp_by_boundary"]
        for j, (kind, name) in enumerate(segments):
            work = _work(kind, name, cfg.key_space, n_batches)
            db.reset_workload(seed=WORKLOAD_SEED + j)
            c0, l0 = db.counters, dict(kernels.LAUNCHES)
            h0, walls, res = engine.HOST_READS.n, [], []
            with _stepped(walls, res):
                t0 = time.time()
                st = db.run_workload(work, n_batches, BATCH)
                dt = time.time() - t0
            c1, w = db.counters, np.asarray(walls) * 1e3
            seg = {"ops_per_s": n_batches * BATCH / dt,
                   "step_ms_p50": float(np.percentile(w, 50)),
                   "step_ms_p90": float(np.percentile(w, 90)),
                   "compactions": c1["compactions"] - c0["compactions"],
                   "host_reads_per_step":
                       (engine.HOST_READS.n - h0) / n_batches,
                   "launches": {k: kernels.LAUNCHES[k] - l0[k]
                                for k in kernels.LAUNCHES
                                if kernels.LAUNCHES[k] > l0[k]},
                   "kinds": torch.bincount(st.kind.long(), minlength=4)
                   .tolist(), "scan_keys": int(st.returned.sum())}
            if cfg.n_tiers > 2:
                seg["comp_by_boundary"] = [
                    a - b for a, b in zip(c1["comp_by_boundary"],
                                          c0["comp_by_boundary"])]
            out["segments"][f"{kind}-{name}"] = seg
            rec["stats"].append(st)
            rec["results"].append(res)
            rec["comps"].append(c1["comp_by_boundary"][0])
            rec["digests"].append(_digest(db.estate.tier))
    rec["end"] = _digest(db.estate.tier)
    c = db.counters
    out.update({"steps": db.dispatches,
                "host_reads_per_step": engine.HOST_READS.n / db.dispatches,
                "compactions": c["compactions"],
                "comp_by_boundary": c["comp_by_boundary"],
                "orphaned_rows": int(_orphan_keys(db).numel()),
                "max_memory_allocated_gib":
                    torch.cuda.max_memory_allocated() / 2**30,
                "launches": dict(kernels.LAUNCHES)})
    if backend == "cuda" and device is None:
        out["profile"] = _dtoh_probe(db)
    return out, db, rec


def _d2h_counter():
    """A dispatch mode counting the operators that take a CUDA tensor and
    give a host tensor (``_to_copy`` to the CPU, ``copy_`` into a host
    tensor) or a host scalar (``_local_scalar_dense``, under ``item``), as
    PyTorch's dispatcher sees them: every device-to-host copy, whatever
    the profiler records."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class D2H(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(getattr(a, "is_cuda", False) for a in args) and (
                    "_local_scalar_dense" in str(func)
                    or (hasattr(out, "is_cuda") and not out.is_cuda)):
                self.n += 1
            return out

    return D2H()


def _dtoh_probe(db) -> dict:
    """A YCSB-A window of WORKLOAD_PROFILE_STEPS steps on two copies of
    ``db`` (``db`` keeps its state): one under the profiler (the device
    busy share, and CUPTI's count of device-to-host copies, which must
    not exceed the engine's host reads), one under a dispatch-mode count
    of every device-to-host copy, which must equal them.  CUPTI has
    dropped copy records late in a long process (PERF.md §7), so the
    equality is held on the dispatcher's count."""
    import copy
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import workloads as W
    from repro_torch.core import engine
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))

    def window(ctx):
        probe = copy.copy(db)
        probe.estate = engine.dealias(db.estate)
        h0 = engine.HOST_READS.n
        torch.cuda.synchronize()
        with ctx:
            t0 = time.time()
            probe.run_workload(W.ycsb("A"), WORKLOAD_PROFILE_STEPS, BATCH)
            torch.cuda.synchronize()
            dt = time.time() - t0
        return engine.HOST_READS.n - h0, dt

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    reads, dt = window(prof)
    ka = prof.key_averages()
    count = _d2h_counter()
    reads2, _ = window(count)
    out = {"steps": WORKLOAD_PROFILE_STEPS, "window_s": dt,
           "device_busy_share": sum(
               dev_us(e) for e in ka if not e.key.startswith(
                   ("aten::", "cuda")) and e.key != "Command Buffer Full")
           / 1e6 / dt,
           "host_reads": reads,
           "dtoh_copies_profiler": sum(e.count for e in ka
                                       if "DtoH" in e.key),
           "dtoh_copies": count.n}
    if count.n != reads2 or reads2 != reads \
            or out["dtoh_copies_profiler"] > reads:
        raise AssertionError(f"device-to-host copies differ from the "
                             f"engine's host reads: {out}")
    return out


def _compare_legs(a: dict, b: dict, log) -> dict:
    """Two legs' records: StepStats and per-op results of every segment
    equal up to the first segment whose tier checksums differ, end states
    equal, or parted there only at an msc_score near-tie
    (``_explain_divergence``, segment by segment)."""
    import torch
    why = _explain_divergence(log or [], a["comps"], {
        "cuda": a["digests"], "reference": b["digests"]})
    first = why["first_step_tier_differs"]
    n = len(a["stats"]) if first is None else first + 1
    for j in range(n):
        for x, y in zip(a["stats"][j], b["stats"][j]):
            if not torch.equal(x.cpu(), y.cpu()):
                raise AssertionError(f"segment {j}: StepStats differ")
        _same_results(a["results"][j], b["results"][j])
    if first is None and a["end"] != b["end"]:
        raise AssertionError("end states differ")
    return {"segments_equal": n if first is None else first,
            "end_equal": a["end"] == b["end"], "divergence": why}


def _acked_keys(db, segments, n_batches: int, pre, n: int, seed: int):
    """``n`` distinct keys drawn from the preload and from every put the
    segments made (their streams drawn again on the host)."""
    import numpy as np
    import torch
    from repro_torch import workloads as W
    from repro_torch.core import engine, prng
    keys = [pre.cpu()]
    for j, (kind, name) in enumerate(segments):
        ops, _ = W.sample_ops(prng.PRNGKey(WORKLOAD_SEED + j),
                              _work(kind, name, db.cfg.key_space,
                                    n_batches), n_batches, BATCH,
                              key_space=db.cfg.key_space,
                              value_width=db.cfg.value_width, device="cpu")
        keys.append(ops.keys[ops.kind == engine.PUT].reshape(-1))
    allk = torch.unique(torch.cat(keys)).numpy()
    pick = np.random.default_rng(seed).choice(allk, min(n, allk.size),
                                              replace=False)
    return torch.from_numpy(pick.astype(np.int32)).to(db.device)


def workloads_phase(device=None) -> dict:
    """``PrismDB(paper_tier_config(SCALE))`` with a 50% preload through
    ``run_workload``: YCSB A-F, the three Twitter clusters, hotset-shift
    and flash-crowd, WORKLOAD_BATCHES batches each, on backend "cuda" and
    again "reference" on the card.  Every segment's StepStats and per-op
    results and the end states equal (or parted only at an msc_score
    near-tie), B1 and B2 launched on the "cuda" leg, YCSB-E returns scan
    keys, device-to-host copies equal the engine's host reads
    (``_dtoh_probe``), and a sample of acknowledged writes reads back
    with value == key, but for those in rows the reference's full run
    directory orphaned (F1, counted)."""
    import numpy as np
    import torch
    from repro_torch.configs.prismdb_kv import paper_tier_config
    cfg = paper_tier_config(SCALE)
    n_pre = cfg.key_space // 2
    out = {"phase": "workloads", "scale": SCALE, "key_space": cfg.key_space,
           "batch": BATCH, "batches_per_segment": WORKLOAD_BATCHES}
    recs, log, dbs = {}, [], {}
    for leg in ("cuda", "reference"):
        out[leg], dbs[leg], recs[leg] = _workload_leg(
            cfg, leg, WORKLOAD_SEGMENTS, WORKLOAD_BATCHES, n_pre,
            log=log if leg == "cuda" else None, device=device)
        print(f"# workloads {leg}: {out[leg]['compactions']} compactions",
              file=sys.stderr, flush=True)
        if leg == "reference":
            del dbs[leg]
            torch.cuda.empty_cache()
    out["legs"] = _compare_legs(recs["cuda"], recs["reference"], log)
    fails = []
    if not out["legs"]["divergence"]["explained"]:
        fails.append("the legs part where no msc_score near-tie accounts "
                     "for it")
    cu = out["cuda"]
    for name in ("clock_update", "msc_score"):
        if cu["launches"][name] <= 0:
            fails.append(f"kernel {name} never launched")
    if cu["segments"]["ycsb-E"]["scan_keys"] <= 0:
        fails.append("YCSB-E returned no scan keys")
    if fails:
        emit(out)
        raise AssertionError("workloads: " + "; ".join(fails))
    db = dbs["cuda"]
    pre = torch.from_numpy(np.random.default_rng(1).permutation(n_pre)
                           .astype(np.int32))
    sample = _acked_keys(db, WORKLOAD_SEGMENTS, WORKLOAD_BATCHES, pre,
                         65536, seed=5)
    # the 50% preload and the segments' puts fill the run directory: the
    # reference orphans rows (F1), and the port with it; every other
    # acknowledged write must read back
    out["readback_keys"] = int(sample.numel())
    out["readback_lost_to_f1"] = _check_readback(
        db, sample, BATCH, "after the workloads", orphans_ok=True)
    out["ok"] = True
    return out


def three_tier_phase(quantum: int = 0, base=None, device=None):
    """``three_tier_config(SCALE)`` priced with THREE_TIER_COST, preloaded
    with key_space / THREE_TIER_PRELOAD_FRAC keys, then YCSB-A and
    YCSB-C through ``run_workload``; at quantum 0 on backend "cuda" and
    again "reference" (equal, or parted only at an msc_score near-tie),
    at ``quantum`` > 0 on "cuda" alone, whose per-op results and end
    state must equal those of ``base`` (the quantum-0 "cuda" leg's
    records).  Both boundaries compact, per-boundary events equal
    per-boundary commits, every tier within its slots, no orphaned row,
    the device time of one deep compaction, and read-back of sampled
    preloaded keys and of deleted ones.  Returns (line, records)."""
    import numpy as np
    import torch
    from repro_torch.core import compaction, engine
    from repro_torch.obs.cost import CostModel, TierCost
    cfg = three_tier_config(SCALE)
    cost = CostModel(tiers=tuple(TierCost(*c) for c in THREE_TIER_COST))
    n_pre = cfg.key_space // THREE_TIER_PRELOAD_FRAC
    out = {"phase": "three_tier_quantum" if quantum else "three_tier",
           "scale": SCALE, "quantum": quantum, "tier_slots": cfg.tier_slots,
           "max_runs": cfg.max_runs, "run_size": cfg.run_size,
           "cost": THREE_TIER_COST, "batch": BATCH,
           "batches_per_segment": THREE_TIER_BATCHES}
    legs = ("cuda", "reference") if quantum == 0 else ("cuda",)
    recs, log, dbs = {}, [], {}
    for leg in legs:
        out[leg], dbs[leg], recs[leg] = _workload_leg(
            cfg, leg, THREE_TIER_SEGMENTS, THREE_TIER_BATCHES, n_pre,
            quantum=quantum, cost=cost,
            log=log if leg == "cuda" and quantum == 0 else None,
            device=device)
        print(f"# {out['phase']} {leg}: comp_by_boundary "
              f"{out[leg]['comp_by_boundary']}", file=sys.stderr, flush=True)
    fails = []
    if quantum == 0:
        out["legs"] = _compare_legs(recs["cuda"], recs["reference"], log)
        if not out["legs"]["divergence"]["explained"]:
            fails.append("the legs part where no msc_score near-tie "
                         "accounts for it")
        del dbs["reference"]
        torch.cuda.empty_cache()
    else:
        for a, b in zip(base["results"], recs["cuda"]["results"]):
            _same_results(a, b)
        if base["end"] != recs["cuda"]["end"]:
            fails.append("the end state differs from three_tier's")
        out["results_and_state_equal_three_tier"] = not fails
    db, cu = dbs["cuda"], out["cuda"]
    snap = db.obs_snapshot()
    cbb = cu["comp_by_boundary"]
    if min(cbb) <= 0:
        fails.append(f"a boundary never compacted: {cbb}")
    if snap["ev_jobs_b"].tolist() != cbb:
        fails.append("per-boundary events differ from per-boundary "
                     "commits")
    used = [int((k >= 0).sum()) for k in db.estate.tier.keys]
    cu["tier_rows"] = used
    if any(u > n for u, n in zip(used, cfg.tier_slots)):
        fails.append(f"a tier holds more rows than its slots: {used}")
    if cu["orphaned_rows"]:
        fails.append(f"{cu['orphaned_rows']} orphaned rows (F1): lower "
                     "the preload")
    path = ["clock_update", "msc_score"] + (
        ["select_gather_rows", "scatter_rows"] if quantum else [])
    for name in path:
        if cu["launches"][name] <= 0:
            fails.append(f"kernel {name} never launched")
    if fails:
        emit(out)
        raise AssertionError(f"{out['phase']}: " + "; ".join(fails))
    if device is None:
        # one deep compaction on copies of the end state: a warm-up, one
        # between CUDA events, one under the profiler
        copies = [engine.dealias(db.estate.tier) for _ in range(3)]
        deep = lambda: compaction.compact_boundary(copies.pop(), cfg, 1,
                                                   cost=cost)
        deep()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        deep()
        b.record()
        torch.cuda.synchronize()
        prof = _profiled(deep, f"profile_deep_compaction_q{quantum}.txt")
        out["deep_compaction"] = {
            "event_ms": a.elapsed_time(b),
            "device_ms": prof["device_busy_share"] * prof["window_s"] * 1e3,
            "window_ms": prof["window_s"] * 1e3, "top_ms": prof["top_ms"]}
    # read-back: sampled preloaded keys, then deleted ones are gone
    pre = torch.from_numpy(np.random.default_rng(1).permutation(n_pre)
                           .astype(np.int32)).to(db.device)
    sample = pre[torch.randperm(n_pre, device=db.device, generator=torch
                                .Generator(db.device).manual_seed(5))[:65536]]
    _check_readback(db, sample, BATCH, "after the three-tier run")
    gone = sample[:THREE_TIER_DELETES]
    db.delete(gone)
    _, found, _ = db.get(gone)
    if bool(found.any()):
        raise AssertionError("deleted keys still found")
    _check_readback(db, sample[THREE_TIER_DELETES:], BATCH,
                    "after the deletes")
    out.update({"readback_keys": int(sample.numel()), "delete_ok": True,
                "ok": True})
    return out, recs["cuda"]


# ------------------------------------------------------------ phase 4d

# The partitioned store: PART_P shared-nothing partitions of
# paper_tier_config(SCALE), each provisioned for the whole key space as
# the JAX package's routed path provisions them.  main's preload goes
# through the router (pad 2 * BATCH / PART_P a partition), then
# PART_SEGMENT routed batches alternate put and get, then one tenant a
# partition runs PART_TENANT_BATCHES batches over its own partition.
PART_P = 4
PART_SEGMENT = 32
PART_TENANTS = (("ycsb", "A"), ("ycsb", "B"), ("ycsb", "C"),
                ("twitter", "cluster39"))
PART_TENANT_BATCHES = 16
PART_SEED = 300
PART_TRACE_PUTS = 2            # routed puts in the maybe_trace window
PART_TRACE_NAMES = {"clock_update": "clock_apply",
                    "msc_score": "msc_score_kernel"}


@contextlib.contextmanager
def _per_call(module, name: str, calls: list):
    """While open, every call of ``module.name`` synchronises after
    itself and appends (wall seconds, host reads) to ``calls``."""
    import torch
    from repro_torch.core import engine
    orig = getattr(module, name)

    def run(*a, **kw):
        t0, h0 = time.perf_counter(), engine.HOST_READS.n
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        calls.append((time.perf_counter() - t0, engine.HOST_READS.n - h0))
        return out

    setattr(module, name, run)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def _partitioned_inputs(cfg):
    """(preload keys, routed segment keys [PART_SEGMENT, BATCH], tenant
    workloads) of the partitioned phase, on the host."""
    import numpy as np
    import torch
    n_pre = cfg.key_space // 2
    pre = torch.from_numpy(np.random.default_rng(1).permutation(n_pre)
                           .astype(np.int32))
    seg = torch.from_numpy(np.random.default_rng(PART_SEED).integers(
        0, cfg.key_space, (PART_SEGMENT, BATCH)).astype(np.int32))
    works = [_work(k, n, cfg.key_space, PART_TENANT_BATCHES)
             for k, n in PART_TENANTS]
    return pre, seg, works


def _partitioned_leg(cfg, backend: str, quantum: int = 0,
                     tenants: bool = True, log=None, device=None):
    """One leg of the partitioned phase: ``PartitionedDB(cfg, PART_P)`` on
    ``backend``, the routed preload, the routed segment and (with
    ``tenants``) the multi-tenant run.  Returns (line, db, records) with
    the records' per-partition tier checksums and cumulative compactions
    after each part (for ``_explain_divergence``)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch import workloads as W
    from repro_torch.core import engine
    from repro_torch.core.db import PartitionedDB
    torch.cuda.reset_peak_memory_stats()
    db = PartitionedDB(cfg, PART_P, seed=0, backend=backend,
                       compaction_quantum=quantum, device=device)
    kernels.reset_launches()
    engine.HOST_READS.n = 0
    pre, seg, works = _partitioned_inputs(cfg)
    pre, seg = pre.to(db.device), seg.to(db.device)
    rec = {"digests": [], "comps": [], "sent": 0}
    out = {"backend": backend, "quantum": quantum}

    def mark():
        rec["digests"].append([_digest(e.tier) for e in db.estates])
        rec["comps"].append(sum(db.counters["compactions"]))

    scoring = _score_log(log) if log is not None else \
        contextlib.nullcontext()
    with scoring:
        t0 = time.time()
        for i in range(0, pre.numel(), BATCH):
            db.put(pre[i:i + BATCH])
        torch.cuda.synchronize()
        rec["sent"] += pre.numel()
        out.update({"preload_s": time.time() - t0,
                    "preload_batches": db.dispatches,
                    "preload_compactions": db.counters["compactions"],
                    "preload_dropped": db.dropped})
        mark()
        walls, h0, d0 = [], db.host_reads, db.dispatches
        c0 = sum(db.counters["compactions"])
        t0 = time.time()
        for j in range(PART_SEGMENT):
            t1 = time.perf_counter()
            (db.put if j % 2 == 0 else db.get)(seg[j])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        dt = time.time() - t0
        rec["sent"] += seg.numel()
        w = np.asarray(walls) * 1e3
        out["routed"] = {
            "batches": PART_SEGMENT, "ops_per_s": seg.numel() / dt,
            "batch_ms_p50": float(np.percentile(w, 50)),
            "batch_ms_p90": float(np.percentile(w, 90)),
            "host_reads_per_batch":
                (db.host_reads - h0) / (db.dispatches - d0),
            "compactions": sum(db.counters["compactions"]) - c0}
        mark()
        if tenants:
            db.reset_workload(seed=PART_SEED)
            c0 = db.counters["compactions"]
            walls, calls = [], []
            with _stepped(walls, []), \
                    _per_call(W.runner, "run_schedule", calls):
                st = db.run_workload(works, PART_TENANT_BATCHES, BATCH)
            c1, t = db.counters["compactions"], PART_TENANT_BATCHES
            out["tenants"] = {
                f"{k}-{n}": {
                    "ops_per_s": t * BATCH / calls[i][0],
                    "step_ms_p50": float(np.percentile(
                        walls[i * t:(i + 1) * t], 50) * 1e3),
                    "step_ms_p90": float(np.percentile(
                        walls[i * t:(i + 1) * t], 90) * 1e3),
                    "host_reads_per_step": calls[i][1] / t,
                    "compactions": c1[i] - c0[i],
                    "kinds": torch.bincount(st.kind[i].long(),
                                            minlength=4).tolist()}
                for i, (k, n) in enumerate(PART_TENANTS)}
            rec["tenant_ops"] = PART_P * t * BATCH
            mark()
    c = db.counters
    out.update({"batches": db.dispatches,
                "host_reads": db.host_reads,
                "compactions": c["compactions"], "dropped": db.dropped,
                "max_memory_allocated_gib":
                    torch.cuda.max_memory_allocated() / 2**30,
                "launches": dict(kernels.LAUNCHES)})
    return out, db, rec


def _partitioned_readback(db, keys) -> dict:
    """Routed gets of ``keys``: every lane the router placed must be found
    with value == key, but for keys in rows that a full run directory
    orphaned (F1, counted apart)."""
    import torch
    from repro_torch.core.db import route_batch
    lost, unrouted = [], 0
    for i in range(0, keys.numel(), BATCH):
        k = keys[i:i + BATCH]
        routed, valid, _ = route_batch(k, db.p, max(2 * k.numel() // db.p,
                                                    8))
        vals, found, _ = db.get(k)
        ok = found & (vals == routed[..., None].to(torch.float32)).all(-1)
        lost.append(routed[valid & ~ok])
        unrouted += k.numel() - int(valid.sum())
    lost = torch.cat(lost)
    orphans = torch.cat([
        k[(r >= db.cfg.max_runs) & (k >= 0)] for e in db.estates
        for r, k in zip(e.tier.runs, e.tier.keys[1:])])
    in_f1 = int(torch.isin(lost, orphans).sum()) if lost.numel() else 0
    if lost.numel() > in_f1:
        raise AssertionError(
            f"partitioned read-back: {lost.numel()} of {keys.numel()} "
            f"routed writes not found with value == key, {in_f1} of them "
            "in orphaned rows (F1)")
    return {"keys": int(keys.numel()), "lost_to_f1": in_f1,
            "orphaned_rows": int(orphans.numel()),
            "get_lanes_over_the_pad": unrouted}


def _lone_partition0(db, cfg, pre, seg, work0) -> int:
    """Shared nothing: a lone engine from partition 0's split key, fed
    partition 0's routed rows and valid masks of the preload and the
    routed segment, then tenant 0's stream drawn again on the host, must
    equal ``db``'s partition 0 leaf for leaf.  Returns the leaves
    compared."""
    import torch
    from repro_torch import workloads as W
    from repro_torch.core import engine, prng
    from repro_torch.core.db import route_batch
    est = engine.init(db.ecfg, prng.split(prng.PRNGKey(0), db.p)[0],
                      device=db.device)
    batches = [(engine.PUT, pre[i:i + BATCH])
               for i in range(0, pre.numel(), BATCH)]
    batches += [(engine.PUT if j % 2 == 0 else engine.GET, seg[j])
                for j in range(PART_SEGMENT)]
    for kind, k in batches:
        k = k.to(db.device)
        routed, valid, _ = route_batch(k, db.p, max(2 * k.numel() // db.p,
                                                    8))
        est, _ = engine.engine_step(est, engine.make_op(
            kind, routed[0], valid=valid[0], value_width=cfg.value_width,
            device=db.device), db.ecfg)
    ops, _ = W.sample_ops(prng.split(prng.PRNGKey(PART_SEED), db.p)[0],
                          work0, PART_TENANT_BATCHES, BATCH,
                          key_space=cfg.key_space,
                          value_width=cfg.value_width, device=db.device)
    est, _ = engine.run_ops(est, ops, db.ecfg)
    a, b = dict(_leaves(est)), dict(_leaves(db.estates[0]))
    if a.keys() != b.keys():
        raise AssertionError("partition 0 and the lone engine differ in "
                             "structure")
    for name, x in a.items():
        if not torch.equal(_bits(x).cpu(), _bits(b[name]).cpu()):
            raise AssertionError(f"shared nothing: partition 0's {name} "
                                 "differs from a lone engine's")
    return len(a)


def _trace_kernels(db, cfg) -> dict:
    """PART_TRACE_PUTS routed puts of fresh uniform keys under
    ``obs.maybe_trace``: the Chrome trace must hold a B1 and a B2 kernel
    event (a trace with no device event at all, CUPTI delivering nothing,
    is taken again once).  Returns the counts and the keys sent."""
    import glob
    import numpy as np
    import torch
    from repro_torch.obs import maybe_trace
    rng = np.random.default_rng(PART_SEED + 1)
    where = OUT / "trace_partitioned"
    sent = 0
    for attempt in range(2):
        for f in glob.glob(str(where / "trace_*.json")):
            Path(f).unlink()
        keys = torch.from_numpy(rng.integers(
            0, cfg.key_space, (PART_TRACE_PUTS, BATCH)).astype(np.int32)
            ).to(db.device)
        c0 = sum(db.counters["compactions"])
        with maybe_trace(str(where)):
            for k in keys:
                db.put(k)
        sent += keys.numel()
        comps = sum(db.counters["compactions"]) - c0
        (path,) = glob.glob(str(where / "trace_*.json"))
        events = json.loads(Path(path).read_text())["traceEvents"]
        kern = [e.get("name", "") for e in events
                if e.get("cat") == "kernel"]
        found = {k: sum(v in n for n in kern)
                 for k, v in PART_TRACE_NAMES.items()}
        if kern:
            break
    out = {"trace": str(Path(path).relative_to(ROOT)),
           "trace_mib": Path(path).stat().st_size / 2**20,
           "kernel_events": len(kern), "compactions": comps,
           "attempts": attempt + 1, **found, "keys_sent": sent}
    if min(found.values()) <= 0:
        raise AssertionError(f"partitioned: the trace holds no B1 or no B2 "
                             f"kernel event: {out}")
    return out


def partitioned_phase(device=None) -> dict:
    """``PartitionedDB(paper_tier_config(SCALE), PART_P)``: main's preload
    routed, PART_SEGMENT routed batches alternating put and get, then the
    PART_TENANTS tenants, one a partition, through ``run_workload``; on
    backend "cuda" and again "reference" (per-partition counters, drops,
    every tier leaf and the obs histograms equal, or parted only at an
    msc_score near-tie), and the preload and routed segment again at
    quantum DRAIN_Q on "cuda" (B3/B4 launch, the tier state equals run to
    completion's).  Shared nothing (``_lone_partition0``), routed writes
    read back, a batch of BATCH identical keys drops BATCH - BATCH /
    PART_P * 2, the merged snapshot's histogram mass equals the routed
    valid lanes plus the tenants' ops, the snapshot as JSON lines, and a
    ``maybe_trace`` window with B1 and B2 in it."""
    import numpy as np
    import torch
    from repro_torch.configs.prismdb_kv import paper_tier_config
    from repro_torch.obs import export
    cfg = paper_tier_config(SCALE)
    t_phase = time.time()
    out = {"phase": "partitioned", "partitions": PART_P, "scale": SCALE,
           "scale_cut": "paper_tier_config(12) of the paper's 1536: a 50% "
           "preload fills the run directory at larger scales (F1)",
           "key_space": cfg.key_space, "fast_slots": cfg.fast_slots,
           "batch": BATCH, "pad": max(2 * BATCH // PART_P, 8),
           "preload_keys": cfg.key_space // 2,
           "routed_batches": PART_SEGMENT,
           "tenants": [f"{k}-{n}" for k, n in PART_TENANTS],
           "tenant_batches": PART_TENANT_BATCHES}
    log, recs, dbs = [], {}, {}
    for leg in ("cuda", "reference"):
        out[leg], dbs[leg], recs[leg] = _partitioned_leg(
            cfg, leg, log=log if leg == "cuda" else None, device=device)
        print(f"# partitioned {leg}: {out[leg]['compactions']} compactions",
              file=sys.stderr, flush=True)
    a, b = dbs["cuda"], dbs["reference"]
    why = _explain_divergence(log, recs["cuda"]["comps"], {
        "cuda": recs["cuda"]["digests"],
        "reference": recs["reference"]["digests"]})
    out["legs"] = {"divergence": why}
    fails = []
    if why["first_step_tier_differs"] is None:
        out["legs"].update({
            "counters_equal": a.counters == b.counters,
            "dropped_equal": a.dropped_per_partition
            == b.dropped_per_partition,
            "hist_equal": bool(np.array_equal(
                a.obs_snapshot()["hist"], b.obs_snapshot()["hist"]))})
        fails += [f"{k} is false" for k, v in out["legs"].items()
                  if k != "divergence" and not v]
    elif not why["explained"]:
        fails.append("the legs part where no msc_score near-tie accounts "
                     "for it")
    del dbs["reference"], b
    torch.cuda.empty_cache()
    for name in ("clock_update", "msc_score"):
        if out["cuda"]["launches"][name] <= 0:
            fails.append(f"kernel {name} never launched")
    # the preload and routed segment at quantum DRAIN_Q
    out["cuda_quantum"], dbq, recq = _partitioned_leg(
        cfg, "cuda", quantum=DRAIN_Q, tenants=False, device=device)
    out["cuda_quantum"]["tier_equal_cuda"] = \
        recq["digests"] == recs["cuda"]["digests"][:2]
    if not out["cuda_quantum"]["tier_equal_cuda"]:
        fails.append("the quantized leg's tier state differs from run to "
                     "completion's")
    for name in ("select_gather_rows", "scatter_rows"):
        if out["cuda_quantum"]["launches"][name] <= 0:
            fails.append(f"kernel {name} never launched at quantum")
    del dbq
    torch.cuda.empty_cache()
    if fails:
        emit(out)
        raise AssertionError("partitioned: " + "; ".join(fails))

    db, rec = a, recs["cuda"]
    pre, seg, works = _partitioned_inputs(cfg)
    out["shared_nothing_leaves_equal"] = _lone_partition0(db, cfg, pre, seg,
                                                          works[0])
    # routed read-back: a sample of the routed puts the router placed
    from repro_torch.core.db import route_batch
    acked = []
    for k in list(pre.split(BATCH)) + list(seg[0::2]):
        routed, valid, _ = route_batch(k.to(db.device), PART_P,
                                       2 * BATCH // PART_P)
        acked.append(routed[valid].cpu())
    acked = torch.unique(torch.cat(acked))
    pick = np.random.default_rng(5).choice(
        acked.numel(), min(65536, acked.numel()), replace=False)
    sample = acked[torch.from_numpy(pick)].to(db.device)
    out["readback"] = _partitioned_readback(db, sample)
    rec["sent"] += sample.numel()
    d0 = db.dropped
    db.put(torch.full((BATCH,), 7, dtype=torch.int32, device=db.device))
    rec["sent"] += BATCH
    out["identical_keys_dropped"] = db.dropped - d0
    if out["identical_keys_dropped"] != BATCH - 2 * BATCH // PART_P:
        fails.append(f"{BATCH} identical keys dropped "
                     f"{out['identical_keys_dropped']}")
    if device is None:
        out["trace"] = _trace_kernels(db, cfg)
        rec["sent"] += out["trace"]["keys_sent"]
    snap = db.obs_snapshot()
    want = rec["sent"] - db.dropped + rec["tenant_ops"]
    out["hist_mass"] = {"merged": int(snap["hist"].sum()), "want": want}
    if out["hist_mass"]["merged"] != want:
        fails.append(f"merged histogram mass {out['hist_mass']}")
    out["jsonl_records"] = export.write_jsonl(
        OUT / "partitioned.jsonl", snap, meta={"phase": "partitioned"})
    out["modeled_us"] = export.quantiles_from_hist(snap["hist"],
                                                   sums=snap["hist_sum"])
    out["nvidia_smi"] = smi_line() if device is None else None
    out["phase_s"] = time.time() - t_phase
    if fails:
        emit(out)
        raise AssertionError("partitioned: " + "; ".join(fails))
    out["ok"] = True
    return out


# ------------------------------------------------------------ phase 5

def _prepare_plain_movers(est, cfg, ecfg, toks):
    """``embedding_store.prepare_step`` with the mirror on the plain
    movers; the engine, and so the msc_score kernel, on ``ecfg.backend``."""
    from repro_torch.core import embedding_store as es
    from repro_torch.core import engine
    mirror = es.movement_mirror(cfg, backend="reference")
    est = engine.maintain(est, ecfg, need=toks.shape[0], mirror=mirror)
    state, slots = es.prepare_batch(est.payload._replace(tier=est.tier), cfg,
                                    toks)
    return est._replace(tier=state.tier,
                        payload=state._replace(tier=None)), slots


NEAR_TIE = 2e-5   # two msc_score results, each within its rtol of 1e-5


@contextlib.contextmanager
def _score_log(log: list):
    """While open, every ``msc.select_range`` on a kernel backend also
    scores the same candidates with the plain scorer (backend
    "reference"); ``log`` gets (kernel scores, plain scores) per
    compaction, as device tensors (no host read)."""
    from repro_torch.core import msc
    orig = msc.select_range

    def select_range(state, cfg, key, **kw):
        cand, scores, best = orig(state, cfg, key, **kw)
        if kw.get("backend", "reference") != "reference":
            _, plain, _ = orig(state, cfg, key, **dict(kw,
                                                        backend="reference"))
            log.append((scores.clone(), plain))
        return cand, scores, best

    msc.select_range = select_range
    try:
        yield log
    finally:
        msc.select_range = orig


def _explain_divergence(log, per_step, digests) -> dict:
    """Where the "reference" leg parts from the "cuda" one: the first step
    whose tier checksums differ, and the first compaction of the "cuda"
    leg at which the msc_score kernel's argmax differs from the plain
    scorer's on the same state, with both scorers' candidate scores.
    ``explained`` holds when that compaction falls in that step and the
    plain scorer's two picks lie within ``NEAR_TIE`` of each other."""
    import torch
    first_step = next((i for i, (a, b) in enumerate(
        zip(digests["cuda"], digests["reference"])) if a != b), None)
    out = {"first_step_tier_differs": first_step, "compactions_scored":
           len(log)}
    if not log:
        return dict(out, explained=first_step is None)
    ks = torch.stack([k for k, _ in log]).cpu()
    ps = torch.stack([p for _, p in log]).cpu()
    kb, pb = ks.argmax(1), ps.argmax(1)
    rel = ((ks - ps).abs() / ps.abs().clamp(min=1e-30)).max()
    flips = (kb != pb).nonzero().flatten().tolist()
    out.update({"score_max_rel_err": float(rel), "argmax_flips": len(flips)})
    if not flips:
        return dict(out, explained=first_step is None)
    c = flips[0]
    # per_step[i]: the leg's compaction count after step i
    step = next(i for i, n in enumerate(per_step) if n > c)
    top, pick = float(ps[c, pb[c]]), float(ps[c, kb[c]])
    gap = (top - pick) / max(abs(top), 1e-30)
    out["first_flip"] = {
        "compaction": c, "step": step,
        "kernel_scores": ks[c].tolist(), "plain_scores": ps[c].tolist(),
        "kernel_argmax": int(kb[c]), "plain_argmax": int(pb[c]),
        "plain_rel_gap": gap}
    out["explained"] = first_step is not None and step == first_step \
        and gap <= NEAR_TIE
    return out


def embed_phase(steps: int = EMBED_STEPS, tokens: int = EMBED_TOKENS,
                vocab: int = EMBED_VOCAB, dim: int = EMBED_DIM,
                fast_rows: int = EMBED_FAST_ROWS, device=None,
                diagnose: bool = False) -> dict:
    """The embedding row store through ``engine_init`` + ``prepare_step``
    on zipf(0.99) token batches, in three legs on the card: backend
    "cuda"; backend "cuda" with the mirror on the plain movers (the same
    msc_score kernel, so the legs differ in B3/B4/B5 alone and must agree
    in every leaf); backend "reference" (every leaf, ``obs.ev_score`` to
    rtol 1e-5: the msc_score kernel sums in another order).  Every step's
    lookup must return each token's initial row exactly (the dense-table
    check: rows only move).  With ``diagnose`` the plain-movers leg is
    left out, the "cuda" leg also scores every compaction's candidates
    with the plain scorer, both legs checksum their tier after every
    step, and the "reference" leg may part from the "cuda" one only as
    ``_explain_divergence`` accounts for."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import embedding_store as es
    from repro_torch.core import engine, prng
    cfg = es.EmbedStoreConfig(vocab=vocab, dim=dim, fast_rows=fast_rows)
    dev = torch.device(device or "cuda")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(Zipf(vocab).keys(rng, steps * tokens).reshape(
        steps, tokens)).to(dev)
    out = {"phase": "embed_4096" if diagnose else "embed", "vocab": vocab,
           "dim": dim, "fast_rows": fast_rows, "tokens": tokens,
           "steps": steps, "slow_pool_gb": vocab * dim * 4 / 1e9,
           "fast_pool_mb": fast_rows * dim * 4 / 1e6}
    # the plain movers' leg runs at EMBED_TOKENS only: at the diagnostic
    # size it would take a third of the phase, the longest of the smoke
    legs = (("cuda", "cuda", es.prepare_step),) + (
        () if diagnose else
        (("cuda_plain_movers", "cuda", _prepare_plain_movers),)) + (
        ("reference", "reference", es.prepare_step),)
    ends, per_step, digests, log = {}, {}, {}, []
    for leg, backend, prepare in legs:
        ecfg = es.engine_config(cfg, backend=backend)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        est = es.engine_init(cfg, prng.PRNGKey(0), ecfg, device=dev)
        dense = est.payload.rows_slow.clone()
        torch.cuda.synchronize()
        t_init = time.time() - t0
        kernels.reset_launches()
        engine.HOST_READS.n = 0
        walls, comps, digs = [], [], []
        scoring = _score_log(log) if diagnose and leg == "cuda" else \
            contextlib.nullcontext()
        with scoring:
            for i in range(steps):
                t0 = time.perf_counter()
                est, _ = prepare(est, cfg, ecfg, toks[i])
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                emb = es.lookup(est.payload._replace(tier=est.tier),
                                toks[i])
                if not torch.equal(_bits(emb), _bits(dense[toks[i].long()])):
                    raise AssertionError(f"{out['phase']} ({leg}): step "
                                         f"{i}: a lookup differs from the "
                                         "initial table")
                comps.append(int(est.tier.ctr.compactions))
                if diagnose:
                    digs.append(_digest(est.tier))
        del dense
        c = est.tier.ctr
        w = np.asarray(walls) * 1e3
        out[leg] = {
            "init_s": t_init, "steps_per_s": steps / (w.sum() / 1e3),
            "tokens_per_s": steps * tokens / (w.sum() / 1e3),
            "step_ms_p50": float(np.percentile(w, 50)),
            "step_ms_p90": float(np.percentile(w, 90)),
            "step_ms_max": float(w.max()),
            "compactions": int(c.compactions), "demoted": int(c.demoted),
            "promoted": int(c.promoted),
            "compactions_per_step": np.diff([0] + comps).tolist()
            if diagnose else None,
            "host_reads_per_step": engine.HOST_READS.n / steps,
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30,
            "launches": dict(kernels.LAUNCHES)}
        ends[leg], per_step[leg], digests[leg] = est, comps, digs
        print(f"# {out['phase']} {leg}: {w.sum() / 1e3:.1f}s, "
              f"{int(c.compactions)} compactions", file=sys.stderr,
              flush=True)
    fails = []
    if out["cuda"]["compactions"] == 0:
        fails.append("no compaction ran")
    for name in ("msc_score", "select_gather_rows", "scatter_rows",
                 "gather_rows"):
        if out["cuda"]["launches"][name] <= 0:
            fails.append(f"kernel {name} never launched")
    for leg, tol in (("cuda_plain_movers", 0.0), ("reference", 1e-5)):
        if leg not in ends:
            continue
        other = dict(_leaves(ends[leg]))
        diff, score_err = [], 0.0
        for name, x in _leaves(ends["cuda"]):
            y = other[name]
            if name == ".obs.ev_score" and tol:
                score_err = float(((x - y).abs() / y.abs().clamp(
                    min=1e-30)).max())
                if score_err > tol:
                    diff.append(name)
            elif not torch.equal(_bits(x), _bits(y)):
                diff.append(name)
        first = next((i for i, (a, b) in enumerate(
            zip(per_step["cuda"], per_step[leg])) if a != b), None)
        out[leg].update({"leaves_equal": len(other) - len(diff),
                         "leaves_differ": diff,
                         "score_max_rel_err": score_err,
                         "first_step_compactions_differ": first})
        if diagnose and digests[leg] != digests["cuda"]:
            diff = diff or ["per-step tier checksums"]
        if diff and not (diagnose and leg == "reference"):
            fails.append(f"{leg}: leaves {diff[:4]} differ from the cuda "
                         "leg")
    if diagnose:
        why = _explain_divergence(log, per_step["cuda"], digests)
        out["reference"]["divergence"] = why
        if not why["explained"]:
            fails.append("reference: parts from the cuda leg where no "
                         "msc_score near-tie accounts for it")
    out["dense_table_ok"] = True
    out["ok"] = not fails
    if fails:
        emit(out)
        raise AssertionError(f"{out['phase']}: " + "; ".join(fails))
    return out


# ------------------------------------------------------------ phase 6

def _visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks of ``attention_ref`` keep."""
    import numpy as np
    qpos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(sq)
    return int(np.clip(hi - lo, 0, None).sum())


def _kernel_instances(report: dict, name: str,
                      opcodes=("HMMA", "HGMMA"), lib=None) -> dict:
    """Per kernel instance of library ``name`` (this tree's build, or the
    library file ``lib``): how many of its built SASS instructions
    (``cuobjdump -sass``) have each of ``opcodes`` (by default the
    tensor-core ones), and its registers and spill bytes from the ptxas
    report of that build (``report``'s, or the one kept beside the
    library when this run did not build it)."""
    import re
    from repro_torch.kernels import build
    lib = Path(lib or build.lib_path(name))
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        fn = part.split("\n", 1)[0].strip()
        out[fn] = {op: len(re.findall(rf"\s{op}[\s.]", part))
                   for op in opcodes}
        out[fn]["instructions"] = len(re.findall(r"/\*[0-9a-f]{4,}\*/",
                                                 part))
    log = report.get(name, {}).get("ptxas") or (
        build.ptxas_path(lib).read_text()
        if build.ptxas_path(lib).exists() else "")
    for m in re.finditer(
            r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores, (\d+) bytes spill loads\n"
            r"ptxas info\s*: Used (\d+) registers", log):
        out.setdefault(m.group(1), {}).update(
            registers=int(m.group(5)),
            spill_bytes=int(m.group(3)) + int(m.group(4)))
    return out


def _flash_instance(d: int, dtype) -> str:
    """The mangled-name fragment of B7's instance for head dim d."""
    import torch
    tmpl = 64 if d <= 64 else (128 if d <= 128 else 256)
    kind = "flash_bf16" if dtype == torch.bfloat16 else "flash_f32"
    return f"{kind}ILi{tmpl}E"


def check_flash_attention(rng, instances: dict) -> dict:
    """B7 against its plain version (``attention_ref``) on the card at
    phi4-mini's prefill shape (f32 and bf16, causal), gemma3-1b's (head
    dim 256, window 512 and global), whisper-small's encoder (non-causal,
    1,500 rows off the 64-row tile) and qwen2-vl-2b's prefill (GQA group
    6), atol 2e-5 in f32 and 2e-2 in bf16 (tests/test_kernels.py:28); the
    library call is ``scaled_dot_product_attention`` with the same mask
    and GQA.  Bound:
    the larger of q, k, v and o moved once at HBM_BYTES_PER_S and
    4 * B * Hq * D FLOPs per visible pair at the dtype's peak.  Each
    shape's row names its kernel instance's tensor-core instructions and
    registers (``instances``, from ``_kernel_instances``); every bf16
    instance must hold HMMA or HGMMA, and no D = 128 or 256 instance may
    spill."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    dev = torch.device("cuda")
    shapes = []
    for tag, (b, hq, hkv, s, d), window, causal in (
            ("phi4_prefill", PHI4_ATTN, -1, True),
            ("gemma3_local", GEMMA3_ATTN, 512, True),
            ("gemma3_global", GEMMA3_ATTN, -1, True),
            ("whisper_encoder", WHISPER_ENC_ATTN, -1, False),
            ("qwen2vl_prefill", QWEN2VL_ATTN, -1, True)):
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(dev).manual_seed(int(rng.integers(1 << 30)))
            q = torch.randn((b, hq, s, d), generator=gen, device=dev).to(dtype)
            k = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
            v = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            want = attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            if not err <= tol:
                raise AssertionError(f"flash_attention {tag} {dtype}: max abs"
                                     f" err {err} > {tol}")
            del got, want
            pos = torch.arange(s, device=dev)
            mask = pos[None, :] <= pos[:, None]
            if window > 0:
                mask &= pos[None, :] > pos[:, None] - window
            lib = (lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)) if window < 0 \
                else (lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True))
            ms = cuda_ms(lambda: ops.flash_attention(
                q, k, v, causal=causal, window=window), 5, 1)
            plain_ms = cuda_ms(lambda: attention_ref(
                q, k, v, causal=causal, window=window), 2, 1)
            lib_ms = cuda_ms(lib, 5, 1)
            pairs = _visible_pairs(s, s, causal, window)
            inst = {k: v for k, v in instances.items()
                    if _flash_instance(d, dtype) in k}
            flops = 4 * b * hq * d * pairs
            nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
            peak = F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
            b_bytes, b_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / peak
            shapes.append({
                "tag": tag, "dtype": str(dtype).split(".")[1],
                "q": [b, hq, s, d], "kv": [b, hkv, s, d], "window": window,
                "causal": causal,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": max(b_bytes, b_ops),
                "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                "tflops": flops / ms / 1e9, "instance": inst})
            del q, k, v, mask
            torch.cuda.empty_cache()
    main = shapes[0]     # phi4 prefill, float32: the prefill phase's shape
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:76",
            **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
            "shapes": shapes}


def check_rwkv6_scan(rng, instances: dict) -> dict:
    """B8 against its plain version (``rwkv6_ref``) on the card at
    rwkv6-7b's prefill shape and a ragged one: r, k, v, u normal (u not
    zero), w in (0.4, 0.9) as tests/test_kernels.py draws it; atol 1e-4,
    the JAX package's tolerance for this kernel.  No single PyTorch call
    computes WKV-6 (library_ms null).  Bound: r, k, v, w and o moved once
    (u too) at HBM_BYTES_PER_S, and 5 * B * H * T * D^2 float32 FLOPs
    (S^T r and diag(w) S + k v^T per step; the bonus term is O(D)) at
    F32_OPS_PER_S.  The row names the launch at the prefill shape: grid,
    threads, registers and local bytes (``launch_info``), each instance's
    ptxas registers and spills (``instances``, from
    ``_kernel_instances``), the resident warps an SM, and the time at
    twice the heads (two blocks an SM)."""
    import torch
    from repro_torch.kernels.rwkv6_scan import ops
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_ref
    dev = torch.device("cuda")
    shapes = []
    for tag, (b, h, tt, d) in (("rwkv6_prefill", RWKV_SCAN),
                               ("ragged", RWKV_RAGGED)):
        gen = torch.Generator(dev).manual_seed(int(rng.integers(1 << 30)))
        r, k, v = (torch.randn((b, h, tt, d), generator=gen, device=dev)
                   for _ in range(3))
        w = torch.rand((b, h, tt, d), generator=gen, device=dev) * 0.5 + 0.4
        u = torch.randn((h, d), generator=gen, device=dev)
        got = ops.rwkv6_scan(r, k, v, w, u)
        want = rwkv6_ref(r, k, v, w, u)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"rwkv6_scan {tag}: max abs err {err} > "
                                 "1e-4")
        ms = cuda_ms(lambda: ops.rwkv6_scan(r, k, v, w, u), 10, 2)
        plain_ms = cuda_ms(lambda: rwkv6_ref(r, k, v, w, u), 2, 1)
        nbytes = 4 * (5 * r.numel() + u.numel())
        flops = 5 * b * h * tt * d * d
        b_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        b_ops = 1e3 * flops / F32_OPS_PER_S
        shapes.append({
            "tag": tag, "shape": [b, h, tt, d], "max_abs_err": err,
            "out_max_abs": float(want.abs().max()), "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations"})
        del r, k, v, w, got, want
        torch.cuda.empty_cache()
    main = shapes[0]     # rwkv6-7b's prefill: the rwkv_prefill phase's
    b, h, tt, d = RWKV_SCAN
    # twice the heads, two blocks an SM: how far more warps would help
    gen = torch.Generator(dev).manual_seed(int(rng.integers(1 << 30)))
    r, k, v = (torch.randn((2 * b, h, tt, d), generator=gen, device=dev)
               for _ in range(3))
    w = torch.rand((2 * b, h, tt, d), generator=gen, device=dev) * 0.5 + 0.4
    u = torch.randn((h, d), generator=gen, device=dev)
    ms_2x = cuda_ms(lambda: ops.rwkv6_scan(r, k, v, w, u), 10, 2)
    del r, k, v, w
    torch.cuda.empty_cache()
    info = ops.launch_info()
    grid = b * h
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = min(info["blocks_per_sm"], -(-grid // sms))
    launch = {"grid": grid, "sms": sms,
              "resident_warps_per_sm": per_sm * info["threads"] // 32,
              **info, "instances": instances,
              "ms_at_twice_the_heads": ms_2x}
    return {"name": "rwkv6_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/rwkv6_scan.cu",
            "replaces": "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:44",
            **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
            "launch": launch, "shapes": shapes}


def check_mamba_scan(rng, instances: dict) -> dict:
    """B9 against its plain version (``mamba_ref``) on the card at jamba's
    prefill shape and a ragged one, with the main path's inputs: x
    normal, dt = softplus(-4.6 + 0.5 N(0, 1)) (near 0.01, as the
    published ``dt_proj_b`` makes it), A = -exp(a_log) of the published
    init (-1 .. -N on every channel), D normal, and B and C column slices
    of one [Bb, T, dt_rank + 2N] projection, as ``mamba_layer`` passes
    them; atol 1e-4, the JAX package's tolerance for this kernel.  No
    single PyTorch call computes the selective scan (library_ms null).
    Bound: the largest of x, dt and y moved once (B, C, A, D too) at
    HBM_BYTES_PER_S, 6 float32 FLOPs per state element and step (dt * A,
    (dt x) * B, the FMA into h, the FMA into y) at F32_OPS_PER_S, and one
    exponential per state element and step at SFU_EXP_PER_S (both
    "operations"; ``bound_parts`` has the three).  The row carries each
    kernel instance's registers, spills and SASS counts (``instances``,
    from ``_kernel_instances``); an instance that spills fails."""
    import torch
    from repro_torch.kernels.mamba_scan import ops
    from repro_torch.kernels.mamba_scan.ref import mamba_ref
    from repro_torch.models.mamba import softplus
    dev = torch.device("cuda")
    shapes = []
    for tag, (bb, tt, di, n) in (("jamba_prefill", MAMBA_SCAN),
                                 ("ragged", MAMBA_RAGGED)):
        gen = torch.Generator(dev).manual_seed(int(rng.integers(1 << 30)))
        r = 256                        # jamba's dt_rank, d_model / 16
        x = torch.randn((bb, tt, di), generator=gen, device=dev)
        dt = softplus(torch.randn((bb, tt, di), generator=gen, device=dev)
                      * 0.5 - 4.6)
        a = -torch.arange(1, n + 1, dtype=torch.float32,
                          device=dev).expand(di, n).contiguous()
        proj = torch.randn((bb, tt, r + 2 * n), generator=gen, device=dev)
        bm, cm = proj[..., r:r + n], proj[..., r + n:]
        d = torch.randn((di,), generator=gen, device=dev)
        got = ops.mamba_scan(x, dt, a, bm, cm, d)
        want = mamba_ref(x, dt, a, bm, cm, d)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"mamba_scan {tag}: max abs err {err} > "
                                 "1e-4")
        ms = cuda_ms(lambda: ops.mamba_scan(x, dt, a, bm, cm, d), 10, 2)
        plain_ms = cuda_ms(lambda: mamba_ref(x, dt, a, bm, cm, d), 2, 1)
        nbytes = 4 * (3 * x.numel() + 2 * bm.numel() + a.numel() + di)
        flops = 6 * bb * tt * di * n
        parts = {"bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                 "f32_ops_ms": 1e3 * flops / F32_OPS_PER_S,
                 "exp_ms": 1e3 * bb * tt * di * n / SFU_EXP_PER_S}
        bound = max(parts.values())
        shapes.append({
            "tag": tag, "shape": [bb, tt, di, n], "max_abs_err": err,
            "out_max_abs": float(want.abs().max()), "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound,
            "bound_by": "bytes" if parts["bytes_ms"] == bound
            else "operations", "bound_parts": parts})
        del x, dt, proj, got, want
        torch.cuda.empty_cache()
    spills = [k for k, v in instances.items() if v.get("spill_bytes", 0)]
    if spills:
        raise AssertionError(f"mamba_scan: instances that spill: {spills}")
    main = shapes[0]     # jamba's prefill: the jamba_prefill phase's
    return {"name": "mamba_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan/mamba_scan.py:45",
            **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
            "instances": instances, "shapes": shapes}


def _argmax_gate(got, ref) -> dict:
    """Argmax agreement of two logit tensors [..., V], and the reference's
    top-two gap at every flip."""
    import torch
    am, rm = got.argmax(-1), ref.argmax(-1)
    top2 = torch.topk(ref, 2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1])[am != rm]
    return {"logits_max_abs_diff": float((got - ref).abs().max()),
            "positions": am.numel(),
            "argmax_agree": float((am == rm).float().mean()),
            "argmax_flips": int(gap.numel()),
            "flip_max_gap": float(gap.max()) if gap.numel() else None,
            "tie_bound": PREFILL_TIE}


def _gate_ok(g: dict) -> bool:
    """At most 0.1% of the positions flip (one, where that is less than
    one), and every flip is a near-tie."""
    return g["argmax_flips"] <= max(1, int(0.001 * g["positions"])) and (
        not g["argmax_flips"] or g["flip_max_gap"] < PREFILL_TIE)


def _forward_legs(cfg, params, batch, expect: dict, phase: str,
                  profile=("cuda",)):
    """``loss_fn``, then a timed ``forward``, of ``batch`` on backend
    "cuda" and on "reference".  Each kernel named in ``expect`` must
    launch ``expect[name]`` times in the "cuda" forward (the counts are
    set to 0 just before it) and never in the "reference" one, and the
    logits must be finite.  The backends in ``profile`` add a profiled
    forward (table chiprun_out/profile_{phase}_{backend}.txt).  Returns
    ({backend: its line}, {backend: its logits})."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import model
    n_tok = batch["labels"].numel()
    legs, logits = {}, {}
    for backend in ("cuda", "reference"):
        torch.cuda.reset_peak_memory_stats()
        # loss_fn first: it also warms the backend's kernels and the
        # allocator up for the timed forward
        t0 = time.time()
        loss = float(model.loss_fn(cfg, params, batch, backend=backend))
        t_loss = time.time() - t0
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        lg, aux = model.forward(cfg, params, batch, backend=backend)
        torch.cuda.synchronize()
        dt = time.time() - t0
        leg = legs[backend] = {
            "forward_s": dt, "tokens_per_s": n_tok / dt,
            "loss_fn_s": t_loss, "loss": loss, "aux": float(aux),
            **{f"{k}_launches_per_forward": kernels.LAUNCHES[k]
               for k in expect},
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30}
        if backend in profile:
            leg["profiled_forward"] = _profiled(
                lambda: model.forward(cfg, params, batch, backend=backend),
                f"profile_{phase}_{backend}.txt")
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{phase} ({backend}): non-finite logits")
        logits[backend] = lg
        del lg
        print(f"# {phase} {backend}: forward {dt:.2f}s", file=sys.stderr,
              flush=True)
    for k, n in expect.items():
        got = legs["cuda"][f"{k}_launches_per_forward"]
        if got != n or legs["reference"][f"{k}_launches_per_forward"]:
            raise AssertionError(
                f"{phase}: {k} launched {got} times in a cuda forward, not "
                f"{n} (and must launch never on reference)")
    return legs, logits


def _decode_legs(cfg, params, tokens, ref_logits, n_forced: int,
                 n_new: int, phase: str, cache=None):
    """``decode_step`` from ``cache`` (default: a float32 ``init_cache``
    of batch ``tokens.shape[0]``): ``tokens``' first ``n_forced`` positions
    teacher-forced, their logits held against ``ref_logits``'
    (``_argmax_gate``); then ``n_new`` greedy tokens from that state,
    timed one by one.  Raises on non-finite logits or greedy tokens out
    of range.  Returns (phase line with the gate's keys, the cache)."""
    import numpy as np
    import torch
    from repro_torch.models import model
    dev = tokens.device
    b = tokens.shape[0]
    if cache is None:
        cache = model.init_cache(cfg, b, n_forced + n_new,
                                 dtype=torch.float32, device=dev)
    pos = torch.zeros(b, dtype=torch.int32, device=dev)
    forced = []
    torch.cuda.synchronize()
    t0 = time.time()
    for i in range(n_forced):
        lg, cache = model.decode_step(cfg, params, cache, tokens[:, i], pos)
        forced.append(lg)
        pos += 1
    forced = torch.stack(forced, dim=1)               # [B, n_forced, V]
    torch.cuda.synchronize()
    t_forced = time.time() - t0
    if not torch.isfinite(forced).all():
        raise AssertionError(f"{phase}: non-finite logits")
    gate = _argmax_gate(forced, ref_logits[:, :n_forced])
    tok = forced[:, -1].argmax(-1)
    new, walls = [], []
    for _ in range(n_new):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.decode_step(cfg, params, cache, tok, pos)
        tok = lg.argmax(-1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        new.append(tok)
        pos += 1
    w = np.asarray(walls) * 1e3
    new = torch.stack(new, dim=1)
    if not (0 <= int(new.min()) and int(new.max()) < cfg.vocab):
        raise AssertionError(f"{phase}: greedy tokens out of range")
    return {"phase": phase, "model": cfg.name, "batch": b,
            "cache_dtype": "float32", "teacher_forced": n_forced,
            "teacher_forced_s": t_forced, **gate, "greedy": n_new,
            "ms_per_token_p50": float(np.percentile(w, 50)),
            "ms_per_token_p90": float(np.percentile(w, 90)),
            "ms_per_token_max": float(w.max()),
            "tokens_per_s": float(b * n_new / (w.sum() / 1e3)),
            "greedy_tokens": new.tolist()}, cache


def prefill_phase(params, cfg, seed: int = PREFILL_SEED,
                  device=None) -> dict:
    """phi4-mini-3.8b's prefill forward at full width on ``params``:
    ``forward`` and ``loss_fn`` on backend "cuda" (B7 in every layer) and
    "reference" (the masked softmax), both profiled, tokens
    [PREFILL_BATCH, PREFILL_SEQ] from ``seed``.  The argmax must agree at
    >= 99.9% of positions and every disagreement must be a near-tie (the
    reference's top-two gap below PREFILL_TIE)."""
    import torch
    dev = torch.device(device or "cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ),
                           generator=gen, device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    out = {"phase": "prefill", "model": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "tokens": list(tokens.shape),
           "param_gb": sum(p.numel() * p.element_size()
                           for p in _param_leaves(params)) / 1e9}
    legs, logits = _forward_legs(cfg, params, batch,
                                 {"flash_attention": cfg.n_layers},
                                 "prefill", profile=("cuda", "reference"))
    out.update(legs)
    gate = _argmax_gate(logits["cuda"], logits["reference"])
    out.update(gate)
    out["loss_abs_diff"] = abs(out["cuda"]["loss"]
                               - out["reference"]["loss"])
    del logits
    torch.cuda.empty_cache()
    if not _gate_ok(gate):
        emit(out)
        raise AssertionError("prefill: the backends' argmax differ beyond "
                             "near-ties")
    return out


# Device time by group in a profiled forward: kernels whose name holds one
# of the strings, and, for the MoE dispatch, the device time of the
# PyTorch operators it is made of (sorts, searchsorted, index, index_put,
# scatter, gather; the embedding lookup's index is among them too).
KERNEL_GROUPS = {"gemm": ("gemm", "Gemm"), "mamba_scan": ("mamba_scan",),
                 "flash_attention": ("flash_f32", "flash_bf16")}
DISPATCH_OPS = ("aten::sort", "aten::searchsorted", "aten::index",
                "aten::index_put_", "aten::_index_put_impl_",
                "aten::scatter_", "aten::gather")


def _profiled(fn, table: str) -> dict:
    """One call of ``fn`` under the profiler: its wall time, the device
    busy share, the device time by kernel (top 8; the whole table to
    chiprun_out/``table``) and by group (KERNEL_GROUPS, DISPATCH_OPS).
    CUPTI's "Command Buffer Full" entries (the host blocked on a full
    launch queue) carry a device time but are no kernel: they are left
    out of the busy share and reported apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    full = [e for e in ka if e.key == "Command Buffer Full"]
    kern = [e for e in ka if not e.key.startswith(("aten::", "cuda"))
            and e.key != "Command Buffer Full"]
    OUT.mkdir(exist_ok=True)
    (OUT / table).write_text(ka.table(sort_by="self_cuda_time_total",
                                      row_limit=60))
    group_ms = {g: sum(dev_us(e) for e in kern if any(
        n in e.key for n in names)) / 1e3 for g, names in
        KERNEL_GROUPS.items()}
    group_ms["moe_dispatch_ops"] = sum(
        dev_us(e) for e in ka if e.key in DISPATCH_OPS) / 1e3
    return {"window_s": window,
            "device_busy_share": sum(map(dev_us, kern)) / 1e6 / window,
            "launch_queue_full_ms": sum(map(dev_us, full)) / 1e3,
            "group_ms": group_ms,
            "top_ms": [(e.key[:60], dev_us(e) / 1e3, e.count) for e in
                       sorted(kern, key=dev_us, reverse=True)[:8]]}


def _param_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _param_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _param_leaves(v)
    else:
        yield tree


def rwkv_params(cfg, device=None):
    """rwkv6-7b's parameters from RWKV_SEED on ``device`` (None: the card)
    as the published init makes them, and a seeded non-zero ``time_mix.u``
    per layer, N(0, 0.5^2) from RWKV_U_SEED.  The published init zeroes u
    (the bonus of the current token in the WKV sum), which would leave
    the kernel's bonus term unexercised; the phases install one or the
    other (``_set_u``).  Returns (params with u zero, the non-zero u)."""
    import torch
    from repro_torch.models import model
    dev = torch.device(device or "cuda")
    params = model.init_params(cfg, torch.Generator(dev).manual_seed(
        RWKV_SEED), device=dev)
    gen = torch.Generator(dev).manual_seed(RWKV_U_SEED)
    us = [torch.randn(blk["mixer"]["time_mix"]["u"].shape, generator=gen,
                      device=dev) * 0.5 for blk in params["blocks"]]
    return params, us


def _set_u(params, us) -> None:
    """Install each layer's ``time_mix.u`` from ``us`` (None: zero)."""
    for i, blk in enumerate(params["blocks"]):
        u = blk["mixer"]["time_mix"]["u"]
        if us is None:
            u.zero_()
        else:
            u.copy_(us[i])


def _rwkv_layer_check(params, cfg, tokens) -> dict:
    """The kernel held against its plain version inside the model, layer
    by layer, on the model's own activations: each layer's block on
    backend "cuda" and "reference" from the same input (the "cuda"
    leg's hidden state), and the decode form of its ``time_mix``
    (``_wkv_step``, token by token from a zero state over the first
    RWKV_FORCED positions) against the sequence form on "cuda" (B8).
    Relative errors in the Frobenius norm, per layer."""
    import torch
    from repro_torch.models import model, rwkv6
    from repro_torch.models.common import norm
    rel = lambda a, b: float((a - b).norm() / b.norm())
    hd = cfg.d_model // cfg.n_heads
    blocks, steps = [], []
    with torch.no_grad():
        x = params["embed"][tokens]
        for blk in params["blocks"]:
            tm = blk["mixer"]["time_mix"]
            y, _ = model._block_apply(cfg, blk, x, None, -1, "rwkv", False,
                                      "cuda")
            blocks.append(rel(y, model._block_apply(
                cfg, blk, x, None, -1, "rwkv", False, "reference")[0]))
            h = norm(blk["ln1"], x[:, :RWKV_FORCED], cfg.norm_kind,
                     cfg.norm_eps)
            seq, _ = rwkv6.time_mix(tm, cfg, h, backend="cuda")
            state = torch.zeros((h.shape[0], cfg.n_heads, hd, hd),
                                device=h.device)
            last = torch.zeros_like(h[:, 0])
            outs = []
            for t in range(RWKV_FORCED):
                o, (state, last) = rwkv6.time_mix(
                    tm, cfg, h[:, t:t + 1], state=state, last_x=last)
                outs.append(o)
            steps.append(rel(torch.cat(outs, 1), seq))
            x = y
    return {"block_rel_err": blocks, "step_rel_err": steps,
            "tol": RWKV_LAYER_TOL}


def rwkv_prefill_phase(params, cfg, us, seed: int = RWKV_TOKENS_SEED,
                       device=None):
    """rwkv6-7b's prefill forward at full width, tokens [PREFILL_BATCH,
    PREFILL_SEQ] from ``seed``.  With the non-zero ``us`` installed:
    ``loss_fn`` and ``forward`` on backend "cuda" (B8 in every layer;
    profiled) and "reference" (``rwkv6_ref``'s per-token loop, about
    65,000 steps a forward, so not profiled), timed; B8 must launch once
    per layer on "cuda" and never on "reference", the logits must be
    finite, and every layer must agree within RWKV_LAYER_TOL
    (``_rwkv_layer_check``).  The end-to-end argmax of that model is
    recorded, not gated: a near-zero bonus at position 0 leaves a head's
    output below the group norm's epsilon, and the 32 random layers
    amplify float32 summation-order differences there up to flips of
    gap 0.05 (PERF.md).  With the published init (u zero) installed:
    ``forward`` on both backends, whose argmax must agree
    (``_gate_ok``).  Returns (phase line, tokens, the "cuda" forward's
    logits with u zero); leaves u zero."""
    import torch
    from repro_torch.models import model
    dev = torch.device(device or "cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ),
                           generator=gen, device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    out = {"phase": "rwkv_prefill", "model": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "head_dim": cfg.d_model // cfg.n_heads,
           "tokens": list(tokens.shape),
           "param_gb": sum(p.numel() * p.element_size()
                           for p in _param_leaves(params)) / 1e9}
    _set_u(params, us)
    legs, logits = _forward_legs(cfg, params, batch,
                                 {"rwkv6_scan": cfg.n_layers},
                                 "rwkv_prefill")
    out.update(legs)
    out["u_nonzero"] = _argmax_gate(logits["cuda"], logits["reference"])
    out["u_nonzero"]["loss_abs_diff"] = abs(out["cuda"]["loss"]
                                            - out["reference"]["loss"])
    del logits
    torch.cuda.empty_cache()
    t0 = time.time()
    out["layer_check"] = _rwkv_layer_check(params, cfg, tokens)
    out["layer_check"]["seconds"] = time.time() - t0
    worst = max(out["layer_check"]["block_rel_err"]
                + out["layer_check"]["step_rel_err"])
    if not worst <= RWKV_LAYER_TOL:
        emit(out)
        raise AssertionError(f"rwkv_prefill: a layer's cuda and reference "
                             f"outputs differ by {worst} > "
                             f"{RWKV_LAYER_TOL}")

    _set_u(params, None)
    with torch.no_grad():
        cuda_logits, _ = model.forward(cfg, params, batch, backend="cuda")
        ref_logits, _ = model.forward(cfg, params, batch,
                                      backend="reference")
    gate = _argmax_gate(cuda_logits, ref_logits)
    out["published_init"] = gate
    del ref_logits
    torch.cuda.empty_cache()
    if not _gate_ok(gate):
        emit(out)
        raise AssertionError("rwkv_prefill: the backends' argmax differ "
                             "beyond near-ties (u zero)")
    return out, tokens, cuda_logits


def rwkv_decode_phase(params, cfg, tokens, fwd_logits) -> dict:
    """``decode_step`` at rwkv6-7b's full width (the published init, u
    zero, as ``rwkv_prefill_phase`` leaves it; the decode form with a
    non-zero u is held per layer there), ``_decode_legs`` of batch
    PREFILL_BATCH: the first RWKV_FORCED tokens of the prefill batch
    teacher-forced, each position's logits held against the "cuda"
    forward's (``fwd_logits``) by ``_gate_ok``; then RWKV_NEW greedy
    tokens.  Decode runs no kernel in either package (``_wkv_step`` is
    plain tensor code), so there is one run, no backend legs."""
    out, cache = _decode_legs(cfg, params, tokens, fwd_logits, RWKV_FORCED,
                              RWKV_NEW, "rwkv_decode")
    out["state_max_abs"] = float(cache["wkv"].abs().max())
    if not _gate_ok(out):
        emit(out)
        raise AssertionError("rwkv_decode: the teacher-forced decode's "
                             "argmax differs from the forward's beyond "
                             "near-ties")
    return out


def jamba_config():
    """jamba-v0.1-52b at its published width, cut to one period."""
    from repro_torch.configs.base import get_arch
    return get_arch(JAMBA_MODEL).replace(n_layers=JAMBA_LAYERS)


def _jamba_layer_check(params, cfg, tokens) -> dict:
    """The kernels held against their plain versions inside the model,
    layer by layer, on the model's own activations, from the same input
    (the "cuda" leg's hidden state): each layer's mixer alone on backend
    "cuda" and "reference" (B9 in a mamba layer, B7 in the attention
    layer), and each whole block, residual and FFN included.  Per layer:
    the relative errors (Frobenius norm) of the mixer and of the block,
    the residual stream's RMS after the block; per MoE block: the tokens
    dropped on each leg and the share of tokens whose top-2 experts
    agree.  After the first MoE block the residual runs thousands of
    times larger than a mixer's output (``init_moe``'s 1/sqrt(E) expert
    scale), so only the mixer's error sees a kernel's fault there."""
    import torch
    from repro_torch.models import attention, mamba, model
    from repro_torch.models.common import norm
    rel = lambda a, b: float((a - b).norm() / b.norm())
    out = {"kind": [], "mixer_rel_err": [], "block_rel_err": [],
           "residual_rms": [], "moe": [], "tol": JAMBA_LAYER_TOL}
    with torch.no_grad():
        x = params["embed"][tokens]
        b, s = tokens.shape
        pos = torch.arange(s, device=x.device)[None].expand(b, s)
        for l, (blk, (kind, use_moe, window)) in enumerate(
                zip(params["blocks"], model.layer_plan(cfg))):
            h = norm(blk["ln1"], x, cfg.norm_kind, cfg.norm_eps)
            mix = [mamba.mamba_layer(blk["mixer"], cfg, h, backend=bk)[0]
                   if kind == "mamba" else attention.attention(
                       blk["mixer"], cfg, h, pos, window, backend=bk)
                   for bk in ("cuda", "reference")]
            out["mixer_rel_err"].append(rel(*mix))
            del h, mix
            y, ex = model._block_apply(cfg, blk, x, pos, window, kind,
                                       use_moe, "cuda")
            yr, exr = model._block_apply(cfg, blk, x, pos, window, kind,
                                         use_moe, "reference")
            out["kind"].append(kind + ("+moe" if use_moe else "+ffn"))
            out["block_rel_err"].append(rel(y, yr))
            out["residual_rms"].append(float(y.pow(2).mean().sqrt()))
            if use_moe:
                agree = (ex["experts"].sort(-1).values
                         == exr["experts"].sort(-1).values).all(-1)
                out["moe"].append({
                    "layer": l, "dropped": float(ex["dropped"]),
                    "dropped_reference": float(exr["dropped"]),
                    "top2_agree": float(agree.float().mean()),
                    "aux_loss": float(ex["aux_loss"])})
            del yr, exr
            x = y
    return out


def jamba_prefill_phase(params, cfg, seed: int = JAMBA_TOKENS_SEED,
                        device=None):
    """jamba's prefill forward at full width (one period), tokens
    [PREFILL_BATCH, PREFILL_SEQ] from ``seed``, at the published
    capacity_factor: ``loss_fn`` and ``forward`` on backend "cuda" (B9 in
    the 7 mamba layers, B7 in the attention layer; profiled) and
    "reference" (the plain scan and the masked softmax), timed; B9 and B7
    must launch once per such layer on "cuda" and never on "reference",
    the logits must be finite, and every layer's mixer and block must
    agree within JAMBA_LAYER_TOL (``_jamba_layer_check``).  The
    end-to-end argmax gate (``_gate_ok``) is held where it is well-posed:
    if it fails, the "cuda" forward against itself with its embeddings
    perturbed by JAMBA_PERTURB (relative) must fail it too (the random
    model then amplifies float32 rounding; recorded, not gated), else
    the failure is a fault.  Returns (phase line, tokens)."""
    import torch
    from repro_torch.models import model
    dev = torch.device(device or "cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ),
                           generator=gen, device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    kinds = [k for k, _, _ in model.layer_plan(cfg)]
    out = {"phase": "jamba_prefill", "model": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "d_inner": cfg.ssm_expand * cfg.d_model, "state": cfg.ssm_state,
           "experts": cfg.n_experts, "top_k": cfg.top_k,
           "capacity_factor": cfg.capacity_factor,
           "tokens": list(tokens.shape),
           "param_gb": sum(p.numel() * p.element_size()
                           for p in _param_leaves(params)) / 1e9}
    legs, logits = _forward_legs(
        cfg, params, batch, {"mamba_scan": kinds.count("mamba"),
                             "flash_attention": kinds.count("attn")},
        "jamba_prefill")
    out.update(legs)
    gate = _argmax_gate(logits["cuda"], logits["reference"])
    gate["loss_abs_diff"] = abs(legs["cuda"]["loss"]
                                - legs["reference"]["loss"])
    out["end_to_end"] = gate
    del logits["reference"]
    torch.cuda.empty_cache()
    emb = params["embed"]
    noise = torch.randn(emb.shape, generator=torch.Generator(
        dev).manual_seed(seed + 1), device=dev)
    perturbed = {**params, "embed": emb + JAMBA_PERTURB * emb * noise}
    del noise
    with torch.no_grad():
        plg, _ = model.forward(cfg, perturbed, batch, backend="cuda")
    out["perturbed_self"] = _argmax_gate(plg, logits["cuda"])
    del perturbed, plg, logits
    torch.cuda.empty_cache()
    t0 = time.time()
    out["layer_check"] = _jamba_layer_check(params, cfg, tokens)
    out["layer_check"]["seconds"] = time.time() - t0
    worst = max(out["layer_check"]["mixer_rel_err"]
                + out["layer_check"]["block_rel_err"])
    if not worst <= JAMBA_LAYER_TOL:
        emit(out)
        raise AssertionError(f"jamba_prefill: a layer's cuda and reference "
                             f"outputs differ by {worst} > "
                             f"{JAMBA_LAYER_TOL}")
    out["end_to_end_gated"] = _gate_ok(out["perturbed_self"])
    if out["end_to_end_gated"] and not _gate_ok(gate):
        emit(out)
        raise AssertionError("jamba_prefill: the backends' argmax differ "
                             "beyond near-ties, while a 1e-7 perturbation "
                             "of the input does not part them")
    return out, tokens


def jamba_decode_phase(params, cfg, tokens) -> dict:
    """``decode_step`` at jamba's full width (one period) at
    capacity_factor JAMBA_DECODE_CF, ``_decode_legs`` of batch
    PREFILL_BATCH: the first JAMBA_FORCED tokens of the prefill batch
    teacher-forced, each position's logits held against a "cuda"
    ``forward`` of the same tokens at the same capacity_factor by
    ``_gate_ok``; then JAMBA_NEW greedy tokens.  The decode runs no
    kernel in either package (the mamba layers' one-token update, the
    dense-cache attention), so there is one run."""
    from repro_torch import kernels
    from repro_torch.models import model
    cfg = cfg.replace(capacity_factor=JAMBA_DECODE_CF)
    prefix = tokens[:, :JAMBA_FORCED]
    kernels.reset_launches()
    fwd, _ = model.forward(cfg, params, {"tokens": prefix}, backend="cuda")
    fwd_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    kernels.reset_launches()
    out, cache = _decode_legs(cfg, params, prefix, fwd, JAMBA_FORCED,
                              JAMBA_NEW, "jamba_decode")
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in _param_leaves(params))
    out.update({
        "layers": cfg.n_layers, "capacity_factor": cfg.capacity_factor,
        "forward_launches": fwd_launches,
        "decode_launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
        "weights_read_ms": 1e3 * weight_bytes / HBM_BYTES_PER_S,
        "ssm_state_max_abs": float(cache["ssm_h"].abs().max())})
    if not _gate_ok(out):
        emit(out)
        raise AssertionError("jamba_decode: the teacher-forced decode's "
                             "argmax differs from the forward's beyond "
                             "near-ties")
    return out


# ------------------------------------------------ vlm and audio families

def _attn_layer_check(cfg, blocks, x, pos, causal: bool, advance) -> dict:
    """B7 held against its plain version inside the model, layer by layer,
    on the model's own activations: each layer's q, k, v (from its normed
    input ``x``) through the kernel and through ``attention_ref`` (max abs
    error), then the whole block on backend "cuda" and "reference" from
    the same input (relative error, Frobenius norm); ``advance(blk, x,
    backend)`` applies a block, and the "cuda" output feeds the next
    layer.  Returns the errors per layer and the last hidden state."""
    import torch
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import attention
    from repro_torch.models.common import norm
    rel = lambda a, b: float((a - b).norm() / b.norm())
    out = {"core_max_abs_err": [], "block_rel_err": [],
           "residual_rms": []}
    with torch.no_grad():
        for blk in blocks:
            h = norm(blk["ln1"], x, cfg.norm_kind, cfg.norm_eps)
            q, k, v = attention._qkv(blk["mixer"], cfg, h, pos)
            got = mha(q, k, v, causal=causal, backend="cuda")
            want = attention_ref(q, k, v, causal=causal)
            out["core_max_abs_err"].append(float((got - want).abs().max()))
            del h, q, k, v, got, want
            y, yr = advance(blk, x, "cuda"), advance(blk, x, "reference")
            out["block_rel_err"].append(rel(y, yr))
            out["residual_rms"].append(float(y.pow(2).mean().sqrt()))
            del yr
            x = y
    return out, x


def _layer_gate(phase: str, out: dict, checks: dict) -> None:
    """Fail ``phase`` when a layer's B7 core error passes ATTN_CORE_TOL or
    its block error BLOCK_TOL."""
    core = max(e for c in checks.values() for e in c["core_max_abs_err"])
    block = max(e for c in checks.values() for e in c["block_rel_err"])
    if not (core <= ATTN_CORE_TOL and block <= BLOCK_TOL):
        emit(out)
        raise AssertionError(
            f"{phase}: a layer's B7 core differs from its plain version by "
            f"{core} (bound {ATTN_CORE_TOL}) or its block's backends by "
            f"{block} (bound {BLOCK_TOL})")


def _prefill_shares(legs: dict) -> None:
    """Add each profiled leg's GEMM share of its device time."""
    for leg in legs.values():
        prof = leg.get("profiled_forward")
        if prof:
            busy_ms = prof["device_busy_share"] * prof["window_s"] * 1e3
            prof["gemm_share"] = prof["group_ms"]["gemm"] / busy_ms


def vlm_batch(cfg, seed: int = VLM_INPUT_SEED, device=None) -> dict:
    """The stub vision frontend's output at [PREFILL_BATCH, PREFILL_SEQ]:
    patch embeddings N(0, 0.02^2) and text labels from ``seed``, and the
    positions (t, t % 7, t % 5), t = arange, in [B, S, 3]."""
    import torch
    dev = torch.device(device or "cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    shape = (PREFILL_BATCH, PREFILL_SEQ)
    tt = torch.arange(PREFILL_SEQ, device=dev)
    return {"embeds": 0.02 * torch.randn((*shape, cfg.d_model),
                                         generator=gen, device=dev),
            "positions": torch.stack([tt, tt % 7, tt % 5], -1)[None]
            .expand(*shape, 3),
            "labels": torch.randint(0, cfg.vocab, shape, generator=gen,
                                    device=dev)}


def vlm_prefill_phase(params, cfg, device=None) -> dict:
    """qwen2-vl-2b's prefill forward at full width on ``params`` from
    ``vlm_batch``: ``loss_fn`` and ``forward`` on backend "cuda" (B7 in
    all 28 layers: q [2, 12, 2048, 128], kv [2, 2, 2048, 128], causal) and
    "reference" (the masked softmax over the temporal stream), both
    profiled.  Gates: B7 launches once per layer on "cuda" and never on
    "reference"; the argmax agrees at >= 99.9% of positions with every
    flip a near-tie (``_gate_ok``); every layer's B7 core and block hold
    (``_attn_layer_check``).  The stub positions keep t contiguous, where
    the two backends' masks agree (known difference D6)."""
    import torch
    from repro_torch.models import model
    batch = vlm_batch(cfg, device=device)
    out = {"phase": "vlm_prefill", "model": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "m_rope_sections": list(cfg.m_rope_sections),
           "embeds": list(batch["embeds"].shape),
           "param_gb": sum(p.numel() * p.element_size()
                           for p in _param_leaves(params)) / 1e9}
    legs, logits = _forward_legs(cfg, params, batch,
                                 {"flash_attention": cfg.n_layers},
                                 "vlm_prefill", profile=("cuda", "reference"))
    _prefill_shares(legs)
    out.update(legs)
    gate = _argmax_gate(logits["cuda"], logits["reference"])
    out.update(gate)
    out["loss_abs_diff"] = abs(legs["cuda"]["loss"]
                               - legs["reference"]["loss"])
    del logits
    torch.cuda.empty_cache()
    t0 = time.time()
    pos = batch["positions"]
    check, _ = _attn_layer_check(
        cfg, params["blocks"], batch["embeds"], pos, True,
        lambda blk, x, bk: model._block_apply(cfg, blk, x, pos, -1, "attn",
                                              False, bk)[0])
    check["seconds"] = time.time() - t0
    out["layer_check"] = check
    _layer_gate("vlm_prefill", out, {"decoder": check})
    if not _gate_ok(gate):
        emit(out)
        raise AssertionError("vlm_prefill: the backends' argmax differ "
                             "beyond near-ties")
    return out


def whisper_batch(cfg, seed: int = WHISPER_INPUT_SEED, device=None) -> dict:
    """The stub audio frontend's frame embeddings [PREFILL_BATCH,
    enc_seq, d] N(0, 0.02^2), and WHISPER_TOKENS decoder tokens a row
    with their next-token labels, from ``seed``."""
    import torch
    dev = torch.device(device or "cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    enc = 0.02 * torch.randn((PREFILL_BATCH, cfg.enc_seq, cfg.d_model),
                             generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, WHISPER_TOKENS),
                           generator=gen, device=dev)
    return {"enc_embeds": enc, "tokens": tokens,
            "labels": torch.roll(tokens, -1, dims=1)}


def whisper_prefill_phase(params, cfg, device=None):
    """whisper-small's forward at full width on ``params`` from
    ``whisper_batch``: ``loss_fn`` and ``forward`` on backend "cuda" (B7
    in all 24 attention layers: 12 encoder layers non-causal over 1,500
    frames, q [2, 12, 1500, 64]; 12 decoder layers causal over 448
    tokens; profiled) and "reference".  Gates: B7 launches once per layer
    on "cuda" and never on "reference"; the argmax gate of ``prefill``;
    every encoder and decoder layer's B7 core and block hold
    (``_attn_layer_check``).  Returns (phase line, the batch, the "cuda"
    forward's logits)."""
    import torch
    from repro_torch.models import model
    from repro_torch.models.common import norm
    batch = whisper_batch(cfg, device=device)
    out = {"phase": "whisper_prefill", "model": cfg.name,
           "encoder_layers": cfg.enc_layers, "decoder_layers": cfg.n_layers,
           "d_model": cfg.d_model, "frames": list(batch["enc_embeds"].shape),
           "tokens": list(batch["tokens"].shape),
           "param_gb": sum(p.numel() * p.element_size()
                           for p in _param_leaves(params)) / 1e9}
    legs, logits = _forward_legs(
        cfg, params, batch, {"flash_attention": cfg.enc_layers
                             + cfg.n_layers}, "whisper_prefill")
    _prefill_shares(legs)
    for leg in legs.values():
        leg["frames_per_s"] = batch["enc_embeds"].shape[0] \
            * batch["enc_embeds"].shape[1] / leg["forward_s"]
    out.update(legs)
    gate = _argmax_gate(logits["cuda"], logits["reference"])
    out.update(gate)
    out["loss_abs_diff"] = abs(legs["cuda"]["loss"]
                               - legs["reference"]["loss"])
    fwd = logits["cuda"]
    del logits
    torch.cuda.empty_cache()
    t0 = time.time()
    x = batch["enc_embeds"]
    b, se = x.shape[:2]
    pos = torch.arange(se, device=x.device)[None].expand(b, se)
    enc_check, enc = _attn_layer_check(
        cfg, params["enc_blocks"], x, pos, False,
        lambda blk, x, bk: model._enc_block(cfg, blk, x, pos, bk))
    enc = norm(params["enc_final_norm"], enc, cfg.norm_kind, cfg.norm_eps)
    x = params["embed"][batch["tokens"]]
    dpos = torch.arange(x.shape[1], device=x.device)[None].expand(b, -1)
    dec_check, _ = _attn_layer_check(
        cfg, params["blocks"], x, dpos, True,
        lambda blk, x, bk: model._dec_block(cfg, blk, x, dpos, enc, bk))
    out["layer_check"] = {"encoder": enc_check, "decoder": dec_check,
                          "seconds": time.time() - t0}
    del enc
    _layer_gate("whisper_prefill", out, {"encoder": enc_check,
                                         "decoder": dec_check})
    if not _gate_ok(gate):
        emit(out)
        raise AssertionError("whisper_prefill: the backends' argmax differ "
                             "beyond near-ties")
    return out, batch, fwd


def whisper_decode_phase(params, cfg, batch, fwd_logits) -> dict:
    """whisper-small's decoder decode at full width: the cross cache
    filled with each layer's K/V projection of the port's encoder output
    (backend "cuda"; the JAX package leaves it zero, reference fault F6,
    so one step from the zero cache is also measured against the
    forward), then ``_decode_legs`` of batch PREFILL_BATCH: the first
    WHISPER_FORCED decoder tokens teacher-forced, their logits held
    against the whisper_prefill "cuda" forward's at the same positions
    by ``_gate_ok``; then WHISPER_NEW greedy tokens.  The decode runs no
    kernel in either package (the dense-cache self-attention and the
    cached cross-attention)."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import attention, model
    tokens = batch["tokens"][:, :WHISPER_FORCED]
    b = tokens.shape[0]
    t0 = time.time()
    enc = model._encode(cfg, params, batch["enc_embeds"], "cuda")
    cache = model.init_cache(cfg, b, WHISPER_FORCED + WHISPER_NEW,
                             dtype=torch.float32, device=tokens.device)
    with torch.no_grad():
        for i, blk in enumerate(params["blocks"]):
            cache["cross_k"][i].copy_(attention._proj(enc, blk["cross"]["wk"]))
            cache["cross_v"][i].copy_(attention._proj(enc, blk["cross"]["wv"]))
    torch.cuda.synchronize()
    t_fill = time.time() - t0
    del enc
    zero = model.init_cache(cfg, b, 1, dtype=torch.float32,
                            device=tokens.device)
    lg0, _ = model.decode_step(cfg, params, zero, tokens[:, 0],
                               torch.zeros(b, dtype=torch.int32,
                                           device=tokens.device))
    f6 = float((lg0 - fwd_logits[:, 0]).abs().max())
    del zero, lg0
    kernels.reset_launches()
    out, cache = _decode_legs(cfg, params, tokens, fwd_logits,
                              WHISPER_FORCED, WHISPER_NEW, "whisper_decode",
                              cache=cache)
    out.update({
        "layers": cfg.n_layers, "cross_cache": list(cache["cross_k"].shape),
        "encode_and_fill_s": t_fill,
        "zero_cross_cache_step0_max_abs_diff": f6,
        "decode_launches": {k: v for k, v in kernels.LAUNCHES.items()
                            if v}})
    if not _gate_ok(out):
        emit(out)
        raise AssertionError("whisper_decode: the teacher-forced decode's "
                             "argmax differs from the forward's beyond "
                             "near-ties")
    return out


# ------------------------------------------------------------ phase 2k

def _train_args() -> list:
    """The train phase's command line for repro_torch.launch.train."""
    args = ["--arch", TRAIN_MODEL, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
            "--seed", str(TRAIN_SEED)]
    return args + (["--reduced"] if TRAIN_REDUCED else [])


def train_config(n_layers=None):
    """The train phase's model (gemma3-1b at its published width; reduced
    with TRAIN_REDUCED), cut to ``n_layers`` where a gate says so."""
    from repro_torch.configs.base import get_arch, reduced
    cfg = get_arch(TRAIN_MODEL)
    cfg = reduced(cfg) if TRAIN_REDUCED else cfg
    return cfg if n_layers is None else cfg.replace(n_layers=n_layers)


def _train_tcfg(**kw):
    """The TrainConfig that the launcher makes of ``_train_args()``."""
    from repro_torch.train import optimizer, trainer
    return trainer.TrainConfig(adamw=optimizer.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=5, total_steps=TRAIN_STEPS), **kw)


def _dense_params(cfg) -> tuple:
    """(all, in the blocks) parameter counts of a dense SwiGLU model with
    RMS norms, no biases and tied embeddings (gemma3-1b)."""
    d, hd = cfg.d_model, cfg.head_dim
    layer = d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) \
        + 3 * d * cfg.d_ff + 2 * d
    return cfg.n_layers * layer + cfg.vocab * d + d, cfg.n_layers * layer


def _train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step with remat: 6 N T for the forward
    and backward of every parameter's matmul (the tied embedding counted
    once, as the LM head), 2 N_blocks T for the blocks' recomputed
    forward, and each layer's attention products over its visible
    (query, key) pairs (4 Hq hd a pair forward), forward, recomputed
    forward and backward (x 4)."""
    from repro_torch.models import model
    n, n_blocks = _dense_params(cfg)
    attn = sum(4 * 4 * cfg.n_heads * cfg.head_dim * batch
               * _visible_pairs(seq, seq, True, w)
               for _, _, w in model.layer_plan(cfg))
    t = batch * seq
    return 6.0 * n * t + 2.0 * n_blocks * t + attn


def _train_main_run(device) -> dict:
    """``launch.train.main`` with ``_train_args()`` on ``device``, each
    step timed (synchronised) and step TRAIN_PROFILE_STEP profiled; its
    printed lines to chiprun_out/train_launcher.txt."""
    import io
    import torch
    from repro_torch import kernels
    from repro_torch.launch import train as launch_train
    from repro_torch.train import trainer
    real, walls, prof = trainer.make_train_step, [], {}

    def timed_maker(mcfg, tcfg):
        step = real(mcfg, tcfg)

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if len(walls) == TRAIN_PROFILE_STEP:
                box = {}
                prof.update(_profiled(lambda: box.update(
                    out=step(state, batch)), "profile_train_step.txt"))
                out = box["out"]
            else:
                out = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            return out
        return timed

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    trainer.make_train_step = timed_maker
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            losses = launch_train.main(_train_args() + (
                ["--device", str(device)] if device is not None else []))
    finally:
        trainer.make_train_step = real
    run_s = time.time() - t0
    OUT.mkdir(exist_ok=True)
    (OUT / "train_launcher.txt").write_text(buf.getvalue())
    return {"losses": losses, "walls": walls, "profile": prof,
            "run_s": run_s, "launches": {k: v for k, v in
                                         kernels.LAUNCHES.items() if v},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def _grad_precision_gate(device) -> dict:
    """One step's gradients in float32 against the same step's in float64
    at TRAIN_GRAD_LAYERS layers of the full width, batch 1 x TRAIN_SEQ:
    relative L2 per leaf.  (The model computes its norms, attention
    softmax and loss in float32 whatever the parameters' dtype, so the
    float64 leg is float64 in its matmuls: the gate sees TF32 left on, or
    any fault of the card's float32 path.)"""
    import torch
    from repro_torch.core.tree import leaves, map_tree
    from repro_torch.models import model
    from repro_torch.train import data, trainer
    cfg = train_config(TRAIN_GRAD_LAYERS)
    dev = torch.device(device or "cuda")
    p32 = model.init_params(cfg, torch.Generator(dev).manual_seed(
        TRAIN_SEED + 1), device=dev)
    batch = data.model_batch(data.DataConfig(
        seed=TRAIN_SEED, batch=1, seq_len=TRAIN_SEQ, vocab=cfg.vocab), cfg,
        0, device=dev)
    tcfg = trainer.TrainConfig()
    l32, g32 = trainer.value_and_grad(cfg, tcfg, p32, batch)
    p64 = map_tree(lambda t: t.double(), p32)
    del p32
    l64, g64 = trainer.value_and_grad(cfg, tcfg, p64, batch)
    errs = [float(torch.linalg.vector_norm(a.double() - b)
                  / torch.linalg.vector_norm(b).clamp(min=1e-300))
            for a, b in zip(leaves(g32), leaves(g64))]
    return {"layers": cfg.n_layers, "batch": [1, TRAIN_SEQ],
            "loss_f32": float(l32), "loss_f64": float(l64),
            "max_rel_l2": max(errs), "leaves": len(errs),
            "ok": max(errs) <= TRAIN_GRAD_TOL}


def _microbatch_gate(device) -> dict:
    """One step of the full model at micro_batches 2 against 1 on one
    batch, from one state: loss rtol 1e-5, every parameter within 2e-5
    (tests/test_train_infra.py's bounds)."""
    import torch
    from repro_torch.core.tree import leaves
    from repro_torch.train import data, trainer
    cfg = train_config()
    dev = torch.device(device or "cuda")
    t1 = _train_tcfg()
    s1 = trainer.init_state(cfg, t1, torch.Generator(dev).manual_seed(
        TRAIN_SEED), device=dev)
    n_params = sum(p.numel() for p in leaves(s1.params))
    s2 = trainer.clone_state(s1)
    batch = data.model_batch(data.DataConfig(
        seed=TRAIN_SEED, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        vocab=cfg.vocab), cfg, 0, device=dev)
    s1, m1 = trainer.make_train_step(cfg, t1)(s1, batch)
    s2, m2 = trainer.make_train_step(cfg, t1._replace(micro_batches=2))(
        s2, batch)
    diff = max(float((a - b).abs().max()) for a, b in
               zip(leaves(s1.params), leaves(s2.params)))
    parted = sum(int(((a - b).abs() > 2e-5).sum()) for a, b in
                 zip(leaves(s1.params), leaves(s2.params)))
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    return {"n_params": n_params, "loss_mb1": l1, "loss_mb2": l2,
            "loss_rel_diff": abs(l1 - l2) / abs(l1),
            "max_param_abs_diff": diff, "params_beyond_2e-5": parted,
            "ok": abs(l1 - l2) <= 1e-5 * abs(l1) and diff <= 2e-5}


def _checkpoint_gate(device) -> dict:
    """With deterministic algorithms (the embedding gather's backward adds
    atomically otherwise): TRAIN_STEPS steps from one state at
    TRAIN_CKPT_LAYERS layers, an asynchronous checkpoint after step
    TRAIN_STEPS / 2 written while the next steps update the state in
    place; the checkpoint restored into a fresh state and replayed to
    TRAIN_STEPS; every parameter within 1e-6 of the uninterrupted run.
    The checkpoint goes to a directory under build/ that the gate
    removes."""
    import shutil
    import tempfile
    import warnings
    import torch
    from repro_torch.core.tree import leaves
    from repro_torch.train import checkpoint, data, trainer
    cfg = train_config(TRAIN_CKPT_LAYERS)
    dev = torch.device(device or "cuda")
    tcfg = _train_tcfg()
    dcfg = data.DataConfig(seed=TRAIN_SEED, batch=TRAIN_BATCH,
                           seq_len=TRAIN_SEQ, vocab=cfg.vocab)
    mid = TRAIN_STEPS // 2
    (ROOT / "build").mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build")
    was = torch.are_deterministic_algorithms_enabled()
    out = {"layers": cfg.n_layers, "at_step": mid}
    try:
        with warnings.catch_warnings():
            # cuBLAS on one stream repeats its sums without
            # CUBLAS_WORKSPACE_CONFIG; only its warning is silenced
            warnings.filterwarnings("ignore", ".*CuBLAS.*")
            torch.use_deterministic_algorithms(True, warn_only=True)
            step = trainer.make_train_step(cfg, tcfg)
            state = trainer.init_state(cfg, tcfg, torch.Generator(
                dev).manual_seed(TRAIN_SEED), device=dev)
            out["state_gb"] = sum(t.numel() * t.element_size()
                                  for t in leaves(state)) / 1e9
            mgr = checkpoint.CheckpointManager(ckdir)
            for s in range(TRAIN_STEPS):
                state, _ = step(state, data.model_batch(dcfg, cfg, s,
                                                        device=dev))
                if s + 1 == mid:
                    torch.cuda.synchronize()
                    t0 = time.time()
                    mgr.save(mid, state)
                    out["save_call_s"] = time.time() - t0
            torch.cuda.synchronize()
            t0 = time.time()
            mgr.wait()
            out["save_wait_after_steps_s"] = time.time() - t0
            t0 = time.time()
            restored = mgr.restore(mid, device=dev)
            torch.cuda.synchronize()
            out["restore_s"] = time.time() - t0
            if int(restored.opt.step) != mid:
                raise AssertionError("train: the checkpoint holds step "
                                     f"{int(restored.opt.step)}, not {mid}")
            for s in range(mid, TRAIN_STEPS):
                restored, _ = step(restored, data.model_batch(
                    dcfg, cfg, s, device=dev))
            diff = max(float((a - b).abs().max()) for a, b in
                       zip(leaves(restored.params), leaves(state.params)))
    finally:
        torch.use_deterministic_algorithms(was)
        shutil.rmtree(ckdir, ignore_errors=True)
    out.update({"max_param_abs_diff": diff, "ok": diff <= 1e-6})
    return out


def _compression_gate(device) -> dict:
    """Two compressed steps (compress_grads=True) of the full model, with
    deterministic algorithms: before each, the step's gradients
    (``value_and_grad`` on the same state and batch) through
    ``compress_tree``; per leaf, the applied gradient plus the new
    residual against the gradient plus the old residual (relative L2,
    within 1e-6), and the step's own new residual equal to that
    ``compress_tree``'s bit for bit."""
    import warnings
    import torch
    from repro_torch.core.tree import leaves
    from repro_torch.distributed import collectives
    from repro_torch.train import data, trainer
    cfg = train_config()
    dev = torch.device(device or "cuda")
    tcfg = _train_tcfg(compress_grads=True)
    dcfg = data.DataConfig(seed=TRAIN_SEED, batch=TRAIN_BATCH,
                           seq_len=TRAIN_SEQ, vocab=cfg.vocab)
    was = torch.are_deterministic_algorithms_enabled()
    worst, same, losses = 0.0, True, []
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", ".*CuBLAS.*")
            torch.use_deterministic_algorithms(True, warn_only=True)
            state = trainer.init_state(cfg, tcfg, torch.Generator(
                dev).manual_seed(TRAIN_SEED), device=dev)
            step = trainer.make_train_step(cfg, tcfg)
            for s in range(2):
                batch = data.model_batch(dcfg, cfg, s, device=dev)
                _, g = trainer.value_and_grad(cfg, tcfg, state.params,
                                              batch)
                deq, ef = collectives.compress_tree(g, state.ef)
                for gi, r0, d, r1 in zip(leaves(g), leaves(state.ef),
                                         leaves(deq), leaves(ef)):
                    want = gi + r0
                    worst = max(worst, float(
                        torch.linalg.vector_norm(d + r1 - want)
                        / torch.linalg.vector_norm(want).clamp(
                            min=1e-30)))
                del g, deq
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                same &= all(torch.equal(a, b) for a, b in
                            zip(leaves(ef), leaves(state.ef)))
                del ef
    finally:
        torch.use_deterministic_algorithms(was)
    return {"steps": 2, "losses": losses, "max_rel_l2": worst,
            "step_residual_equal": same, "ok": worst <= 1e-6 and same}


def _guard_gate(device) -> dict:
    """Training refuses the kernel backend, and B7 refuses inputs that
    require grad (it has no backward)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.train import trainer
    out = {}
    try:
        trainer.make_train_step(train_config(), trainer.TrainConfig(
            backend="cuda"))
        out["cuda_backend_refused"] = False
    except NotImplementedError:
        out["cuda_backend_refused"] = True
    dev = torch.device(device or "cuda")
    q = torch.zeros((1, 4, 64, 256), device=dev, requires_grad=True)
    k = torch.zeros((1, 1, 64, 256), device=dev)
    try:
        flash_attention(q, k, k)
        out["b7_refuses_grad"] = False
    except RuntimeError:
        out["b7_refuses_grad"] = True
    out["ok"] = out["cuda_backend_refused"] and out["b7_refuses_grad"]
    return out


def train_phase(device=None) -> dict:
    """gemma3-1b's training at its published width: the main run through
    ``repro_torch.launch.train.main`` (``_train_args()``), then the gates
    (``_grad_precision_gate``, ``_microbatch_gate``, ``_checkpoint_gate``,
    ``_compression_gate``, ``_guard_gate``).  The main run's losses must
    be finite and fall (last below first), and no kernel of B1-B9 may
    launch (training runs the plain paths).  Reports loss per step, step
    ms p50 and max (the profiled step apart), tokens/s and model TFLOP/s
    at the p50 step, peak memory and the profiled step's device busy
    share."""
    import math
    import torch
    t_phase = time.time()
    cfg = train_config()
    run = _train_main_run(device)
    walls = [w for i, w in enumerate(run["walls"])
             if i != TRAIN_PROFILE_STEP]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    p50 = sorted(walls)[len(walls) // 2]
    flops = _train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    n_params, n_blocks = _dense_params(cfg)
    out = {"phase": "train", "model": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "n_params": n_params, "argv": _train_args(),
           "losses": run["losses"],
           "step_ms": [w * 1e3 for w in run["walls"]],
           "step_ms_p50": p50 * 1e3, "step_ms_max": max(walls) * 1e3,
           "first_step_ms": run["walls"][0] * 1e3,
           "tokens_per_step": tokens, "tokens_per_s": tokens / p50,
           "model_tflop_per_step": flops / 1e12,
           "model_tflop_per_s": flops / p50 / 1e12,
           "peak_gib": run["peak_gib"], "run_s": run["run_s"],
           "profiled_step": run["profile"],
           # the profiler's host cost stretches its window late in a
           # process that traced before: the kernels' device time over
           # the unprofiled p50 step is the busy share without it
           "device_share_of_p50_step": run["profile"].get(
               "device_busy_share", 0.0) * run["profile"]["window_s"] / p50,
           "kernel_launches": run["launches"]}
    torch.cuda.empty_cache()
    gates = {}
    for name, gate in (("grad_f32_vs_f64", _grad_precision_gate),
                       ("micro_batches", _microbatch_gate),
                       ("checkpoint_restart", _checkpoint_gate),
                       ("compression", _compression_gate),
                       ("guards", _guard_gate)):
        t0 = time.time()
        gates[name] = gate(device)
        gates[name]["seconds"] = time.time() - t0
        torch.cuda.empty_cache()
    out["gates"] = gates
    out["phase_s"] = time.time() - t_phase
    losses = run["losses"]
    if gates["micro_batches"]["n_params"] != n_params:
        emit(out)
        raise AssertionError("train: the parameter count of the FLOP model "
                             "differs from the state's")
    bad = [k for k, g in gates.items() if not g["ok"]]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)) \
            or not losses[-1] < losses[0] or run["launches"] or bad:
        emit(out)
        raise AssertionError(f"train: losses {losses}, kernel launches "
                             f"{run['launches']}, failed gates {bad}")
    return out


# ------------------------------------------------------------ phase 7

def serve_kv_config(cfg):
    from repro_torch.core.paged_kv import PagedKVConfig
    return PagedKVConfig(
        n_layers=cfg.n_layers, kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        page_tokens=16, fast_pages=128, slow_pages=2048, max_seqs=16,
        max_pages_per_seq=20, topk_pages=16, recent_pages=2,
        dtype="bfloat16")


def _check_paged_attention(eng, seed: int) -> dict:
    """B6 on the live fast pool of one layer of a running engine, with the
    block tables ``select_pages`` gives for a query drawn from ``seed``
    (pages in the slow pool are absent, -1): the entry point
    ``decode_attention`` once (counted), then held against its plain
    version (atol 2e-5: float32 queries, bf16 pages, float32 sums) and
    timed: the wrapper, its C launch alone (both with the host's launch
    time in them) and the kernel's own device time (profiler).  Bound:
    the bytes of the selected pages' K and V rows, the queries, tables,
    mask and output, at HBM_BYTES_PER_S."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import paged_kv
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    cfg, mcfg = eng.cfg, eng.mcfg
    dev = eng.device
    kv = eng.est.payload._replace(tier=eng.est.tier)
    gen = torch.Generator(dev).manual_seed(seed)
    q = torch.randn((cfg.n_layers, cfg.max_seqs, mcfg.n_heads, cfg.head_dim),
                    generator=gen, device=dev)
    seq_ids = torch.arange(cfg.max_seqs, dtype=torch.int32, device=dev)
    pidx, pmask = paged_kv.select_pages(kv, cfg, seq_ids, q)
    slot, found = paged_kv.fast_slots_of(
        kv, paged_kv.page_key(cfg, seq_ids[:, None], pidx).reshape(-1))
    bt = torch.where(found.view(pidx.shape) & pmask, slot.view(pidx.shape),
                     -1).to(torch.int32)
    t = cfg.page_tokens
    pos = pidx[..., None] * t + torch.arange(t, device=dev)
    tm = pos < kv.seq_len[:, None, None]
    layer = cfg.n_layers - 1
    kp, vp, ql = kv.k_fast[layer], kv.v_fast[layer], q[layer]
    before = kernels.LAUNCHES["paged_attention"]
    got = ops.decode_attention(ql, kp, vp, bt, tm, backend="cuda")
    launches = kernels.LAUNCHES["paged_attention"] - before
    want = paged_attention_ref(ql, kp, vp, bt, tm)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= 2e-5:
        raise AssertionError(f"paged_attention: max abs err {err} > 2e-5")
    def timed(bt, tm):
        """(wrapper ms, bare launch ms, kernel ms, plain ms, bound ms,
        pages present)."""
        lib, out = ops._lib(), torch.empty_like(ql)
        stream = torch.cuda.current_stream().cuda_stream
        launch = lambda: lib.paged_attention_launch(
            ql.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
            tm.data_ptr(), out.data_ptr(), 0, 1, ql.shape[0], ql.shape[1],
            cfg.kv_heads, cfg.head_dim, kp.shape[0], t, bt.shape[1],
            kp.stride(0), cfg.head_dim ** -0.5, stream)
        n_pages = int((bt >= 0).sum())
        nbytes = (n_pages * 2 * t * cfg.kv_heads * cfg.head_dim
                  * kp.element_size() + 2 * ql.numel() * 4 + bt.numel() * 4
                  + tm.numel())
        return (cuda_ms(lambda: ops.paged_attention(ql, kp, vp, bt, tm), 50),
                cuda_ms(launch, 200),
                _kernel_ms(launch, 50, "paged_attention"),
                cuda_ms(lambda: paged_attention_ref(ql, kp, vp, bt, tm), 20),
                1e3 * nbytes / HBM_BYTES_PER_S, n_pages)

    ms, launch_ms, kernel_ms, plain_ms, bound_ms, n_pages = timed(bt, tm)
    # the same launch with every table entry a page of the fast pool and
    # every token visible: the kernel's bandwidth at the full K pages
    full_bt = torch.argsort(torch.rand((bt.shape[0], cfg.fast_pages),
                                       generator=gen, device=dev), dim=1)[
        :, :bt.shape[1]].to(torch.int32)
    full_tm = torch.ones_like(tm)
    err_full = float((ops.paged_attention(ql, kp, vp, full_bt, full_tm)
                      - paged_attention_ref(ql, kp, vp, full_bt, full_tm))
                     .abs().max())
    if not err_full <= 2e-5:
        raise AssertionError(f"paged_attention (full table): max abs err "
                             f"{err_full} > 2e-5")
    f_ms, f_launch, f_kernel, f_plain, f_bound, f_pages = timed(full_bt,
                                                                full_tm)
    # the comparison's launches are not the entry point's
    kernels.LAUNCHES["paged_attention"] = before + launches
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/"
                        "paged_attention.py:71",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "launch_only_ms": launch_ms, "kernel_ms": kernel_ms,
            "shape": {"q": list(ql.shape), "pool": list(kp.shape),
                      "pool_dtype": "bfloat16", "block_table": list(bt.shape),
                      "pages_present": n_pages, "layer": layer,
                      "tick": eng.stats["steps"]},
            "full_table": {"pages_present": f_pages, "max_abs_err": err_full,
                           "ms": f_ms, "launch_only_ms": f_launch,
                           "kernel_ms": f_kernel,
                           "plain_ms": f_plain, "bound_ms": f_bound}}


def serve_engine(params, cfg, seed: int, backend: str, device=None,
                 shape=SERVE_SHAPE):
    """A ``ServeEngine`` at ``cfg``'s width over ``serve_kv_config`` on
    ``backend``, holding ``shape.requests`` requests of ``shape.prompt``
    prompt tokens drawn from ``seed`` and ``shape.new`` new tokens each.
    Returns (engine, requests)."""
    import numpy as np
    from repro_torch.serve.engine import Request, ServeEngine
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab, shape.prompt).tolist()
               for _ in range(shape.requests)]
    eng = ServeEngine(cfg, serve_kv_config(cfg), params, seed=seed,
                      backend=backend, device=device)
    reqs = [Request(rid=i, prompt=p, max_new=shape.new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return eng, reqs


def serve_phase(params, cfg, seed: int = SERVE_SEED, device=None,
                shape=SERVE_SHAPE, phase: str = "serve"):
    """``ServeEngine`` at the model's full width over the tiered paged KV
    cache (``serve_kv_config``: for phi4-mini-3.8b a 256 MiB bf16 fast
    pool that holds fewer pages than the live ones, so tiering runs, and
    a 4 GiB slow pool): ``shape.requests`` requests of ``shape.prompt``
    prompt tokens from ``seed`` and ``shape.new`` new tokens each,
    through max_seqs slots, on backend "cuda" then "reference"; the
    "cuda" leg's ticks ``shape.trace_at`` on are profiled
    (chiprun_out/profile_{phase}.txt) and B6 is checked on its pools at
    tick ``shape.b6_at``.  Every request must retire with ``shape.new``
    tokens, pages must be demoted and read from the slow pool, B1-B5
    must launch on the "cuda" leg, the legs' tokens must be bit-equal,
    and their tier states equal or parted only at an msc_score near-tie
    (``_explain_divergence``).  Returns (phase line, B6 kernels row)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import engine
    kv_cfg = serve_kv_config(cfg)
    out = {"phase": phase, "model": cfg.name, "kv": kv_cfg._asdict(),
           "requests": shape.requests, "prompt_tokens": shape.prompt,
           "max_new": shape.new,
           "fast_pool_mib": 2 * kv_cfg.n_layers * kv_cfg.fast_pages
           * kv_cfg.page_tokens * kv_cfg.kv_heads * kv_cfg.head_dim * 2
           / 2**20,
           "slow_pool_gib": 2 * kv_cfg.n_layers * kv_cfg.slow_pages
           * kv_cfg.page_tokens * kv_cfg.kv_heads * kv_cfg.head_dim * 2
           / 2**30}
    tokens, per_step, digests, ends, log = {}, {}, {}, {}, []
    b6 = None
    for leg in ("cuda", "reference"):
        torch.cuda.reset_peak_memory_stats()
        eng, reqs = serve_engine(params, cfg, seed, leg, device, shape)
        kernels.reset_launches()
        engine.HOST_READS.n = 0
        walls, comps, digs = [], [], []
        busy = None
        scoring = _score_log(log) if leg == "cuda" else \
            contextlib.nullcontext()
        with scoring:
            while eng.queue or eng.active:
                tick = eng.stats["steps"]
                if leg == "cuda" and tick == shape.trace_at:
                    def traced():
                        for _ in range(SERVE_TRACE_TICKS):
                            eng.step()
                            comps.append(int(eng.est.tier.ctr.compactions))
                            digs.append(_digest(eng.est.tier))
                    h0 = engine.HOST_READS.n
                    busy = _profiled(traced, f"profile_{phase}.txt")
                    busy.update(ticks=SERVE_TRACE_TICKS,
                                host_reads=engine.HOST_READS.n - h0)
                    continue
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                comps.append(int(eng.est.tier.ctr.compactions))
                digs.append(_digest(eng.est.tier))
                if leg == "cuda" and tick == shape.b6_at:
                    b6 = _check_paged_attention(eng, seed)
        c = eng.counters
        w = np.asarray(walls) * 1e3
        n_proc = sum(len(r.prompt) + len(r.out) for r in reqs)
        n_gen = sum(len(r.out) for r in reqs)
        ticks = eng.stats["steps"]
        wall = w.sum() / 1e3 + (busy["window_s"] if busy else 0.0)
        out[leg] = {
            "ticks": ticks, "wall_s": wall,
            "tokens_per_s": n_proc / wall, "generated_per_s": n_gen / wall,
            "tick_ms_p50": float(np.percentile(w, 50)),
            "tick_ms_p90": float(np.percentile(w, 90)),
            "tick_ms_max": float(w.max()),
            "host_reads_per_tick": engine.HOST_READS.n / ticks,
            "compactions": c["compactions"], "demoted": c["demoted"],
            "promoted": c["promoted"], "hits_fast": c["hits_fast"],
            "hits_slow": c["hits_slow"],
            "retired": eng.stats["retired"],
            "max_memory_allocated_gib":
                torch.cuda.max_memory_allocated() / 2**30,
            "launches": dict(kernels.LAUNCHES)}
        if busy:
            out[leg]["traced"] = busy
        tokens[leg] = [list(r.out) for r in reqs]
        per_step[leg], digests[leg] = comps, digs
        ends[leg] = _digest(eng.est.tier)
        print(f"# {phase} {leg}: {ticks} ticks {wall:.1f}s, "
              f"{c['compactions']} compactions", file=sys.stderr, flush=True)
        del eng
        torch.cuda.empty_cache()
    fails = []
    cu = out["cuda"]
    if any(len(t) != shape.new for t in tokens["cuda"]) \
            or cu["retired"] != shape.requests:
        fails.append("a request did not retire with max_new tokens")
    if cu["demoted"] <= 0 or cu["hits_slow"] <= 0:
        fails.append("no page was demoted and read from the slow pool")
    for name in ("clock_update", "msc_score", "select_gather_rows",
                 "scatter_rows", "gather_rows"):
        if cu["launches"][name] <= 0:
            fails.append(f"kernel {name} never launched")
    if tokens["cuda"] != tokens["reference"]:
        fails.append("the legs' generated tokens differ")
    if b6 is None:
        fails.append("the paged_attention check did not run")
    out["paged_attention"] = b6
    out["tokens_equal"] = tokens["cuda"] == tokens["reference"]
    out["tier_leaves_equal"] = ends["cuda"] == ends["reference"]
    why = _explain_divergence(log, per_step["cuda"], digests)
    out["divergence"] = why
    if not why["explained"]:
        fails.append("the legs' tier states part where no msc_score "
                     "near-tie accounts for it")
    out["ok"] = not fails
    if fails:
        emit(out)
        raise AssertionError(f"{phase}: " + "; ".join(fails))
    return out, b6


# ------------------------------------------------------ the launch plane

# launch_serve: repro_torch.launch.serve.main at its defaults (reduced
# phi4-mini-3.8b, float32 weights from seed 0; 16 requests of 48 prompt
# and 16 new tokens through 8 slots, 96 fast pages of 8 tokens) on the
# card, backend "cuda"; then a ServeEngine on "reference" with the same
# weights, pools and requests.
# banded_prefill: gemma3-1b at its published width (src/repro/configs/
# gemma3_1b.py: 26 layers, d 1,152, 4 heads / 1 KV of 256, window 512 in
# 5 of every 6 layers: 22 local, 4 global), float32 weights from
# BANDED_SEED (1.00 B parameters, 4.0 GB), banded_local on, over
# BANDED_BATCH x BANDED_SEQ tokens from BANDED_TOKENS_SEED: the banded
# forward (the S x 2w band in the local layers, B7 in the global ones)
# against the masked one (B7 in all 26).
BANDED_MODEL = "gemma3-1b"
BANDED_SEED, BANDED_TOKENS_SEED = 26, 27
BANDED_BATCH, BANDED_SEQ = 2, 4096
# dryrun: the port's dry run, baseline and opt, over every arch x
# applicable shape x mesh, on the meta device in two processes of the
# card's host started before the kernel checks (chiprun_out/dryrun_torch,
# chiprun_out/dryrun_{variant}.log).
DRYRUN_VARIANTS = ("baseline", "opt")
DRYRUN_WAIT_S = 600


def start_dryrun() -> list:
    """Start the dry run of every cell, one process a variant, with no
    card visible to them, at the lowest CPU priority (niceness 19), so
    that the timed host-bound phases that run beside them take the host
    first.  Returns [(variant, process, start time, log file)]."""
    import os
    out = OUT / "dryrun_torch"
    out.mkdir(parents=True, exist_ok=True)
    for f in out.glob("*.json"):
        f.unlink()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    procs = []
    for variant in DRYRUN_VARIANTS:
        log = open(OUT / f"dryrun_{variant}.log", "w")
        procs.append((variant, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
             str(out), "--variant", variant], cwd=ROOT, env=env,
            stdout=log, stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.nice(19)), time.time(), log))
    return procs


def stop_dryrun(procs: list) -> None:
    """Kill whichever dry-run process still runs, and close the logs."""
    for _, p, _, log in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        log.close()


def launch_serve_phase() -> dict:
    """``repro_torch.launch.serve.main([])``, the launcher at its
    defaults, on the card: its ticks timed one by one (with a
    synchronise) and each tick's tier checksums kept, its requests
    recorded, every msc_score call also scored by the plain scorer.  Then
    the same weights, pools and requests through a ``ServeEngine`` on
    backend "reference" on the card.  Gates: every request retires with
    max_new tokens; the legs' tokens are equal; their tier states equal
    or parted only at an msc_score near-tie; each kernel that the
    launcher's path reaches launched (B1 on every tick; B2 where a
    compaction ran)."""
    from unittest import mock

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import engine
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.engine import Request, ServeEngine
    walls, comps, digs, reqs, log = [], [], [], [], []

    class TimedEngine(ServeEngine):
        def step(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            busy = super().step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            comps.append(int(self.est.tier.ctr.compactions))
            digs.append(_digest(self.est.tier))
            return busy

    def request(**kw):
        reqs.append(Request(**kw))
        return reqs[-1]

    kernels.reset_launches()
    engine.HOST_READS.n = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with mock.patch.multiple(launch_serve, ServeEngine=TimedEngine,
                             Request=request), _score_log(log):
        eng = launch_serve.main([])
    wall = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    ticks = eng.stats["steps"]
    cu = {"ticks": ticks, "wall_s": wall,
          "host_reads_per_tick": engine.HOST_READS.n / ticks,
          "launches": launches,
          "max_memory_allocated_gib":
              torch.cuda.max_memory_allocated() / 2**30}
    n_proc = sum(len(r.prompt) + len(r.out) for r in reqs)
    w = np.asarray(walls) * 1e3
    cu.update(tokens_per_s=n_proc / (w.sum() / 1e3),
              tick_ms_p50=float(np.percentile(w, 50)),
              tick_ms_p90=float(np.percentile(w, 90)),
              counters={k: v for k, v in eng.counters.items() if v})
    ref = ServeEngine(eng.mcfg, eng.cfg, eng.params, seed=0,
                      backend="reference", device=eng.device)
    rreqs = [Request(rid=r.rid, prompt=list(r.prompt), max_new=r.max_new)
             for r in reqs]
    for r in rreqs:
        ref.submit(r)
    rcomps, rdigs = [], []
    t0 = time.time()
    while ref.queue or ref.active:
        ref.step()
        rcomps.append(int(ref.est.tier.ctr.compactions))
        rdigs.append(_digest(ref.est.tier))
    torch.cuda.synchronize()
    out = {"phase": "launch_serve", "argv": [], "model": eng.mcfg.name,
           "layers": eng.mcfg.n_layers, "d_model": eng.mcfg.d_model,
           "kv": eng.cfg._asdict(), "requests": len(reqs), "cuda": cu,
           "reference": {"ticks": ref.stats["steps"],
                         "wall_s": time.time() - t0}}
    tokens = [r.out for r in reqs]
    out["tokens_equal"] = tokens == [r.out for r in rreqs]
    why = _explain_divergence(log, comps, {"cuda": digs, "reference": rdigs})
    out["divergence"] = why
    fails = []
    if any(len(r.out) != r.max_new for r in reqs) or \
            eng.stats["retired"] != len(reqs):
        fails.append("a request did not retire with max_new tokens")
    if not out["tokens_equal"]:
        fails.append("the legs' generated tokens differ")
    if not why["explained"]:
        fails.append("the legs' tier states part where no msc_score "
                     "near-tie accounts for it")
    reached = ["clock_update"] + (["msc_score"]
                                  if eng.counters["compactions"] else [])
    fails += [f"kernel {k} never launched" for k in reached
              if launches[k] <= 0]
    out["kernels_reached"] = reached
    out["ok"] = not fails
    if fails:
        emit(out)
        raise AssertionError("launch_serve: " + "; ".join(fails))
    return out


def _banded_layer_check(cfg, params, x, pos) -> dict:
    """Every layer of the banded forward on the model's own activations
    (the banded "cuda" blocks feed the next layer): a local layer's band
    (``banded_attention``) against the masked softmax at its window, a
    global layer's B7 core against ``attention_ref`` (max abs) and its
    block on "cuda" against "reference" (relative, Frobenius norm)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import attention, model
    from repro_torch.models.common import norm
    rel = lambda a, b: float((a - b).norm() / b.norm())
    out = {"band_rel_err": [], "global_core_max_abs_err": [],
           "global_block_rel_err": []}
    with torch.no_grad():
        for blk, (kind, use_moe, w) in zip(params["blocks"],
                                           model.layer_plan(cfg)):
            h = norm(blk["ln1"], x, cfg.norm_kind, cfg.norm_eps)
            if w > 0:
                out["band_rel_err"].append(rel(
                    attention.banded_attention(blk["mixer"], cfg, h, pos, w),
                    attention.attention(blk["mixer"], cfg, h, pos, w)))
            else:
                q, k, v = attention._qkv(blk["mixer"], cfg, h, pos)
                out["global_core_max_abs_err"].append(float(
                    (mha(q, k, v, causal=True, backend="cuda")
                     - attention_ref(q, k, v, causal=True)).abs().max()))
                del q, k, v
            y = model._block_apply(cfg, blk, x, pos, w, kind, use_moe,
                                   "cuda", banded=True)[0]
            if w <= 0:
                yr = model._block_apply(cfg, blk, x, pos, w, kind, use_moe,
                                        "reference", banded=True)[0]
                out["global_block_rel_err"].append(rel(y, yr))
                del yr
            del h
            x = y
    return out


def banded_prefill_phase(device=None):
    """gemma3-1b at its published width with ``banded_local``: the banded
    forward on backend "cuda" (B7 in the 4 global layers, the plain band
    in the 22 local ones), timed and profiled, against the masked "cuda"
    forward (B7 in all 26).  Gates: B7 launches 4 times in a banded
    forward and 26 in a masked one; every layer holds on the model's own
    activations (``_banded_layer_check``: band BLOCK_TOL, B7 core
    ATTN_CORE_TOL, global block BLOCK_TOL); the two forwards' argmax
    agree but for near-ties (``_gate_ok``).  Returns (phase line, params,
    batch, config, the banded forward's seconds)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import get_arch
    from repro_torch.models import model
    dev = torch.device(device or "cuda")
    cfg = get_arch(BANDED_MODEL).replace(banded_local=True)
    params = model.init_params(cfg, torch.Generator(dev).manual_seed(
        BANDED_SEED), device=dev)
    gen = torch.Generator(dev).manual_seed(BANDED_TOKENS_SEED)
    tokens = torch.randint(0, cfg.vocab, (BANDED_BATCH, BANDED_SEQ),
                           generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": tokens}
    out = {"phase": "banded_prefill", "model": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "windows": list(cfg.window_pattern), "tokens": list(tokens.shape),
           "param_gb": sum(p.numel() * p.element_size()
                           for p in _param_leaves(params)) / 1e9}
    logits, legs = {}, {}
    plain = cfg.replace(banded_local=False)
    for name, c in (("banded", cfg), ("masked", plain)):
        with torch.no_grad():
            model.forward(c, params, batch, backend="cuda")   # warm
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            lg, _ = model.forward(c, params, batch, backend="cuda")
            torch.cuda.synchronize()
            dt = time.time() - t0
            legs[name] = {
                "forward_s": dt, "tokens_per_s": tokens.numel() / dt,
                "flash_attention_launches": kernels.LAUNCHES[
                    "flash_attention"],
                "max_memory_allocated_gib":
                    torch.cuda.max_memory_allocated() / 2**30}
            del lg
            torch.cuda.empty_cache()
            legs[name]["profiled_forward"] = _profiled(
                lambda: model.forward(c, params, batch, backend="cuda"),
                f"profile_banded_prefill_{name}.txt")
            logits[name], _ = model.forward(c, params, batch, backend="cuda")
            if not torch.isfinite(logits[name]).all():
                raise AssertionError(f"banded_prefill ({name}): non-finite "
                                     "logits")
    out.update(legs)
    gate = _argmax_gate(logits["banded"], logits["masked"])
    out.update(gate)
    del logits
    torch.cuda.empty_cache()
    t0 = time.time()
    with torch.no_grad():
        x = params["embed"][tokens.to(torch.int64)]
    pos = torch.arange(BANDED_SEQ, device=dev)[None].expand(BANDED_BATCH,
                                                            BANDED_SEQ)
    check = _banded_layer_check(cfg, params, x, pos)
    check["seconds"] = time.time() - t0
    out["layer_check"] = check
    del x
    torch.cuda.empty_cache()
    n_global = sum(1 for w in cfg.layer_windows if w <= 0)
    fails = []
    if legs["banded"]["flash_attention_launches"] != n_global or \
            legs["masked"]["flash_attention_launches"] != cfg.n_layers:
        fails.append(
            f"flash_attention launched "
            f"{legs['banded']['flash_attention_launches']} / "
            f"{legs['masked']['flash_attention_launches']} times in a "
            f"banded / masked forward, not {n_global} / {cfg.n_layers}")
    if max(check["band_rel_err"]) > BLOCK_TOL or \
            max(check["global_core_max_abs_err"]) > ATTN_CORE_TOL or \
            max(check["global_block_rel_err"]) > BLOCK_TOL:
        fails.append("a layer differs from its plain version")
    if not _gate_ok(gate):
        fails.append("the banded and masked forwards' argmax differ beyond "
                     "near-ties")
    out["ok"] = not fails
    if fails:
        emit(out)
        raise AssertionError("banded_prefill: " + "; ".join(fails))
    return out, params, batch, cfg, legs["banded"]["forward_s"]


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_cell_check(cfg, params, batch, forward_s: float) -> dict:
    """The dry run's prediction for the banded_prefill cell held against
    the card: on a 1x1 ``make_local_mesh`` (a one-rank NCCL group), the
    argument bytes predicted from meta tensors of the run's shapes and
    dtypes must equal the bytes its params and inputs hold, and the
    embedding table laid out by ``placements`` must come back whole.  On
    one rank no leaf is cut, so this confirms shapes and dtypes only (the
    sharded bytes are held to DTensor's local shards on the CPU, in
    tests/test_torch_launch.py);
    op_cost's FLOPs of the forward on the meta device beside
    ``analysis.model_flops``, and the measured forward beside the
    compute time at the f32 peak."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun, mesh as mesh_mod
    from repro_torch.launch.specs import input_specs
    from repro_torch.models import model
    from repro_torch.roofline import analysis
    from repro_torch.roofline.op_cost import op_cost
    shape = ShapeConfig("banded_prefill", BANDED_SEQ, BANDED_BATCH,
                        "prefill")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = mesh_mod.make_local_mesh(1, 1)
        specs = (model.param_specs(cfg),
                 dryrun.batch_specs_tree(cfg, shape))
        meta = (model.init_params(cfg, None, torch.float32, "meta"),
                input_specs(cfg, shape))
        predicted = dryrun.per_device_bytes(specs, meta, mesh)
        held = sum(t.numel() * t.element_size()
                   for t in _param_leaves(params)) + sum(
            t.numel() * t.element_size() for t in batch.values())
        emb = params["embed"]
        spec = sharding.logical_to_spec(specs[0]["embed"], mesh, emb.shape)
        d = distribute_tensor(emb, mesh, sharding.placements(spec, mesh))
        whole = bool(torch.equal(d.full_tensor(), emb))
        axes = sharding.mesh_axes(mesh)
        del d
    finally:
        dist.destroy_process_group()
    t0 = time.time()
    with torch.no_grad():
        _, cost = op_cost(lambda: model.forward(cfg, *meta)[0])
    cost_s = time.time() - t0
    mf = analysis.model_flops(cfg, shape)
    out = {"mesh": axes, "argument_bytes_predicted": predicted,
           "argument_bytes_held": held, "embed_spec": list(spec),
           "embed_distributed_whole": whole,
           "op_cost_flops": cost["flops"], "op_cost_bytes": cost["bytes"],
           "op_cost_s": cost_s, "model_flops": mf,
           "forward_s": forward_s,
           "compute_s_f32": cost["flops"] / analysis.PEAK_FLOPS_F32,
           "model_compute_s_f32": mf / analysis.PEAK_FLOPS_F32,
           "mfu_f32": mf / analysis.PEAK_FLOPS_F32 / forward_s}
    if predicted != held or not whole:
        raise AssertionError(f"dryrun: predicted argument bytes "
                             f"{predicted} != {held} held, or the "
                             f"distributed table came back changed")
    return out


def dryrun_phase(procs: list, cell: dict) -> dict:
    """Collect the dry-run processes (each within DRYRUN_WAIT_S of now):
    the cells that are ok and the failed ones by name, per variant, and
    each process's seconds.  Gates: every process exits, and every cell
    of both variants is ok (the opt variant's moe cells on the
    expert-parallel dispatch)."""
    from repro_torch.configs.base import (all_archs, applicable_shapes,
                                          get_arch)
    recs = {v: [] for v in DRYRUN_VARIANTS}
    out = {"phase": "dryrun", "cell_check": cell}
    fails = []
    for variant, p, t0, log in procs:
        try:
            rc = p.wait(timeout=DRYRUN_WAIT_S)
        except subprocess.TimeoutExpired:
            rc = None
            fails.append(f"the {variant} dry run did not finish")
        out[f"{variant}_s"] = time.time() - t0
        out[f"{variant}_rc"] = rc
    for f in sorted((OUT / "dryrun_torch").glob("*.json")):
        rec = json.loads(f.read_text())
        recs[rec["variant"]].append(rec)
    cells = {(a, s.name, m) for a in all_archs()
             for s in applicable_shapes(get_arch(a))
             for m in ("16x16", "2x16x16")}
    for variant in DRYRUN_VARIANTS:
        got = {(r["arch"], r["shape"], r["mesh"]) for r in recs[variant]}
        bad = {(r["arch"], r["shape"], r["mesh"]) for r in recs[variant]
               if not r["ok"]}
        out[variant] = {"cells": len(got),
                        "ok": len(got) - len(bad),
                        "failed": sorted("_".join(c) for c in bad),
                        "run_s": sum(r.get("lower_s", 0)
                                     for r in recs[variant])}
        if got != cells:
            fails.append(f"{variant}: {len(cells - got)} cells missing")
        if bad:
            fails.append(f"{variant}: failed {sorted(bad)}")
    out["ok"] = not fails
    if fails:
        emit(out)
        raise AssertionError("dryrun: " + "; ".join(fails))
    return out


# ---------------------------------------------------------- the last slice

@contextlib.contextmanager
def _recording(module, name: str, keep):
    """While open, ``module.name`` is wrapped: ``keep(n, out)`` sees the
    output of its n-th call (from 1)."""
    orig = getattr(module, name)
    n = [0]

    def run(*a, **kw):
        out = orig(*a, **kw)
        n[0] += 1
        keep(n[0], out)
        return out

    setattr(module, name, run)
    try:
        yield
    finally:
        setattr(module, name, orig)


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _timed(fn):
    """(fn(), its seconds, the peak memory it reached in GiB, B7's
    launches), the launch counts set to 0 just before it."""
    import torch
    from repro_torch import kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.time() - t0,
            torch.cuda.max_memory_allocated() / 2**30,
            kernels.LAUNCHES["flash_attention"])


def pipeline_phase(device=None) -> dict:
    """stablelm-12b at its published width through
    ``distributed.pipeline.pipelined_forward`` on backend "cuda": a
    PIPE_STAGES-stage GPipe of PIPE_MICRO microbatches on a stand-in
    ``MeshShape`` (the stages in turn on the card), against one
    ``forward`` on "cuda" of the same tokens.  Gates: B7 launches once
    per layer per microbatch in the pipeline, once per layer in the
    forward; every stage boundary (a stage's output for a microbatch)
    equals the forward's residual after that stage's last layer for the
    same rows within BLOCK_TOL per layer of the stage (relative); the
    logits pass the argmax gate of prefill (``_gate_ok``) against the
    forward's.  Reports both times, the bubble share (S - 1) / (M + S -
    1) and the peak memory."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed import pipeline
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import model
    dev = torch.device(device or "cuda")
    cfg = get_arch(PIPE_MODEL)
    t0 = time.time()
    params = model.init_params(cfg, torch.Generator(dev).manual_seed(
        PIPE_SEED), device=dev)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ),
                           generator=torch.Generator(dev).manual_seed(
                               PIPE_TOKENS_SEED), device=dev)
    batch = {"tokens": tokens}
    per = cfg.n_layers // PIPE_STAGES
    bm = PREFILL_BATCH // PIPE_MICRO
    resid, bounds = {}, {}
    keep_fwd = lambda n, out: resid.__setitem__(n, out[0]) \
        if n % per == 0 and n < cfg.n_layers else None
    mesh = MeshShape(("pod",), (PIPE_STAGES,))
    with torch.no_grad():
        model.forward(cfg, params, batch, backend="cuda")     # warm-up
        with _recording(model, "_block_apply", keep_fwd):
            fwd, fwd_s, fwd_gib, fwd_b7 = _timed(lambda: model.forward(
                cfg, params, batch, backend="cuda")[0])
        keep_pp = lambda n, out: bounds.__setitem__(n, out)
        with _recording(pipeline, "run_stage", keep_pp):
            pp, pp_s, pp_gib, pp_b7 = _timed(
                lambda: pipeline.pipelined_forward(
                    cfg, mesh, params, batch, n_micro=PIPE_MICRO,
                    backend="cuda"))
    # the in-turn schedule's stage calls, in order: at tick t, stages
    # st = 0.. with microbatch t - st in range
    calls = [(st, t - st) for t in range(PIPE_MICRO + PIPE_STAGES - 1)
             for st in range(PIPE_STAGES) if 0 <= t - st < PIPE_MICRO]
    errs = []
    for n, (st, m) in enumerate(calls, 1):
        if st < PIPE_STAGES - 1:
            want = resid[(st + 1) * per][m * bm:(m + 1) * bm]
            errs.append({"stage": st, "microbatch": m,
                         "rel_err": _rel(bounds[n], want)})
    gate = _argmax_gate(pp, fwd)
    out = {"phase": "pipeline", "model": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "tokens": list(tokens.shape),
           "param_gb": sum(p.numel() * p.element_size()
                           for p in _param_leaves(params)) / 1e9,
           "init_params_s": t_init, "stages": PIPE_STAGES,
           "microbatches": PIPE_MICRO, "mesh": "stand-in pod=2, in turn",
           "forward_s": fwd_s, "pipelined_s": pp_s,
           "forward_tokens_per_s": tokens.numel() / fwd_s,
           "pipelined_tokens_per_s": tokens.numel() / pp_s,
           "bubble_share": (PIPE_STAGES - 1) / (PIPE_MICRO + PIPE_STAGES - 1),
           "forward_peak_gib": fwd_gib, "pipelined_peak_gib": pp_gib,
           "flash_attention_launches_forward": fwd_b7,
           "flash_attention_launches_pipelined": pp_b7,
           "stage_boundaries": errs, "boundary_tol": BLOCK_TOL * per,
           **gate}
    del params, fwd, pp, resid, bounds
    torch.cuda.empty_cache()
    bad = [e for e in errs if not e["rel_err"] <= BLOCK_TOL * per]
    if (fwd_b7 != cfg.n_layers or pp_b7 != cfg.n_layers * PIPE_MICRO
            or len(errs) != PIPE_MICRO * (PIPE_STAGES - 1) or bad
            or not _gate_ok(gate)):
        emit(out)
        raise AssertionError("pipeline: B7's launches, a stage boundary or "
                             "the logits' argmax gate failed")
    return out


def moe_ep_local_phase(device=None) -> dict:
    """qwen3-moe-235b-a22b at its published width, MOE_LAYERS layers:
    every MoE layer, on the model's own activations (the "cuda" forward's
    hidden state, B7 in its attention), through the global dispatch and
    through ``moe_ffn_ep_local`` on a 1x1 ("data", "model")
    ``DeviceMesh`` over a one-rank NCCL group (the DeviceMesh dispatch at
    ep 1: it skips the "model" group's ``all_reduce``, so no collective
    runs on the card) and on a stand-in of MOE_RANKS model ranks (each
    rank's experts in turn).  Gates: the kept (token, expert) pairs
    (``moe.ep_local_kept`` of ep_local's experts, outside the dispatch)
    equal the global dispatch's; outputs within MOE_TOL (relative); aux
    within MOE_AUX_TOL; ep_local's ``dropped`` is 0 whatever the global
    dispatch drops (F8, logged).  Then the whole forward under both
    dispatches (ep_local on the 1x1 DeviceMesh) through the argmax gate
    of prefill, each timed."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_arch
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import attention, model, moe
    from repro_torch.models.common import norm
    dev = torch.device(device or "cuda")
    cfg = get_arch(MOE_MODEL).replace(n_layers=MOE_LAYERS)
    t0 = time.time()
    params = model.init_params(cfg, torch.Generator(dev).manual_seed(
        MOE_SEED), device=dev)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ),
                           generator=torch.Generator(dev).manual_seed(
                               MOE_TOKENS_SEED), device=dev)
    batch = {"tokens": tokens}
    out = {"phase": "moe_ep_local", "model": cfg.name,
           "layers": cfg.n_layers, "published_layers":
               get_arch(MOE_MODEL).n_layers, "reduced": "depth 94 -> 4",
           "d_model": cfg.d_model, "experts": cfg.n_experts,
           "top_k": cfg.top_k, "expert_d_ff": cfg.d_ff,
           "capacity_factor": cfg.capacity_factor,
           "tokens": list(tokens.shape),
           "param_gb": sum(p.numel() * p.element_size()
                           for p in _param_leaves(params)) / 1e9,
           "init_params_s": t_init, "layer_check": []}
    # NCCL on the card; gloo in a CPU rehearsal
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    local = mesh_mod.make_local_mesh(1, 1)
    stand_in = mesh_mod.MeshShape(("data", "model"), (1, MOE_RANKS))
    fails = []
    try:
        with torch.no_grad():
            x = params["embed"][tokens]
            pos = torch.arange(PREFILL_SEQ, device=dev)[None].expand(
                PREFILL_BATCH, PREFILL_SEQ)
            for l, blk in enumerate(params["blocks"]):
                h = norm(blk["ln1"], x, cfg.norm_kind, cfg.norm_eps)
                x = x + attention.attention(blk["mixer"], cfg, h, pos, -1,
                                            backend="cuda")
                h = norm(blk["ln2"], x, cfg.norm_kind, cfg.norm_eps)
                t0 = time.time()
                want, wx = moe.moe_ffn_global(blk["ffn"], cfg, h)
                torch.cuda.synchronize()
                row = {"layer": l, "global_s": time.time() - t0,
                       "global_dropped": float(wx["dropped"]),
                       "global_aux": float(wx["aux_loss"]),
                       "kept_pairs": int(wx["kept"].sum())}
                for name, m in (("device_mesh_1x1", local),
                                (f"stand_in_{MOE_RANKS}_ranks", stand_in)):
                    t0 = time.time()
                    with sharding.use_mesh(m):
                        got, gx = moe.moe_ffn_ep_local(blk["ffn"], cfg, h)
                    torch.cuda.synchronize()
                    r = {"s": time.time() - t0, "rel_err": _rel(got, want),
                         "max_abs_err": float((got - want).abs().max()),
                         "kept_equal": bool(torch.equal(
                             moe.ep_local_kept(cfg, gx["experts"]),
                             wx["kept"])),
                         "experts_equal": bool(torch.equal(
                             gx["experts"], wx["experts"])),
                         "aux": float(gx["aux_loss"]),
                         "dropped": float(gx["dropped"])}
                    r["aux_rel_err"] = abs(r["aux"] - row["global_aux"]) \
                        / abs(row["global_aux"])
                    row[name] = r
                    if not (r["kept_equal"] and r["experts_equal"]
                            and r["rel_err"] <= MOE_TOL
                            and r["aux_rel_err"] <= MOE_AUX_TOL
                            and r["dropped"] == 0.0):
                        fails.append((l, name))
                out["layer_check"].append(row)
                x = x + want
            del x, h, want, got
            lg, out["forward_global_s"], out["forward_global_peak_gib"], \
                out["flash_attention_launches_global"] = _timed(
                    lambda: model.forward(cfg, params, batch,
                                          backend="cuda")[0])
            ecfg = cfg.replace(moe_dispatch="ep_local")
            with sharding.use_mesh(local):
                elg, out["forward_ep_local_s"], \
                    out["forward_ep_local_peak_gib"], \
                    out["flash_attention_launches_ep_local"] = _timed(
                        lambda: model.forward(ecfg, params, batch,
                                              backend="cuda")[0])
    finally:
        dist.destroy_process_group()
    out["end_to_end"] = _argmax_gate(elg, lg)
    del params, lg, elg
    torch.cuda.empty_cache()
    b7 = (out["flash_attention_launches_global"],
          out["flash_attention_launches_ep_local"])
    if fails or not _gate_ok(out["end_to_end"]) or b7 != (cfg.n_layers,) * 2:
        emit(out)
        raise AssertionError(f"moe_ep_local: layer checks failed at "
                             f"{fails}, or the end-to-end argmax gate or "
                             "B7's launches")
    return out


def starcoder2_prefill_phase(device=None) -> dict:
    """starcoder2-15b's prefill forward at full width (40 layers, float32
    weights from STARCODER_SEED): ``loss_fn`` and ``forward`` on backend
    "cuda" (B7 in every layer: q [2, 48, 2048, 128], kv [2, 4, 2048,
    128], causal; profiled) and "reference" (the masked softmax).  Gates:
    B7 launches once per layer on "cuda" and never on "reference"; the
    argmax gate of prefill (``_gate_ok``); every layer's B7 core and
    block (``_attn_layer_check``, ``_layer_gate``)."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.models import model
    dev = torch.device(device or "cuda")
    cfg = get_arch(STARCODER_MODEL)
    t0 = time.time()
    params = model.init_params(cfg, torch.Generator(dev).manual_seed(
        STARCODER_SEED), device=dev)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ),
                           generator=torch.Generator(dev).manual_seed(
                               STARCODER_TOKENS_SEED), device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    out = {"phase": "starcoder2_prefill", "model": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "tokens": list(tokens.shape), "init_params_s": t_init,
           "param_gb": sum(p.numel() * p.element_size()
                           for p in _param_leaves(params)) / 1e9}
    legs, logits = _forward_legs(cfg, params, batch,
                                 {"flash_attention": cfg.n_layers},
                                 "starcoder2_prefill")
    _prefill_shares(legs)
    out.update(legs)
    gate = _argmax_gate(logits["cuda"], logits["reference"])
    out.update(gate)
    out["loss_abs_diff"] = abs(legs["cuda"]["loss"]
                               - legs["reference"]["loss"])
    del logits
    torch.cuda.empty_cache()
    t0 = time.time()
    pos = torch.arange(PREFILL_SEQ, device=dev)[None].expand(
        PREFILL_BATCH, PREFILL_SEQ)
    check, _ = _attn_layer_check(
        cfg, params["blocks"], params["embed"][tokens], pos, True,
        lambda blk, x, bk: model._block_apply(cfg, blk, x, pos, -1, "attn",
                                              False, bk)[0])
    check["seconds"] = time.time() - t0
    out["layer_check"] = check
    del params
    torch.cuda.empty_cache()
    _layer_gate("starcoder2_prefill", out, {"decoder": check})
    if not _gate_ok(gate):
        emit(out)
        raise AssertionError("starcoder2_prefill: the backends' argmax "
                             "differ beyond near-ties")
    return out


def _run_example(name: str, argv: list):
    """``examples/<name>.py``'s ``main(argv)`` in this process: (its
    standard output, its return value, the kernels' launches, seconds),
    the launch counts set to 0 just before it."""
    import importlib.util
    import io
    import torch
    from repro_torch import kernels
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        ret = mod.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return buf.getvalue(), ret, dict(kernels.LAUNCHES), time.time() - t0


def examples_phase(device=None) -> dict:
    """The three examples' ``main`` in this process, on the card (backend
    "cuda": B1-B5 under them) and again on the CPU on backend
    "reference".  Gates: quickstart_torch and workloads_demo_torch print
    the same text on both (every integer the JAX examples print; the
    tests hold those); serve_tiered_torch passes its own asserts on the
    card; every example launches B1 on the card, serve_tiered_torch the
    paged-KV movers B3-B5 too."""
    out = {"phase": "examples"}
    fails = []
    for name in EXAMPLES:
        argv = ["--device", device] if device else []
        text, ret, launches, secs = _run_example(name, argv)
        row = {"s": secs, "launches": {k: v for k, v in launches.items()
                                       if v},
               "last_lines": text.strip().splitlines()[-3:]}
        if name != "serve_tiered_torch":
            ref, _, _, ref_s = _run_example(
                name, ["--device", "cpu", "--backend", "reference"])
            row["cpu_reference_s"] = ref_s
            row["equal_to_cpu_reference"] = text == ref
            if text != ref:
                row["output"], row["cpu_reference_output"] = text, ref
                fails.append(name)
        else:
            row["retired"] = ret.stats["retired"]
            row["compactions"] = ret.stats["compactions"]
            row["demoted"] = ret.counters["demoted"]
        need = ("clock_update",) + (("select_gather_rows", "scatter_rows",
                                     "gather_rows")
                                    if name == "serve_tiered_torch" else ())
        if device is None and not all(launches.get(k) for k in need):
            fails.append(f"{name}: launches {row['launches']}")
        out[name] = row
    if fails:
        emit(out)
        raise AssertionError(f"examples: {fails}")
    return out


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs.prismdb_kv import paper_tier_config
    from repro_torch.kernels import build
    t_start = time.time()
    _T_START.append(t_start)
    OUT.mkdir(exist_ok=True)
    (OUT / "smoke.jsonl").write_text("")
    smi = smi_line()
    t0 = time.time()
    report = build.build_all()
    OUT.mkdir(exist_ok=True)
    if report:
        (OUT / "ptxas.txt").write_text("\n\n".join(
            f"== {k}\n{v['ptxas']}" for k, v in report.items()))
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.time() - t0, "built": sorted(report)})
    flash_sass = _kernel_instances(report, "flash_attention")
    paged_sass = _kernel_instances(report, "paged_attention",
                                   ("FFMA", "SHFL", "LDG", "MUFU"))
    emit({"phase": "sass", "flash_attention": flash_sass,
          "paged_attention": paged_sass})
    bad = [k for k, v in flash_sass.items() if "flash_bf16" in k
           and v["HMMA"] + v["HGMMA"] == 0] + [
        k for k, v in flash_sass.items() if ("Li128E" in k or "Li256E" in k)
        and v.get("spill_bytes", 0) > 0] + [
        k for k, v in paged_sass.items() if v.get("spill_bytes", 0) > 0]
    if bad:
        raise AssertionError(f"a flash_attention bf16 instance without "
                             f"tensor-core instructions, or a D 128/256 "
                             f"flash_attention or any paged_attention "
                             f"instance that spills: {bad}")

    # the dry run of every cell runs beside the card's phases, in
    # processes of its own on the host (collected in the dryrun phase)
    dry = start_dryrun()
    try:
        from repro_torch.core.embedding_store import EmbedStoreConfig
        rng = np.random.default_rng(0)
        full = paper_tier_config(FULL_SCALE)
        embed_cfg = EmbedStoreConfig(vocab=EMBED_VOCAB, dim=EMBED_DIM,
                                     fast_rows=EMBED_FAST_ROWS)
        rows = [check_clock_update(full, BATCH, rng), check_msc_score(full, rng)]
        rows += check_tier_compact(full, embed_cfg, rng)
        rows.append(check_flash_attention(rng, flash_sass))
        rows.append(check_rwkv6_scan(rng, _kernel_instances(
            report, "rwkv6_scan", ("FFMA", "FMUL", "FADD", "LDS", "STS"))))
        rows.append(check_mamba_scan(rng, _kernel_instances(
            report, "mamba_scan", ("FFMA", "FMUL", "FADD", "MUFU", "LDS",
                                   "SHFL"))))
        emit({"phase": "kernels", "rows": rows})

        # the model phases: phi4-mini-3.8b at full width, prefill and serving
        from repro_torch.configs.base import get_arch
        from repro_torch.models import model
        mcfg = get_arch(MODEL)
        t0 = time.time()
        params = model.init_params(
            mcfg, torch.Generator("cuda").manual_seed(MODEL_SEED))
        torch.cuda.synchronize()
        t_init = time.time() - t0
        pre = prefill_phase(params, mcfg)
        pre["init_params_s"] = t_init
        emit(pre)
        srv, b6 = serve_phase(params, mcfg)
        emit(srv)
        rows.append({**b6, "instances": paged_sass})
        del params
        torch.cuda.empty_cache()

        # rwkv6-7b at full width: the prefill forward on B8, then the decode
        rcfg = get_arch(RWKV_MODEL)
        t0 = time.time()
        params, us = rwkv_params(rcfg)
        torch.cuda.synchronize()
        t_init = time.time() - t0
        rpre, rtok, rlogits = rwkv_prefill_phase(params, rcfg, us)
        rpre["init_params_s"] = t_init
        emit(rpre)
        emit(rwkv_decode_phase(params, rcfg, rtok, rlogits))
        del params, us, rtok, rlogits
        torch.cuda.empty_cache()

        # jamba-v0.1-52b at full width, one period: the prefill forward on B9
        # and B7, then the hybrid decode
        jcfg = jamba_config()
        t0 = time.time()
        params = model.init_params(jcfg, torch.Generator("cuda").manual_seed(
            JAMBA_SEED))
        torch.cuda.synchronize()
        t_init = time.time() - t0
        jpre, jtok = jamba_prefill_phase(params, jcfg)
        jpre["init_params_s"] = t_init
        emit(jpre)
        emit(jamba_decode_phase(params, jcfg, jtok))
        del params, jtok
        torch.cuda.empty_cache()

        # qwen2-vl-2b at full width: the prefill forward on B7 from patch
        # embeddings and M-RoPE positions, then serving through the tiered KV
        # cache (B1-B5, B6 on its live pools)
        vcfg = get_arch(VLM_MODEL)
        t0 = time.time()
        params = model.init_params(vcfg, torch.Generator("cuda").manual_seed(
            VLM_SEED))
        torch.cuda.synchronize()
        t_init = time.time() - t0
        vpre = vlm_prefill_phase(params, vcfg)
        vpre["init_params_s"] = t_init
        emit(vpre)
        vsrv, _ = serve_phase(params, vcfg, VLM_SERVE_SEED,
                              shape=VLM_SERVE_SHAPE, phase="vlm_serve")
        emit(vsrv)
        del params
        torch.cuda.empty_cache()

        # whisper-small at full width: the encoder-decoder forward on B7, then
        # the decode from a cross cache the encoder's output fills
        wcfg = get_arch(WHISPER_MODEL)
        t0 = time.time()
        params = model.init_params(wcfg, torch.Generator("cuda").manual_seed(
            WHISPER_SEED))
        torch.cuda.synchronize()
        t_init = time.time() - t0
        wpre, wbatch, wlogits = whisper_prefill_phase(params, wcfg)
        wpre["init_params_s"] = t_init
        emit(wpre)
        emit(whisper_decode_phase(params, wcfg, wbatch, wlogits))
        del params, wbatch, wlogits
        torch.cuda.empty_cache()

        # the launch plane: the serving launcher at its defaults, gemma3-1b's
        # banded prefill at full width, and the dry run's prediction for
        # that cell held against the card
        emit(launch_serve_phase())
        torch.cuda.empty_cache()
        bpre, params, batch, bcfg, b_fwd_s = banded_prefill_phase()
        emit(bpre)
        cell = dryrun_cell_check(bcfg, params, batch, b_fwd_s)
        del params, batch
        torch.cuda.empty_cache()

        # gemma3-1b's training at full width through the launcher, on the
        # plain paths (no kernel has a backward), and its gates
        emit(train_phase())
        torch.cuda.empty_cache()

        # the last slice: stablelm-12b through the GPipe pipeline,
        # qwen3-moe's expert-parallel dispatch, starcoder2-15b's prefill
        # (B7 in every attention layer of each), and the three examples
        emit(pipeline_phase())
        emit(moe_ep_local_phase())
        emit(starcoder2_prefill_phase())
        emit(examples_phase())
        torch.cuda.empty_cache()
        line, base = engine_parity(BATCH)
        emit(line)
        line, _ = engine_parity(BATCH, quantum=DRAIN_Q, base=base)
        del base
        emit(line)

        # main at SCALE, then the same recipe at quantum DRAIN_Q: the end
        # tier state and every per-op result must be bit-equal
        small = paper_tier_config(SCALE)
        rec0, recq = [], []
        res, db0 = main_path(SCALE, BATCH, SEGMENT, small.key_space // 2,
                             record=rec0)
        emit(res)
        res, dbq = main_path(SCALE, BATCH, SEGMENT, small.key_space // 2,
                             quantum=DRAIN_Q, record=recq)
        res["phase"] = "main_quantum"
        res["tier_leaves_equal_main"] = _same_tier(db0, dbq)
        res["results_equal_main"] = _same_results(rec0, recq)
        del db0, dbq, rec0, recq
        emit(res)

        # the paper's traffic through run_workload, then three tiers run to
        # completion and at quantum DRAIN_Q (equal to run to completion)
        emit(workloads_phase())
        line, base = three_tier_phase()
        emit(line)
        line, _ = three_tier_phase(quantum=DRAIN_Q, base=base)
        del base
        emit(line)
        # the partitioned store: routed batches and one tenant a partition
        emit(partitioned_phase())

        # the full-size state, run to completion and at quantum DRAIN_Q; the
        # two 9 GiB states are compared through per-leaf checksums
        rec0, recq = [], []
        full_res, db = main_path(FULL_SCALE, BATCH, FULL_SEGMENT,
                                 FULL_PRELOAD_KEYS,
                                 profile_steps=FULL_PROFILE_STEPS, record=rec0,
                                 pre_batch=FULL_PRELOAD_BATCH)
        full_res["phase"] = "main_full"
        full_res["select_range"] = select_range_profile(db)
        digest = _digest(db.estate.tier)
        del db
        emit(full_res)
        fq_res, db = main_path(FULL_SCALE, BATCH, FULL_SEGMENT,
                               FULL_PRELOAD_KEYS,
                               profile_steps=FULL_PROFILE_STEPS,
                               quantum=DRAIN_Q, record=recq,
                               pre_batch=FULL_PRELOAD_BATCH)
        fq_res["phase"] = "main_full_quantum"
        if _digest(db.estate.tier) != digest:
            raise AssertionError("main_full_quantum: the end tier state differs "
                                 "from main_full's (per-leaf checksums)")
        fq_res["tier_leaf_checksums_equal_main_full"] = len(digest)
        fq_res["results_equal_main_full"] = _same_results(rec0, recq)
        del db, rec0, recq
        emit(fq_res)

        emb = embed_phase()
        emit(emb)
        emit(embed_phase(steps=EMBED_DIAG_STEPS, tokens=EMBED_DIAG_TOKENS,
                         diagnose=True))
        # launches: each kernel's count in the full-size run of its path
        # (B7: per "cuda" forward of the prefill phase; B8: of rwkv_prefill;
        # B9: of jamba_prefill; B6: its entry point's call on the serve
        # phase's live pools)
        where = {"clock_update": full_res, "msc_score": full_res,
                 "select_gather_rows": fq_res, "scatter_rows": fq_res,
                 "gather_rows": emb["cuda"]}
        for r in rows:
            if r["name"] == "flash_attention":
                r["launches"] = pre["cuda"]["flash_attention_launches_per_forward"]
            elif r["name"] == "rwkv6_scan":
                r["launches"] = rpre["cuda"]["rwkv6_scan_launches_per_forward"]
            elif r["name"] == "mamba_scan":
                r["launches"] = jpre["cuda"]["mamba_scan_launches_per_forward"]
            elif r["name"] != "paged_attention":
                r["launches"] = where[r["name"]]["launches"][r["name"]]
        emit(dryrun_phase(dry, cell))
        emit({"phase": "done", "elapsed_s": time.time() - t_start})
        emit({"kernels": [{k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
            for r in rows]})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

    finally:
        stop_dryrun(dry)

if __name__ == "__main__":
    sys.exit(main())
