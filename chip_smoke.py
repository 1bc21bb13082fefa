#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one CUDA card.

Builds the port's Hopper kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card, and drives the
port's paths through them:

* the YOLOv3 case study (``repro_torch.case_study``) at the model's full
  416 x 416 width plus all 75 conv layers of a frame, and the paper
  chain (model-mode anchors exactly, simulated mode on the card bit for
  bit against the CPU);
* the paper's simulator at its own sizes (``repro_torch.core.sweep`` and
  ``socsim``): the Fig. 5 sweep over the whole 6,155,982-burst frame,
  the Fig. 6 sweep, 24 way-partitioned and unpartitioned interference
  lanes batched and one by one, one lane's per-chunk latencies and the
  FAME-1 LLC -> DRAM pipeline under random host stalls, every result
  held bit for bit to the JAX reference's (anchors below, from the
  reference on the CPU);
* the campaign run farm and the NPU backend (``repro_torch.campaign``,
  ``repro_torch.core.npu``) at the campaign benchmark's own sizes: the
  64-point acceptance campaign sequential, batched and over a mesh of
  the card(s); an NVDLA + NPU campaign through injected crashes, hangs,
  NaNs, torn writes and corruptions and the resumes after them; the
  NPU timing model over the four zoo workloads; the mamba2-130m serving
  oracle on the NPU's weight stream; the campaign CLI — every manifest
  byte-identical to the reference's (sha256 anchors below);
* serving mamba2-130m at full width (``repro_torch.serve.ServeEngine``,
  24 layers, d_model 768, random weights from a seed): 8 requests of
  512 and 300 tokens, 32 new tokens each, 4 slots, with the engine's
  stats, step log and oracle costs held exactly to the JAX reference's
  (anchors below, from the reference on the CPU), the SSD kernel held
  to its plain version on every layer's operands of each prefill group,
  and each group's first-token logits through the kernel held to the
  plain version's in an fp32 prefill;
* serving recurrentgemma-9b at full width (38 layers, d_model 4096, 12
  local-attention layers with a 2048-token window, random weights from
  a seed): 8 requests of 2560 and 2100 tokens, 16 new tokens each, 4
  slots, held the same way to the reference's anchors, with the SWA
  kernel held to its plain version on every attention layer's own
  operands of each prefill group, and each group's first-token logits
  through the kernel held to the plain version's in an fp32 prefill;
* the SoC farm (``repro_torch.core.farm`` and ``noc``) at
  benchmarks/fig6_tail.py's full sizes: nodes 0, 1, 2 and 4, 2048
  bursts, a 256 KiB LLC, unpartitioned and way-partitioned, every
  summary held exactly to the reference's, and the token-bundle switch
  held bit for bit to the per-cycle scheduler at bundles 1, 7 and 64;
* the dense transformer family through the SWA kernel's full causal
  band (window = S): serving qwen2-0.5b at full width (24 layers, 14
  query heads over 2 KV heads of 64): 8 requests of 2048 and 1200
  tokens, 32 new tokens each, 4 slots, held the same way to the
  reference's anchors; and granite-3-8b at full width (40 layers, 32
  query heads over 8 KV heads of 128, 8.4 G fp32 parameters): one
  2048-token prefill and 8 greedy decode steps, the kernel held to its
  plain version on every layer's operands and, in fp32, the logits and
  the greedy tokens of kernel and plain held together;
* the MoE family through the SWA kernel: serving mixtral-8x7b at full
  width (d_model 4096, 32 query heads over 8 KV heads of 128, window
  4096, 8 experts top-2 of d_ff 14336) cut to 8 of its 32 layers (11.9
  G fp32 parameters; the full depth does not fit one card): 8 requests
  of 5120 and 4200 tokens, banded past the window, held to the
  reference's anchors; and grok-1-314b at full width (48 query heads
  over 8 KV heads of 128, softcap 30, 8 experts of d_ff 32768) cut to
  2 of its 64 layers: one 2048-token prefill and 8 greedy decode steps,
  checked as granite-3-8b;
* the encoder-decoder stack: serving whisper-tiny at full width and
  depth (4 encoder + 4 decoder layers, 6 heads of 64, 1500 frames a
  request as the engine's ``extras``): 8 requests of 224 and 120
  decoder tokens, 32 new tokens each, held the same way;
* the VLM input stage: internvl2-26b at full width (48 query heads over
  8 KV heads of 128, d_model 6144) cut to 24 of its 48 layers: 256
  seeded patch embeddings and 2048 tokens in one prefill through the
  SWA kernel's full causal band over 2304 positions, 8 greedy decode
  steps, checked as granite-3-8b;
* int8 KV caches: deepseek-7b at full width and depth (32 query over 32
  KV heads of 128) prefilling into and decoding from int8 caches,
  checked as granite-3-8b, its first decode logits held against the
  bf16 cache's; and the SSD kernel with 2 and 8 SSM groups at
  mamba2-130m's widths, one launch a group;
* training: the swa backward kernels (``csrc/swa_bwd.cu``: bf16 on the
  tensor cores up to D 128, from the forward's log-sum-exp, which is
  held to the plain one; fp32 and D 256 on the FMA grids) held to the
  plain backward at every arch shape, qwen2-0.5b's training shape, a
  ragged S at every head dim and a soft-capped band, in bf16 and fp32,
  and two bf16 launches bit-equal; then qwen2-0.5b at full width and
  depth trained through ``repro_torch.train.loop.train`` (batch 4 x
  1024, 12 AdamW steps, async checkpoints every 4, a failure injected
  at step 6): losses finite and falling, the resumed steps' losses
  equal to an unbroken run's, the backward kernel once a layer a step
  on the tensor cores and no plain attention, and one step through the
  kernels held to the same step through the plain attention and
  autograd;
* training the SSM family: the ssd backward kernels (``csrc/ssd_bwd.cu``,
  3xTF32 on tf32 ``wgmma``) held to the closed-form plain backward in
  float64 at every ``SSD_SHAPES`` case, a group's launch at 2 and 8 SSM
  groups, 3 heads at a ragged chunk of 300, p and n off TMA's 16-byte
  strides and mamba2-130m's training shape, through the op with 2 and 8
  groups, and two launches bit-equal; then mamba2-130m at full width and
  depth trained through ``repro_torch.train.loop.train`` (batch 4 x
  2048, 8 AdamW steps): losses finite, the backward kernel once a layer
  a step, the forward twice, no plain SSD, and one step through the
  kernels held to the same step through the plain SSD and its plain
  backward in fp32 and in bf16;
* the quickstart twin (``repro_torch.quickstart``) on the card: the
  paper numbers equal to the anchors, 20 training steps of qwen2's
  reduced config through the swa kernels, four requests served.

Before the paths it times every kernel beside its plain version, a
PyTorch library call where one computes the same function, and its
roofline bound: the kernels and the library calls alike by their device
time (CUDA events around back-to-back calls queued behind a device-side
wait, so that the host's launch pace does not show), with the sum of
the device events of a torch.profiler window that runs only that call
and CUDA events over calls as the host issues them beside it.

Run from the repository root:   python3 chip_smoke.py

Prints each phase, then the card's name and power limit (as nvidia-smi
gives them), a JSON line of per-kernel numbers, and last
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
non-zero and the last line is not printed.  Per-layer timings also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): int8 and TF32 tensor cores,
# fp32 FMA and HBM3
INT8_OPS_PER_S = 1979e12
TF32_OPS_PER_S = 495e12
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
TOL = dict(rtol=1e-5, atol=1e-5)

# test_kernels.py's shapes, then YOLOv3-416 layer 0 and layer 1 (the
# heaviest conv, 0.80 GMAC)
MATMUL_SHAPES = [(128, 128, 128), (256, 512, 256), (384, 640, 128),
                 (100, 200, 60), (1, 2048, 1000), (173056, 27, 32),
                 (43264, 288, 64)]
# postproc (N, H, W, C), each at pool 1, 2 and 3 in both input dtypes:
# test_kernels.py's shapes; C 12 (a multiple of the fp32 vector, not of
# the bf16 one: the ring read one channel at a time) on odd H; C 3 on odd
# H and W, whose rows (348 B fp32, 174 B bf16) are not a multiple of 16
# bytes (the direct path); a ragged W cut into several spans; the main
# path's map
POSTPROC_SHAPES = [(2, 32, 32, 16), (2, 64, 64, 8), (2, 30, 30, 8),
                   (2, 16, 16, 128), (2, 31, 30, 12), (2, 29, 29, 3),
                   (2, 12, 18, 8), (1, 45, 211, 64), (1, 208, 208, 64)]
POSTPROC_POOLS = (1, 2, 3)
ACTS = ("none", "relu", "sigmoid", "tanh")
DTYPES = (torch.float32, torch.bfloat16)
FIG5 = dict(sizes_kib=(0.5, 64, 1024, 4096), blocks=(32, 64, 128))

# SSD intra-chunk (bb, l, chunk, h, p, n): test_kernels.py's shapes, the
# serving path's full width (4 prompts of 512 = 2 chunks of 256) and a
# 300-token prompt (one ragged chunk of 300)
SSD_SHAPES = [(2, 64, 32, 4, 16, 32), (2, 128, 32, 8, 32, 64),
              (2, 32, 32, 2, 16, 16), (4, 512, 256, 24, 64, 128),
              (4, 300, 256, 24, 64, 128)]
# grouped SSD (ssm_ngroups g > 1) at mamba2-130m's widths: one launch
# per group over its h / g contiguous heads (12 and 3 heads)
SSD_GROUPS = (2, 8)
SSD_TOL = dict(rtol=1e-4, atol=1e-4)   # the reference's own for this kernel
# first-token logits, SSD step through the kernel vs its plain version,
# both prefills in fp32: the reference's one-step bf16 decode-parity
# tolerance.  The kernel's 3xTF32 products agree with the plain version
# to ~1e-4, not bit for bit, and in bf16 the 24 random-weight layers
# amplify the bf16 rounding flips that such differences cause to logit
# differences above 0.08 (as for recurrentgemma-9b's attention, below),
# so bf16 is held layer by layer (each layer's own SSD operands, 1e-4)
# and by the first tokens, and its logit difference is reported.
LOGITS_TOL = dict(rtol=2e-2, atol=0.08)

# SWA attention (b, s, hq, hkv, d, window, softcap, input scale), each in
# fp32 (the FMA kernel, 2e-5) and bf16 (the tensor-core kernel, 2e-2):
# test_kernels.py's (s, window) pairs at b 2, hq 4, hkv 2, d 32 and its
# softcap case (s 64, window 64, cap 30, inputs x3); a ragged band at
# every head dim the kernels are built for; recurrentgemma-9b's heads (16
# query, 1 KV, D 256) banded, soft-capped, with window >= S and at its
# ragged 2100-token prompt; the dense archs' full causal bands (window =
# S) at qwen2-0.5b's heads (14 query over 2 KV, a group of 7, D 64) at
# its 2048- and ragged 1200-token prompts and granite-3-8b's (32 over 8,
# D 128); mixtral-8x7b's band narrower than its 5120-token prompt
# (window 4096, 32 over 8 heads, D 128), grok-1-314b's full causal
# 2048 tokens with softcap 30 (48 over 8, D 128) and whisper-tiny's
# decoder at 224 tokens (6 over 6, D 64); internvl2-26b's full causal
# 2304 positions (256 patches + 2048 tokens, 48 over 8, D 128) and
# deepseek-7b's 2048 tokens without grouping (32 over 32, D 128); then
# recurrentgemma-9b's full-width prefill shape, bf16
SWA_CASES = [(2, s, 4, 2, 32, w, 0.0, 1.0)
             for s, w in [(128, 32), (128, 64), (256, 256), (96, 32)]] \
    + [(1, 64, 2, 2, 32, 64, 30.0, 3.0)] \
    + [(2, 200, 4, 2, d, 50, 0.0, 1.0) for d in (16, 32, 64, 128, 256)] \
    + [(1, 300, 16, 1, 256, 64, 0.0, 1.0), (1, 300, 16, 1, 256, 128, 30.0, 3.0),
       (1, 300, 16, 1, 256, 4096, 0.0, 1.0),
       (1, 2100, 16, 1, 256, 2048, 0.0, 1.0)] \
    + [(1, 2048, 14, 2, 64, 2048, 0.0, 1.0),
       (3, 1200, 14, 2, 64, 1200, 0.0, 1.0),
       (2, 2048, 32, 8, 128, 2048, 0.0, 1.0)] \
    + [(1, 5120, 32, 8, 128, 4096, 0.0, 1.0),
       (1, 2048, 48, 8, 128, 2048, 30.0, 1.0),
       (1, 224, 6, 6, 64, 224, 0.0, 1.0)] \
    + [(1, 2304, 48, 8, 128, 2304, 0.0, 1.0),
       (1, 2048, 32, 32, 128, 2048, 0.0, 1.0)]
SWA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SWA_FULL = (1, 2560, 16, 1, 256, 2048)
# the served archs' full-width prefill shapes (b, s, hq, hkv, d,
# window, softcap), bf16: the dense archs' full causal bands (window =
# S; qwen2-0.5b and granite-3-8b, 1 x 2048), mixtral-8x7b's band of 4096
# over 5120 tokens, grok-1-314b's soft-capped full causal 2048,
# whisper-tiny's decoder at 224 tokens, internvl2-26b's 256 patches and
# 2048 tokens (groups of 6) and deepseek-7b's 2048 (no grouping)
SWA_ARCHS = {"qwen2-0.5b": (1, 2048, 14, 2, 64, 2048, 0.0),
             "granite-3-8b": (1, 2048, 32, 8, 128, 2048, 0.0),
             "mixtral-8x7b": (1, 5120, 32, 8, 128, 4096, 0.0),
             "grok-1-314b": (1, 2048, 48, 8, 128, 2048, 30.0),
             "whisper-tiny": (1, 224, 6, 6, 64, 224, 0.0),
             "internvl2-26b": (1, 2304, 48, 8, 128, 2304, 0.0),
             "deepseek-7b": (1, 2048, 32, 32, 128, 2048, 0.0)}
BF16_OPS_PER_S = 989e12
# first-token logits through the SWA kernel vs the plain version, both
# prefills in fp32: the reference's one-step decode-parity tolerance for
# recurrentgemma-9b.  In bf16 the 38 random-weight layers amplify the
# one-ulp differences of two summation orders in every attention output
# to logit differences of 0.1 and more, so bf16 is held layer by layer
# (each attention layer's own operands, 2e-2) and by the first tokens.
RG_LOGITS_TOL = dict(rtol=2e-2, atol=2e-2)

# Full-width recurrentgemma-9b serving anchors: the JAX reference's
# ServeEngine on the same traffic and oracle, on the CPU, with the
# engine's model calls replaced by stubs that return zero logits and
# well-shaped caches (with eos_id=-1 no cycle count depends on the
# tokens, and a full-width JAX forward is out of a CPU's reach).  The
# model streams 19,145,129,984 bytes of weights per step, more than fit
# below the paged-KV region, so the oracle models a resident subset of
# 256 MiB (weight_bytes=).  Oracle costs for 4 requests of (2560, 16) in
# PagedKVCache(num_blocks=644, block_size=16, token_bytes=12288).
RG_WEIGHT_BYTES = 268_435_456
RG_STATS = {
    "requests": 8, "tokens": 128, "steps": 33, "prefill_steps": 4,
    "decode_steps": 32, "idle_steps": 0, "sim_time_s": 3.49410636,
    "tokens_per_s": 36.63311496905893, "latency_p50_s": 1.82730774,
    "latency_p99_s": 3.49360636, "mean_occupancy": 3.878787878787879,
    "max_occupancy": 4}
RG_STEP_RUNS = [("prefill", 257134592, 1), ("mixed", 554039072, 1),
                ("decode", 320125824, 14), ("mixed", 554769568, 1),
                ("mixed", 554039072, 1), ("decode", 320125824, 14),
                ("decode", 297634976, 1)]
RG_ORACLE_PREFILL_CYCLES = 284_106_752   # prefill_step(kv, [0, 1])
RG_ORACLE_DECODE_CYCLES = 320_125_824    # decode_step(kv, [0, 1, 2, 3])
RG_ORACLE_DECODE_HIT_RATE = 0.5

# Full-width qwen2-0.5b serving anchors (dense_path (a)): the JAX
# reference's ServeEngine on the CPU as for recurrentgemma-9b above (stub
# model calls, eos_id=-1), cache_len 2080, 8 requests of 2048 and 1200
# tokens, 32 new tokens, 4 slots.  The model's bf16 weight stream of
# 988,008,448 bytes does not fit below the paged-KV region either, so
# the oracle models the same 256 MiB resident subset; oracle costs for
# 4 requests of (2048, 32) in PagedKVCache(num_blocks=520, block_size=16,
# token_bytes=12288).
QWEN_WEIGHT_BYTES = 268_435_456
QWEN_STATS = {
    "requests": 8, "tokens": 256, "steps": 65, "prefill_steps": 4,
    "decode_steps": 64, "idle_steps": 0, "sim_time_s": 6.27285344,
    "tokens_per_s": 40.81077335038135, "latency_p50_s": 3.21499552,
    "latency_p99_s": 6.27235344, "mean_occupancy": 3.9384615384615387,
    "max_occupancy": 4}
# with full context every decode step reads one more token of each
# slot's KV: 42,144 more cycles a step through each run of 30 decodes
QWEN_STEP_RUNS = [("prefill", 251740160, 1), ("mixed", 528777256, 1)] \
    + [("decode", 298656968 + 42144 * i, 1) for i in range(30)] \
    + [("mixed", 529746568, 1), ("mixed", 528777256, 1)] \
    + [("decode", 298656968 + 42144 * i, 1) for i in range(30)] \
    + [("decode", 278006408, 1)]
QWEN_ORACLE_PREFILL_CYCLES = 273_317_888    # prefill_step(kv, [0, 1])
QWEN_ORACLE_DECODE_CYCLES = 316_473_344     # decode_step(kv, [0, 1, 2, 3])
QWEN_ORACLE_DECODE_HIT_RATE = 0.5
# first-token logits through the SWA kernel vs the plain version in fp32
# prefills of the dense archs: the reference's one-step decode-parity
# tolerance (tests/test_decode_parity.py, rtol = atol = 2e-2)
DENSE_LOGITS_TOL = dict(rtol=2e-2, atol=2e-2)
# dense_path (b) and moe_path (b): one prompt of 2048 tokens (numpy
# default_rng(1)), 8 greedy decode steps
GRANITE_PROMPT, GRANITE_DECODE = 2048, 8

# Serving mixtral-8x7b at full width cut to 8 of 32 layers (moe_path
# (a)): the JAX reference's ServeEngine on the CPU as for qwen2-0.5b
# (stub model calls, eos_id=-1) with get_config("mixtral-8x7b") and
# num_layers=8, cache_len 5136, 8 requests of 5120 and 4200 tokens, 16
# new tokens, 4 slots.  Its 6.8 GB bf16 weight stream exceeds the
# paged-KV region (the same 256 MiB subset), and at 32 KiB of KV a token
# the engine's default pool (4 slots x 5136 tokens, 673 MB) would run
# into the state region at 0x3800_0000, so both engines get the largest
# pool below it, 768 blocks of 16 tokens (384 MiB): it holds one
# 5120-token and one 4200-token request at a time (max occupancy 2).
# Oracle costs for admits of (5120, 16) and (4200, 16) in that pool:
# prefill_step(kv, [0, 1]), decode_step(kv, [0, 1]).
MIXTRAL_LAYERS = 8
MIXTRAL_WEIGHT_BYTES = 268_435_456
MIXTRAL_KV_BLOCKS = 768
MIXTRAL_STATS = {
    "requests": 8, "tokens": 128, "steps": 65, "prefill_steps": 8,
    "decode_steps": 64, "idle_steps": 0, "sim_time_s": 9.82151872,
    "tokens_per_s": 13.032607649502092, "latency_p50_s": 5.0273387199999995,
    "latency_p99_s": 9.82081872, "mean_occupancy": 1.9692307692307693,
    "max_occupancy": 2}
MIXTRAL_STEP_RUNS = [("prefill", 374013952, 1)] + [
    ("mixed", 693409280, 1), ("decode", 460324864, 14),
    ("mixed", 719257600, 1)] * 3 + [
    ("mixed", 693409280, 1), ("decode", 460324864, 14),
    ("decode", 345243648, 1)]
MIXTRAL_ORACLE = (492_017_152, 460_324_864, 0.5)
# moe_path (b): grok-1-314b at full width, 2 of its 64 layers; then one
# decode step from its greedy run's caches split-K over 4 and 8
# sequence shards (cache_seq -> model on a (1, n) port mesh), held to
# the dense step: the same greedy token, a logit gap of at most
# SPLITK_GAP of max|logit| (bf16)
GROK_LAYERS = 2
GROK_SPLITK_SHARDS = (4, 8)
SPLITK_GAP = 1e-2
# vlm_path: internvl2-26b at full width, 24 of its 48 layers
VLM_LAYERS = 24

# Serving whisper-tiny at full width and depth (encdec_path): the JAX
# reference's ServeEngine on the CPU as above (stub model calls, each
# request's frames as extras, eos_id=-1), cache_len 256, 8 requests of
# 224 and 120 decoder tokens, 32 new tokens, 4 slots, the default oracle
# (its 112.7 MB weight stream fits below the paged-KV region); oracle
# costs for 4 requests of (224, 32) in PagedKVCache(num_blocks=64,
# block_size=16, token_bytes=6144).
WHISPER_STATS = {
    "requests": 8, "tokens": 256, "steps": 65, "prefill_steps": 4,
    "decode_steps": 64, "idle_steps": 0, "sim_time_s": 2.74508416,
    "tokens_per_s": 93.2576143676411, "latency_p50_s": 1.40301171,
    "latency_p99_s": 2.74458416, "mean_occupancy": 3.9384615384615387,
    "max_occupancy": 4}
# the dense self KV grows a token a step: 21,072 more cycles a step
WHISPER_STEP_RUNS = [("prefill", 97822816, 1), ("mixed", 204817220, 1)] \
    + [("decode", 131901508 + 21072 * i, 1) for i in range(30)] \
    + [("mixed", 221105876, 1), ("mixed", 204817220, 1)] \
    + [("decode", 131901508 + 21072 * i, 1) for i in range(30)] \
    + [("decode", 123283060, 1)]
WHISPER_ORACLE = (99_002_848, 132_970_912, 0.5)

# Full-width mamba2-130m serving anchors: the JAX reference's
# ServeEngine on the same traffic (CPU), EngineStats.to_record() and the
# step log as runs of (kind, cycles, steps); oracle costs for 4 requests
# of (512, 32) in PagedKVCache(num_blocks=140, block_size=16,
# token_bytes=1).
SERVE_STATS = {
    "requests": 8, "tokens": 256, "steps": 65, "prefill_steps": 4,
    "decode_steps": 64, "idle_steps": 0, "sim_time_s": 5.9693022175,
    "tokens_per_s": 42.88608461630465, "latency_p50_s": 3.05363894,
    "latency_p99_s": 5.9688022175, "mean_occupancy": 3.9384615384615387,
    "max_occupancy": 4}
SERVE_STEP_RUNS = [("prefill", 221081060, 1), ("mixed", 458566932, 1),
                   ("decode", 286698068, 30), ("mixed", 491374576, 1),
                   ("mixed", 458566932, 1), ("decode", 286698068, 30),
                   ("decode", 270293516, 1)]
ORACLE_PREFILL_CYCLES = 221_082_288     # prefill_step(kv, [0, 1])
ORACLE_DECODE_CYCLES = 286_698_068      # decode_step(kv, [0, 1, 2, 3])
ORACLE_DECODE_HIT_RATE = 0.5

# Simulator path anchors (sim_path): the JAX reference on the CPU, with
# repro.core.sweep / socsim on the same inputs —
#   SIM_FIG5_RECORD  sweep_llc(window_bursts=None).to_record()
#   SIM_FIG6_RECORD  sweep_interference().to_record()
#   SIM_LANES_SHA256 sha256 of json.dumps([r.to_record() for r in
#       interference_lane_metrics_batch(window, llcs=[SIM_LLC] * 24,
#       drams=[DRAMConfig()] * 24, mixes=..., way_masks=...)],
#       sort_keys=True) over SIM_LANES in order, window =
#       default_dbb_window(max_bursts=4096) * 2
#   SIM_LATENCIES    lane_request_latencies(window, llc=SIM_LLC,
#       dram=DRAMConfig(), mix=MixConfig(2, "llc"), way_mask=0x0F):
#       victim chunks, their sum and the sha256 of json.dumps(list)
#   SIM_STREAM       simulate_dbb_stream(expand(default_dbb_window(
#       max_bursts=4096)), llc=LLCConfig(), dram=DRAMConfig(),
#       host_stalls=SIM_STALLS): sha256 of the latencies' list, total,
#       host_cycles; simulate_dbb_segments' total on the compressed window
# SIM_LLC is 256 KiB, 8 ways, 64 B: the doubled 4096-burst window reuses
# 128 KiB, which the victim's 4-way half holds while >= 256 KiB of
# co-runner lines between the two copies evict it unpartitioned (at the
# default 2 MiB, or 64 KiB, no mask changes any lane).
SIM_FIG5_RECORD = {
    "kind": "llc", "window_bursts": 6155982, "no_llc_s": 0.0934517554498488,
    "sim_hit_rates": [
        [0.5, 32, 0.0], [2, 32, 0.0], [8, 32, 0.0], [64, 32, 0.0],
        [512, 32, 0.041836054751297196], [1024, 32, 0.16306902781717036],
        [4096, 32, 0.481063947230515], [0.5, 64, 0.4999834307507722],
        [2, 64, 0.4999834307507722], [8, 64, 0.4999834307507722],
        [64, 64, 0.4999834307507722], [512, 64, 0.5208986965848827],
        [1024, 64, 0.5815242799605327], [4096, 64, 0.740529943070009],
        [0.5, 128, 0.7499831870853424], [2, 128, 0.7499831870853424],
        [8, 128, 0.7499831870853424], [64, 128, 0.7499831870853424],
        [512, 128, 0.7604393580098188], [1024, 128, 0.7907570230062401],
        [4096, 128, 0.870264240538715],
    ],
    "speedups": [
        [0.5, 32, 1.00002699412898], [2, 32, 1.0001079852608248],
        [8, 32, 1.0004391289112313], [64, 32, 1.004217238002297],
        [512, 32, 1.0390503543445695], [1024, 32, 1.0610833277481284],
        [4096, 32, 1.0827722224951344], [0.5, 64, 1.1964833832675663],
        [2, 64, 1.2602104511481946], [8, 64, 1.2834159234713975],
        [64, 64, 1.2940321554748335], [512, 64, 1.3236107824875993],
        [1024, 64, 1.3414224820146357], [4096, 64, 1.3586754824630043],
        [0.5, 128, 1.2399826582634006], [2, 128, 1.3990507177345188],
        [8, 128, 1.4784663046819253], [64, 128, 1.5100228870339019],
        [512, 128, 1.5333458187887368], [1024, 128, 1.545467289098712],
        [4096, 128, 1.5570221359749303],
    ],
}
SIM_FIG6_RECORD = {
    "kind": "interference", "window_bursts": 4096,
    "sim_hit_rates": [
        ["l1", 0, 0.5], ["l1", 1, 0.5], ["l1", 2, 0.5], ["l1", 3, 0.5],
        ["l1", 4, 0.5], ["llc", 0, 0.5], ["llc", 1, 0.5], ["llc", 2, 0.5],
        ["llc", 3, 0.5], ["llc", 4, 0.5], ["dram", 0, 0.5], ["dram", 1, 0.5],
        ["dram", 2, 0.5], ["dram", 3, 0.5], ["dram", 4, 0.5],
    ],
    "slowdowns": [
        ["l1", 0, 1.0], ["l1", 1, 1.0], ["l1", 2, 1.0], ["l1", 3, 1.0],
        ["l1", 4, 1.0], ["llc", 0, 1.0], ["llc", 1, 1.2681895702912687],
        ["llc", 2, 1.5363791405825373], ["llc", 3, 1.8045687108738058],
        ["llc", 4, 2.072758281165074], ["dram", 0, 1.0],
        ["dram", 1, 1.3300114536967595], ["dram", 2, 1.6809722603072477],
        ["dram", 3, 2.0528824198314646], ["dram", 4, 2.445741932269411],
    ],
    "sim_row_hit_rates": [
        ["l1", 0, 0.96875], ["l1", 1, 0.96875], ["l1", 2, 0.96875],
        ["l1", 3, 0.96875], ["l1", 4, 0.96875], ["llc", 0, 0.96875],
        ["llc", 1, 0.96435546875], ["llc", 2, 0.9599609375],
        ["llc", 3, 0.95556640625], ["llc", 4, 0.951171875],
        ["dram", 0, 0.96875], ["dram", 1, 0.96435546875],
        ["dram", 2, 0.9599609375], ["dram", 3, 0.95556640625],
        ["dram", 4, 0.951171875],
    ],
}
SIM_LLC_BYTES = 256 * 1024
SIM_LANES = [(wss, n, mask) for wss in ("llc", "dram") for n in (1, 2, 4)
             for mask in (None, 0x0F, 0x03, 0xFF)]
SIM_LANES_SHA256 = \
    "eca53b59ceff9225688c9d42a56aa9809478c3811b1775cb4952c71fcfe42292"
SIM_LATENCIES = {
    "n": 512, "sum": 194808, "total": 766424,
    "sha256": ("aa1e540e8e9aa5ee8d8642f72e23318d"
               "18407e685efeda32d24da342439ef50b")}
SIM_STREAM = {
    "t": 4096, "total": 112384, "host_cycles": 7552,
    "sha256": ("0fe674bb960265a15d5109b0a7d3e56c"
               "e5cae85bcb68c1b8b12a957c332d0fd8")}
SIM_STALL_SEED, SIM_STALL_P = 17, 0.35   # (3 T, 2) schedule, numpy PCG64

# Campaign path anchors (campaign_path): the JAX reference on the CPU —
#   CAMPAIGN_ACCEPTANCE_SHA256  sha256 of the manifest.json bytes that
#       repro.campaign.run_campaign writes for benchmarks/campaign_bench.py
#       :_acceptance_spec(64, 16384) (acceptance_spec below is its copy)
#   CAMPAIGN_MIXED_SHA256       the same for repro.campaign.spec.
#       mixed_backend_spec(16, window_bursts=16384)
#   NPU_MODEL_SECONDS  repro.core.npu.npu_time_s(workload(name),
#       mode="model")["seconds"]
#   NPU_SIM            mode="simulated": (seconds, sha256_json of
#       [list(p["hit_rates"]) for p in per_layer], segments of
#       workload_op_segments(workload(name)))
#   NPU_ORACLE_*       SoCLatencyOracle(decode_working_set(get_config(
#       "mamba2-130m")), backend="npu") over the ORACLE_* requests
CAMPAIGN_ACCEPTANCE_SHA256 = \
    "f45a3ff85dec714ce2eb78557bd6723a09d710920e9495fe3a649630f3a45936"
CAMPAIGN_MIXED_SHA256 = \
    "e1a5dd31dfae93d04c7711bebff60cbdadcf439a0f4c675dc02d8256fa27a38f"
NPU_MODEL_SECONDS = {
    "mamba2_decode": 0.03343465677393762,
    "transformer_decode": 0.1824968530420287,
    "whisper_encoder": 0.2526680433778488,
    "yolov3": 0.7901767061679608}
NPU_SIM = {
    "yolov3": (0.662880579032258, "a44ba70f3db656e4d441465cf687da7f"
               "3a2b0a83409daaa1048b0d5e9e1f871b", 13576),
    "mamba2_decode": (0.033383433064516126, "098c98e20d565cbee86cd7f0c225f9da"
                      "25e26ac01bd0ec7f85962aa65ec512a2", 12432)}
NPU_ORACLE_PREFILL_CYCLES = 221_082_828   # prefill_step(kv, [0, 1])
NPU_ORACLE_DECODE_CYCLES = 286_698_608    # decode_step(kv, [0, 1, 2, 3])
NPU_ORACLE_DECODE_HIT_RATE = 0.5
# (b)'s fault plan over mixed_backend_spec(16)'s spec order (points 0-7
# NVDLA, 8-15 NPU, ways 1 << i): the corrupt point's ways-1 sibling runs
# just before it, so the monotone-ways guardrail catches the deflation
CAMPAIGN_FAULTS = ((1, "corrupt"), (3, "hang"), (6, "torn"),
                   (10, "crash"), (12, "nan"))
# a point's attempt takes well under a second on the card; the hang
# outlasts the timeout by as much again
CAMPAIGN_TIMEOUT_S, CAMPAIGN_HANG_S = 5.0, 10.0

# Farm path anchors (farm_path): the JAX reference's
# benchmarks/fig6_tail.py run(smoke=False) on the CPU (BENCH_NOC_JSON
# pointed into a scratch copy), its per-node summaries of the steady
# victim pass — latency_summary(res.steady()) plus noc_mean, mem_mean
# and the switch's host_steps — unpartitioned (None) and with the
# victim in ways 0x0F, at 2048 bursts over 256 KiB / 8 ways / 64 B
FARM_LLC_BYTES, FARM_BURSTS, FARM_MASK = 256 * 1024, 2048, 0x0F
FARM_NODES = (0, 1, 2, 4)
FARM_PARITY_NODES, FARM_PARITY_BURSTS = (0, 4), 1024
FARM_ANCHORS = {
    None: {
        0: dict(p50=324.0, p99=324.0, wcet=324.0, mean=324.0, n=128,
                noc_mean=4.0, mem_mean=379.5, host_steps=9),
        1: dict(p50=324.0, p99=324.0, wcet=324.0, mean=324.0, n=128,
                noc_mean=4.0, mem_mean=379.9375, host_steps=13),
        2: dict(p50=635.0, p99=712.0, wcet=713.0, mean=636.46875, n=128,
                noc_mean=131.5, mem_mean=440.96875, host_steps=21),
        4: dict(p50=1019.0, p99=1208.0, wcet=1211.0, mean=1021.21875, n=128,
                noc_mean=386.5, mem_mean=442.71875, host_steps=37)},
    FARM_MASK: {
        0: dict(p50=324.0, p99=324.0, wcet=324.0, mean=324.0, n=128,
                noc_mean=4.0, mem_mean=379.5, host_steps=9),
        1: dict(p50=324.0, p99=324.0, wcet=324.0, mean=324.0, n=128,
                noc_mean=4.0, mem_mean=379.9375, host_steps=13),
        2: dict(p50=515.0, p99=578.0, wcet=579.0, mean=515.5, n=128,
                noc_mean=131.5, mem_mean=380.484375, host_steps=21),
        4: dict(p50=897.0, p99=1086.0, wcet=1089.0, mean=898.5, n=128,
                noc_mean=386.5, mem_mean=381.359375, host_steps=37)},
}


_T0 = time.perf_counter()   # the run's start, for phase()'s clock


def phase(name: str) -> None:
    """Print a phase's heading with the seconds since the run began."""
    print(f"\n== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() \
        else 0.0


def check_close(got, want, what: str) -> float:
    """fp32: rtol = atol = 1e-5; bf16: at most one bf16 ulp."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    if got.dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30)))
                         - 7)
        if not bool(((g - w).abs() <= ulp).all()):
            raise AssertionError(f"{what}: bf16 outputs differ by more "
                                 "than one ulp")
    else:
        torch.testing.assert_close(got, want, msg=what, **TOL)
    return max_err(got, want)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls,
    bracketed by CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rand_int8(shape, gen, dev):
    return torch.randint(-127, 128, shape, generator=gen, device=dev,
                         dtype=torch.int8)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------
def setup() -> str:
    phase("setup")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
          f"  count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    reports = _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(reports)) or 'cached'})")
    for name, log in sorted(reports.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    return smi


def check_kernels(dev) -> dict:
    """Every kernel against its plain version on the card, at
    test_kernels.py's shapes and the main path's, both output dtypes,
    every activation and pool."""
    from repro_torch.kernels.convcore import matmul_int8
    from repro_torch.kernels.convcore.ref import matmul_int8_ref
    from repro_torch.kernels.postproc import kernel as pp_kernel
    from repro_torch.kernels.postproc import postprocess
    from repro_torch.kernels.postproc.ref import postprocess_ref

    phase("kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"convcore": 0.0, "postproc": 0.0}
    for m, k, n in MATMUL_SHAPES:
        a, b = rand_int8((m, k), gen, dev), rand_int8((k, n), gen, dev)
        scale = torch.rand(n, generator=gen, device=dev) * 1e-2 + 1e-4
        bias = torch.randn(n, generator=gen, device=dev)
        worst = 0.0
        for out_dtype in DTYPES:
            for relu in (False, True):
                got = matmul_int8(a, b, scale, bias, relu=relu,
                                  out_dtype=out_dtype)
                want = matmul_int8_ref(a, b, scale, bias, relu=relu,
                                       out_dtype=out_dtype)
                err = check_close(got, want, f"matmul {m}x{k}x{n}")
                if out_dtype == torch.float32:
                    worst = max(worst, err)
        ones, zeros = torch.ones(n, device=dev), torch.zeros(n, device=dev)
        exact = matmul_int8(a, b, ones, zeros, out_dtype=torch.float32)
        if not torch.equal(exact, (a.double() @ b.double()).float()):
            raise AssertionError(f"matmul {m}x{k}x{n}: int accumulation "
                                 "not exact")
        errs["convcore"] = max(errs["convcore"], worst)
        print(f"  convcore {m}x{k}x{n}: fp32 max err {worst:.2e}, bf16 "
              "within 1 ulp, int accumulation exact")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape in POSTPROC_SHAPES:
        c = shape[-1]
        worst = 0.0
        paths = set()
        for in_dtype in DTYPES:
            x = torch.randn(shape, generator=gen, device=dev).to(in_dtype)
            scale = torch.rand(c, generator=gen, device=dev) * 4 - 2
            bias = torch.randn(c, generator=gen, device=dev)
            for pool in POSTPROC_POOLS:
                args = (*shape, pool, x.element_size())
                plan = pp_kernel.launch_plan(*args, sms)
                if pp_kernel.built_plan(*args, sms) != plan:
                    raise AssertionError(f"postproc {args}: the kernel's plan "
                                         f"{pp_kernel.built_plan(*args, sms)}"
                                         f" is not launch_plan's {plan}")
                paths.add("direct" if not plan.bulk else
                          "ring, vector" if plan.vec > 1 else "ring, scalar")
            for act in ACTS:
                for pool in POSTPROC_POOLS:
                    for out_dtype in DTYPES:
                        kw = dict(act=act, pool=pool, out_dtype=out_dtype)
                        got = postprocess(x, scale, bias, **kw)
                        want = postprocess_ref(x, scale, bias, **kw)
                        err = check_close(got, want,
                                          f"postproc {shape} {kw}")
                        if out_dtype == torch.float32:
                            worst = max(worst, err)
        errs["postproc"] = max(errs["postproc"], worst)
        print(f"  postproc {shape}: fp32 max err {worst:.2e}, bf16 within "
              f"1 ulp (4 acts x {len(POSTPROC_POOLS)} pools x 2 in x 2 out "
              f"dtypes; {', '.join(sorted(paths))})")
    torch.cuda.synchronize()
    return errs


def ssd_inputs(bb, l, h, p, n, gen, dev, groups: int = 0):
    """Seeded SSD operands: x, post-softplus dt, negative A, B, C; B/C
    of shape (bb, l, groups, n) when ``groups``."""
    x = torch.randn((bb, l, h, p), generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((bb, l, h), generator=gen, device=dev))
    A = -torch.exp(torch.randn((h,), generator=gen, device=dev) * 0.5)
    bc = (bb, l, groups, n) if groups else (bb, l, n)
    B = torch.randn(bc, generator=gen, device=dev)
    C = torch.randn(bc, generator=gen, device=dev)
    return x, dt, A, B, C


def check_ssd(dev) -> float:
    """The SSD kernel against its plain version on the card: y_intra and
    states within rtol = atol = 1e-4, with one SSM group and, at
    mamba2-130m's widths, with ``SSD_GROUPS`` groups (one launch per
    group, each group's heads held on their own)."""
    from repro_torch.kernels.ssd import kernel as K
    from repro_torch.kernels.ssd import ops

    phase("ssd against its plain version")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for bb, l, chunk, h, p, n in SSD_SHAPES:
        args = ssd_inputs(bb, l, h, p, n, gen, dev)
        y, states, cum = ops.ssd_intra_chunk(*args, chunk=chunk)
        want_y, want_states, want_cum = ops.ssd_intra_chunk_plain(
            *args, chunk=chunk)
        torch.cuda.synchronize()
        torch.testing.assert_close(cum, want_cum, rtol=0, atol=0)
        torch.testing.assert_close(y, want_y, **SSD_TOL)
        torch.testing.assert_close(states, want_states, **SSD_TOL)
        ey, es = max_err(y, want_y), max_err(states, want_states)
        worst = max(worst, ey, es)
        print(f"  ssd bb {bb} l {l} q {cum.shape[2]} h {h} p {p} n {n}: "
              f"max abs err y {ey:.2e}, states {es:.2e} (|y| up to "
              f"{float(want_y.abs().max()):.1f})")
    bb, l, chunk, h, p, n = SSD_SHAPES[3]
    for g in SSD_GROUPS:
        args = ssd_inputs(bb, l, h, p, n, gen, dev, groups=g)
        before = K.launches
        y, states, cum = ops.ssd_intra_chunk(*args, chunk=chunk)
        launched = K.launches - before
        want_y, want_states, want_cum = ops.ssd_intra_chunk_plain(
            *args, chunk=chunk)
        torch.cuda.synchronize()
        if launched != g:
            raise AssertionError(f"grouped ssd launched {launched} times "
                                 f"for {g} groups")
        torch.testing.assert_close(cum, want_cum, rtol=0, atol=0)
        hg = h // g
        errs = []
        for gi in range(g):
            heads = slice(gi * hg, (gi + 1) * hg)
            torch.testing.assert_close(y[:, :, :, heads],
                                       want_y[:, :, :, heads], **SSD_TOL)
            torch.testing.assert_close(states[:, :, heads],
                                       want_states[:, :, heads], **SSD_TOL)
            errs.append(max(max_err(y[:, :, :, heads],
                                    want_y[:, :, :, heads]),
                            max_err(states[:, :, heads],
                                    want_states[:, :, heads])))
        worst = max(worst, *errs)
        print(f"  ssd bb {bb} l {l} q {cum.shape[2]} h {h} p {p} n {n}, "
              f"{g} groups of {hg} heads ({launched} launches): max abs err "
              f"by group {', '.join(f'{e:.2e}' for e in errs)}")
    return worst


def frame_layers():
    from repro_torch.core.yolov3 import LAYERS

    return [l for l in LAYERS if l.kind == "conv"]


def frame_inputs(l, gen, dev):
    """Seeded int8 input and weights of one conv layer at its own
    shape, with a per-channel scale and bias."""
    x = rand_int8((1, l.h, l.w, l.cin), gen, dev)
    w = rand_int8((l.ksize, l.ksize, l.cin, l.cout), gen, dev)
    scale = torch.rand(l.cout, generator=gen, device=dev) * 1e-3 + 1e-5
    bias = torch.randn(l.cout, generator=gen, device=dev)
    return x, w, scale, bias


def main_path(dev) -> tuple[dict, dict, dict]:
    """The port's main path, with every launch counter at 0 before it:
    the case study at 416 x 416, then a frame's 75 convs, each held
    against the plain direct convolution."""
    from repro_torch import case_study
    from repro_torch.kernels.convcore import conv2d_int8
    from repro_torch.kernels.convcore import kernel as cc_kernel
    from repro_torch.kernels.convcore.ref import conv2d_int8_ref
    from repro_torch.kernels.postproc import kernel as pp_kernel
    from repro_torch.kernels.postproc.ref import postprocess_ref

    phase("main path: python -m repro_torch --size 416, then a frame's "
          "75 convs")
    cc_kernel.launches = 0
    pp_kernel.launches = 0
    t0 = time.perf_counter()
    res = case_study.run(device=dev, size=416, seed=0)
    torch.cuda.synchronize()
    print(f"case study wall time {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {"convcore": 0.0, "postproc": 0.0}
    layers = frame_layers()
    for l in layers:
        x, w, scale, bias = frame_inputs(l, gen, dev)
        kw = dict(stride=l.stride, padding=l.ksize // 2, relu=True,
                  out_dtype=torch.float32)
        out = conv2d_int8(x, w, scale, bias, **kw)
        if tuple(out.shape) != (1, l.out_h, l.out_w, l.cout):
            raise AssertionError(f"layer {l.index}: shape {out.shape}")
        err = check_close(out, conv2d_int8_ref(x, w, scale, bias, **kw),
                          f"layer {l.index}")
        errs["convcore"] = max(errs["convcore"], err)
    torch.cuda.synchronize()
    launches = {"convcore": cc_kernel.launches,
                "postproc": pp_kernel.launches}
    print(f"{len(layers)} conv layers held against the plain conv: fp32 "
          f"max err {errs['convcore']:.2e}")
    print(f"launches on the main path: {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")

    stage = res["stage"]
    shapes = [tuple(out.shape) for _, out, _ in stage["convs"]]
    if shapes != [(1, 416, 416, 32), (1, 208, 208, 64)] or \
            tuple(stage["pooled"].shape) != (1, 104, 104, 64):
        raise AssertionError(f"numeric stage shapes {shapes}, "
                             f"{tuple(stage['pooled'].shape)}")
    for _, out, ref in stage["convs"]:
        err = check_close(out, ref, "numeric stage conv")
        errs["convcore"] = max(errs["convcore"], err)
    c = out.shape[-1]
    pooled_ref = postprocess_ref(out, torch.ones(c, device=dev),
                                 torch.zeros(c, device=dev), act="none",
                                 pool=2)
    check_close(stage["pooled"], pooled_ref, "numeric stage max-pool")
    errs["postproc"] = max_err(stage["pooled"], pooled_ref)
    if not bool(torch.isfinite(stage["pooled"]).all()):
        raise AssertionError("pooled map is not finite")
    return res, launches, errs


def paper_chain(res: dict, dev) -> dict:
    """Model-mode anchors exactly; simulated mode on the card bit for
    bit against the port's CPU run."""
    from repro_torch.core.soc import llc_sweep, run_yolov3

    phase("paper chain")
    t = res["platform"]
    m = t["_meta"]
    got = (round(m["nvdla_accel_ms"], 3), round(m["nvdla_cpu_ms"], 3),
           round(t["nvdla (int8)"], 3), round(m["speedup_vs_rocket"], 2),
           round(res["llc"]["grid"][(4096, 128)], 4),
           tuple(round(res["llc"]["grid"][(1024, b)], 4)
                 for b in (32, 64, 128)),
           round(res["interference"]["llc"][4], 4),
           round(res["interference"]["dram"][4], 4))
    want = (69.134, 66.115, 7.394, 406.47, 1.5570,
            (1.0611, 1.3414, 1.5455), 2.0728, 2.4457)
    if got != want:
        raise AssertionError(f"model-mode anchors {got} != {want}")
    print(f"model-mode anchors equal: {want}")

    times = {}
    t0 = time.perf_counter()
    sim_gpu = run_yolov3(mode="simulated", device=dev)
    times["frame_cuda_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sweep_gpu = llc_sweep(mode="simulated", device=dev, **FIG5)
    times["fig5_cuda_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim_cpu = run_yolov3(mode="simulated", device="cpu")
    times["frame_cpu_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sweep_cpu = llc_sweep(mode="simulated", device="cpu", **FIG5)
    times["fig5_cpu_s"] = time.perf_counter() - t0
    if sim_gpu.accel_s != sim_cpu.accel_s or \
            res["simulated"].accel_s != sim_cpu.accel_s or \
            sim_cpu.accel_s * 1e3 != 65.13808718588858:
        raise AssertionError(f"simulated frame: cuda {sim_gpu.accel_s!r}, "
                             f"cpu {sim_cpu.accel_s!r}")
    if sweep_gpu != sweep_cpu or res["simulated_llc"] != sweep_cpu:
        raise AssertionError("simulated Fig. 5 grid differs between cuda "
                             "and cpu")
    print(f"simulated frame {sim_gpu.accel_s * 1e3!r} ms accel and the "
          "12-point simulated Fig. 5 grid: cuda == cpu, bit for bit")
    print("segment-lane engine wall time: " + ", ".join(
        f"{k} {v:.2f}" for k, v in times.items()))
    return times


def sha256_json(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()
                          ).hexdigest()


def sim_stalls(t: int):
    """The seeded random host-stall schedule of (e): (3 T, 2) bool."""
    rng = np.random.default_rng(SIM_STALL_SEED)
    return rng.random((3 * t, 2)) < SIM_STALL_P


def sim_path(dev) -> dict:
    """The paper's simulator on the card at its own sizes, every result
    held bit for bit to the JAX reference's (anchors above):
    (a) Fig. 5 over the whole frame, (b) Fig. 6 at 4096 bursts, (c) 24
    way-partitioned and unpartitioned interference lanes batched and
    one by one, (d) one partitioned lane's per-chunk latencies, (e) the
    FAME-1 LLC -> DRAM pipeline under random host stalls."""
    from repro_torch.core import traces
    from repro_torch.core.cache import LLCConfig
    from repro_torch.core.dram import DRAMConfig
    from repro_torch.core.socsim import (simulate_dbb_segments,
                                         simulate_dbb_stream)
    from repro_torch.core.sweep import (
        MixConfig, interference_lane_metrics, interference_lane_metrics_batch,
        lane_request_latencies, sweep_interference, sweep_llc)

    phase("sim path (Fig. 5/6 sweeps, partitioned lanes, FAME-1 pipeline)")
    wall = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        print(f"{name}: {wall[name]:.3f} s wall on {dev}", flush=True)
        return out

    def same(got, want, what):
        if json.loads(json.dumps(got)) != want:
            raise AssertionError(f"{what}: {got!r} != the reference's")

    # (a) Fig. 5, 21 geometries over all 6,155,982 bursts
    grid = timed("sweep_llc_full_frame",
                 lambda: sweep_llc(window_bursts=None, device=dev))
    same(grid.to_record(), SIM_FIG5_RECORD, "sweep_llc(window_bursts=None)")
    # (b) Fig. 6 at 4096 bursts
    grid6 = timed("sweep_interference",
                  lambda: sweep_interference(device=dev))
    same(grid6.to_record(), SIM_FIG6_RECORD, "sweep_interference()")
    print("(a) Fig. 5 (21 geometries, 6,155,982 bursts) and (b) Fig. 6 "
          "(15 keys, 4096 bursts): to_record() == the reference's")

    # (c) partitioned and unpartitioned lanes, batched and sequential
    llc = LLCConfig(SIM_LLC_BYTES, 8, 64)
    dram = DRAMConfig()
    window = traces.default_dbb_window(max_bursts=4096) * 2
    mixes = [MixConfig(n, wss) for wss, n, _ in SIM_LANES]
    masks = [m for *_, m in SIM_LANES]
    batch = timed("interference_lane_metrics_batch_24", lambda:
                  interference_lane_metrics_batch(
                      window, llcs=[llc] * len(mixes),
                      drams=[dram] * len(mixes), mixes=mixes,
                      way_masks=masks, device=dev))
    recs = [m.to_record() for m in batch]
    if sha256_json(recs) != SIM_LANES_SHA256:
        raise AssertionError("batched lane records differ from the "
                             f"reference's: {recs!r}")
    seq = timed("interference_lane_metrics_x24", lambda: [
        interference_lane_metrics(window, llc=llc, dram=dram, mix=mix,
                                  way_mask=mask, device=dev)
        for mix, mask in zip(mixes, masks)])
    if [m.to_record() for m in seq] != recs:
        raise AssertionError("sequential lanes differ from the batch")
    moved = 0
    for i in range(0, len(recs), 4):
        plain, full = recs[i], recs[i + 3]
        if full != plain:
            raise AssertionError(f"full mask != unmasked: {SIM_LANES[i]}")
        moved += sum(recs[i + k]["nvdla_hits"] != plain["nvdla_hits"]
                     for k in (1, 2))
        print(f"  {SIM_LANES[i][0]} x{SIM_LANES[i][1]}: NVDLA hit rate "
              f"unmasked {plain['nvdla_hit_rate']}, 0x0F "
              f"{recs[i + 1]['nvdla_hit_rate']}, 0x03 "
              f"{recs[i + 2]['nvdla_hit_rate']}; total cycles "
              f"{plain['total_cycles']} / {recs[i + 1]['total_cycles']} / "
              f"{recs[i + 2]['total_cycles']}")
    if not moved:
        raise AssertionError("no partitioned lane differs from its "
                             "unmasked lane: the check proves nothing")
    print(f"(c) 24 lanes: batch == sequential == the reference's; full mask "
          f"== unmasked; {moved} of 12 partitioned lanes differ from "
          "their unmasked lane")

    # (d) one partitioned lane's per-chunk latencies
    lat, metrics = timed("lane_request_latencies", lambda:
                         lane_request_latencies(
                             window, llc=llc, dram=dram,
                             mix=MixConfig(2, "llc"), way_mask=0x0F,
                             device=dev))
    got = {"n": int(lat.shape[0]), "sum": int(lat.sum()),
           "total": metrics.total_cycles,
           "sha256": sha256_json(lat.tolist())}
    lane = recs[SIM_LANES.index(("llc", 2, 0x0F))]
    if got != SIM_LATENCIES or metrics.to_record() != lane:
        raise AssertionError(f"lane_request_latencies: {got} != "
                             f"{SIM_LATENCIES}")
    print(f"(d) {got['n']} victim-chunk latencies == the reference's "
          f"(sum {got['sum']} of the lane's {got['total']} cycles; the "
          "per-segment latencies sum to the total, checked inside)")

    # (e) the FAME-1 pipeline under a seeded random stall schedule
    segs = traces.default_dbb_window(max_bursts=4096)
    addrs = traces.expand(segs)
    res = timed("simulate_dbb_stream", lambda: simulate_dbb_stream(
        addrs, llc=LLCConfig(), dram=DRAMConfig(),
        host_stalls=sim_stalls(addrs.shape[0]), device=dev))
    seg_res = timed("simulate_dbb_segments", lambda: simulate_dbb_segments(
        segs, llc=LLCConfig(), dram=DRAMConfig(), device=dev))
    got = {"t": int(res.latencies.shape[0]),
           "total": int(res.total_cycles), "host_cycles": res.host_cycles,
           "sha256": sha256_json(res.latencies.tolist())}
    if got != SIM_STREAM or seg_res.total_cycles != SIM_STREAM["total"]:
        raise AssertionError(f"simulate_dbb_stream: {got}, segments "
                             f"{seg_res.total_cycles}; want {SIM_STREAM}")
    print(f"(e) {got['t']} accesses under {SIM_STALL_P} random stalls: "
          f"latencies == the reference's, total {got['total']} cycles == "
          f"simulate_dbb_segments', last_host_cycles {got['host_cycles']}")

    # device time of two of the calls, run again under the profiler; its
    # share is taken of the unprofiled wall above (the profiled wall
    # carries the profiler's own cost)
    busy = {}
    for name, fn in (
            ("interference_lane_metrics_batch_24", lambda:
             interference_lane_metrics_batch(
                 window, llcs=[llc] * len(mixes), drams=[dram] * len(mixes),
                 mixes=mixes, way_masks=masks, device=dev)),
            ("simulate_dbb_stream", lambda: simulate_dbb_stream(
                addrs, llc=LLCConfig(), dram=DRAMConfig(),
                host_stalls=sim_stalls(addrs.shape[0]), device=dev))):
        split = device_split(fn)
        dev_ms = sum(v for k, v in split.items() if k != "wall_ms")
        busy[name] = {"profiled_wall_ms": split["wall_ms"],
                      "device_ms": dev_ms}
        if dev_ms == 0.0:
            print(f"{name} (profiled): device time not measured (no "
                  "device events in the trace)")
            continue
        print(f"{name} (profiled): device busy {dev_ms:.2f} ms, "
              f"{dev_ms / (wall[name] * 1e3):.1%} of its "
              f"{wall[name]:.3f} s wall (profiled wall "
              f"{split['wall_ms'] / 1e3:.3f} s)")
    return {"wall_s": wall, "profiled": busy}

def acceptance_spec(points: int, window_bursts: int):
    """The campaign benchmark's acceptance spec (a copy of
    benchmarks/campaign_bench.py:_acceptance_spec): 16 sets, blocks
    128/256/512/1024 x ways 1..points/16, four co-runner mixes, one
    windowed YOLOv3 trace."""
    from repro_torch.campaign import (CampaignSpec, GeometrySpec, MixSpec,
                                      ModelSpec)

    n_geoms = points // 4
    sets, blocks = 16, (128, 256, 512, 1024)
    ways = range(1, n_geoms // len(blocks) + 1)
    geoms = tuple(GeometrySpec(size_kib=sets * w * b / 1024, block=b, ways=w)
                  for b in blocks for w in ways)
    mixes = (MixSpec(0, "l1"), MixSpec(1, "llc"), MixSpec(2, "llc"),
             MixSpec(2, "dram"))
    return CampaignSpec(name=f"bench-{points}pt",
                        models=(ModelSpec(window_bursts=window_bursts),),
                        geometries=geoms, mixes=mixes)


def sha256_file(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def campaign_path(dev) -> dict:
    """The campaign run farm and the NPU backend on the card, every
    result held to the JAX reference's (anchors above): (a) the
    acceptance campaign sequential, batched and over a mesh of the
    card(s), (b) the NVDLA + NPU campaign through a crash, a hang, a
    NaN, a torn write and a consistent corruption and the resumes after
    them, (c) the NPU timing model in both modes, (d) the mamba2-130m
    serving oracle with backend="npu", (e) the campaign CLI."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch.campaign import (FaultInjector, InjectedCrash,
                                      RetryPolicy, example_spec,
                                      mixed_backend_spec, plan_from_indices,
                                      run_campaign)
    from repro_torch.campaign import cli
    from repro_torch.configs import get_config
    from repro_torch.core import npu
    from repro_torch.launch.mesh import make_sweep_mesh
    from repro_torch.models import decode_working_set
    from repro_torch.serve import PagedKVCache, SoCLatencyOracle

    phase("campaign path (run farm, faults, NPU backend, NPU oracle, CLI)")
    wall: dict = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        print(f"{name}: {wall[name]:.3f} s wall on {dev}", flush=True)
        return out

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_campaign_"))
    try:
        # (a) 64 points, one 16,384-burst window: sequential, batched, mesh
        spec = acceptance_spec(64, 16384)
        spec.models[0].trace()          # memoized window, kept out of the
        rates, manifests = {}, {}       # timed runs
        mesh = make_sweep_mesh()
        for name, kw in (("sequential", dict(batch_points=1, device=dev)),
                         ("batched", dict(batch_points=64, device=dev)),
                         ("mesh", dict(batch_points=64, mesh=mesh))):
            notes: list = []
            res = timed(f"acceptance_{name}", lambda: run_campaign(
                spec, str(work / name), progress=notes.append, **kw))
            fell = [n for n in notes if "fell back to sequential" in n]
            if fell or res.completed != 64 or res.failed:
                raise AssertionError(f"acceptance {name}: "
                                     f"{res.manifest['counts']}, {fell}")
            manifests[name] = Path(res.manifest_path).read_bytes()
            rates[name] = 64 / wall[f"acceptance_{name}"]
        if len(set(manifests.values())) != 1:
            raise AssertionError("acceptance manifests differ between "
                                 "sequential, batched and mesh runs")
        got = hashlib.sha256(manifests["batched"]).hexdigest()
        if got != CAMPAIGN_ACCEPTANCE_SHA256:
            raise AssertionError(f"acceptance manifest sha256 {got} != "
                                 "the reference's")
        print(f"(a) 64 points x 16,384 bursts: manifests byte-identical "
              f"(sequential, batched, mesh of {len(mesh.devices)} card(s)) "
              f"and == the reference's; points/s sequential "
              f"{rates['sequential']:.2f}, batched {rates['batched']:.2f}, "
              f"mesh {rates['mesh']:.2f}; no batch fell back to sequential")

        # (b) NVDLA + 8x8 NPU through every fault kind, resumed to the end
        mixed = mixed_backend_spec(16, window_bursts=16384)
        points = mixed.expand()
        bad = CAMPAIGN_FAULTS[0][0]
        if (points[bad - 1].model != points[bad].model
                or points[bad - 1].geometry.ways >= points[bad].geometry.ways):
            raise AssertionError("the corrupt point has no lower-ways "
                                 "sibling before it")
        clean = timed("mixed_clean", lambda: run_campaign(
            mixed, str(work / "mixed_clean"), device=dev))
        if sha256_file(clean.manifest_path) != CAMPAIGN_MIXED_SHA256:
            raise AssertionError("mixed-backend manifest sha256 != the "
                                 "reference's")
        plan = plan_from_indices(mixed, [
            {"point": i, "kind": k, "hang_s": CAMPAIGN_HANG_S}
            for i, k in CAMPAIGN_FAULTS])
        policy = RetryPolicy(max_retries=2, timeout_s=CAMPAIGN_TIMEOUT_S,
                             backoff_s=0.01)
        out, notes, runs = work / "mixed_faulted", [], 0

        def until_done():
            nonlocal runs
            while True:
                runs += 1
                if runs > 8:
                    raise AssertionError("faulted campaign did not converge")
                try:
                    return run_campaign(
                        mixed, str(out), resume=runs > 1, policy=policy,
                        hooks=FaultInjector(plan, str(out)), device=dev,
                        progress=notes.append)
                except InjectedCrash:
                    continue
        res = timed("mixed_faulted", until_done)
        fired = (out / "faults_consumed.jsonl").read_text().splitlines()
        caught = {k: any(k in n for n in notes)
                  for k in ("monotone", "PointTimeout", "finite")}
        if (res.failed or runs != 3 or len(fired) != len(CAMPAIGN_FAULTS)
                or not all(caught.values())
                or Path(res.manifest_path).read_bytes()
                != Path(clean.manifest_path).read_bytes()):
            raise AssertionError(f"faulted campaign: runs {runs}, failed "
                                 f"{res.failed}, fired {fired}, caught "
                                 f"{caught}")
        print(f"(b) mixed_backend_spec(16, 16,384 bursts): {len(fired)} "
              f"faults ({', '.join(k for _, k in CAMPAIGN_FAULTS)}) fired "
              f"over {runs} processes, the guardrails caught {caught}; "
              "manifest byte-identical to the clean run's == the "
              "reference's")

        # (c) the NPU timing model
        for name in sorted(npu.WORKLOADS):
            got = npu.npu_time_s(npu.workload(name), mode="model",
                                 device=dev)["seconds"]
            if got != NPU_MODEL_SECONDS[name]:
                raise AssertionError(f"npu_time_s({name}, model) = {got!r}")
        for name, (want_s, want_sha, want_segs) in NPU_SIM.items():
            ops = npu.workload(name)
            segs = sum(len(s) for s in npu.workload_op_segments(ops))
            r = timed(f"npu_simulated_{name}", lambda: npu.npu_time_s(
                ops, mode="simulated", device=dev))
            got = (r["seconds"], sha256_json(
                [list(p["hit_rates"]) for p in r["per_layer"]]), segs)
            if got != (want_s, want_sha, want_segs):
                raise AssertionError(f"npu_time_s({name}, simulated): "
                                     f"{got} != {NPU_SIM[name]}")
            print(f"  {name}: {segs} segments, {r['seconds']!r} s, "
                  f"{r['compute_bound_layers']} compute-bound layers")
        split = device_split(lambda: npu.npu_time_s(
            npu.workload("mamba2_decode"), mode="simulated", device=dev))
        dev_ms = sum(v for k, v in split.items() if k != "wall_ms")
        busy = {"profiled_wall_ms": split["wall_ms"], "device_ms": dev_ms}
        share = (f"device busy {dev_ms:.2f} ms, "
                 f"{dev_ms / (wall['npu_simulated_mamba2_decode'] * 1e3):.1%}"
                 " of its unprofiled wall" if dev_ms else
                 "device time not measured (no device events in the trace)")
        print(f"(c) npu_time_s: 4 workloads in model mode and yolov3 / "
              f"mamba2_decode simulated == the reference's; mamba2_decode "
              f"simulated (profiled): {share}")

        # (d) the full-width mamba2-130m oracle on the NPU's weight stream
        oracle = SoCLatencyOracle(decode_working_set(get_config(
            "mamba2-130m")), backend="npu", device=dev)
        kv = PagedKVCache(num_blocks=140, block_size=16, token_bytes=1)
        for rid in range(4):
            kv.admit(rid, 512, 32)
        print("(d) ", end="")
        pre_s, dec_s = check_oracle(oracle, kv, (
            NPU_ORACLE_PREFILL_CYCLES, NPU_ORACLE_DECODE_CYCLES,
            NPU_ORACLE_DECODE_HIT_RATE))
        wall["npu_oracle_prefill"], wall["npu_oracle_decode"] = pre_s, dec_s

        # (e) the CLI in this process: an injected crash, the resume, show
        spec_path, faults_path = work / "cli_spec.json", work / "faults.json"
        example_spec(4, window_bursts=256).save(str(spec_path))
        faults_path.write_text(json.dumps([{"point": 1, "kind": "crash"}]))
        run = ["run", str(spec_path), "--out", str(work / "cli"),
               "--inject", str(faults_path)]
        shown = io.StringIO()
        with contextlib.redirect_stderr(io.StringIO()):
            rcs = (cli.main(run), cli.main(run + ["--resume"]))
            with contextlib.redirect_stdout(shown):
                rcs += (cli.main(["show", str(work / "cli")]),)
        want = "counts {'completed': 4, 'failed': 0, 'total': 4}"
        if rcs != (42, 0, 0) or want not in shown.getvalue():
            raise AssertionError(f"campaign CLI: exit codes {rcs}, show "
                                 f"{shown.getvalue()!r}")
        print(f"(e) python -m repro_torch.campaign: run --inject exits 42, "
              f"run --resume 0, show reads {want}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"wall_s": wall, "points_per_s": rates, "profiled": busy}


def serve_requests(vocab: int, lengths=(512, 300), max_new: int = 32
                   ) -> list:
    """The 8 requests of a serving phase: prompt lengths alternating
    ``lengths``, tokens drawn as examples/serve_lm.py draws them,
    ``max_new`` new tokens each, arrivals 100 µs apart."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(1)
    return [Request(rid=i, tokens=tuple(int(t) for t in rng.integers(
                3, vocab, lengths[i % 2])),
                    max_new=max_new, arrival_s=i * 100e-6) for i in range(8)]


def prefill_groups(eng, requests) -> list:
    """The prefill groups the engine ran: per admitting step, the
    admitted rids by prompt length."""
    by_rid = {r.rid: r for r in requests}
    groups = []
    for step in eng.step_log:
        lens = sorted({len(by_rid[r].tokens) for r in step.admitted})
        groups += [[r for r in step.admitted
                    if len(by_rid[r].tokens) == n] for n in lens]
    return groups


def check_engine(eng, stats, want_stats: dict, want_runs: list) -> None:
    """EngineStats and the step log's (kind, cycles) runs, exactly."""
    record = stats.to_record()
    if record != want_stats:
        raise AssertionError(f"EngineStats differ from the reference's: "
                             f"{record} != {want_stats}")
    runs = []
    for r in eng.step_log:
        if runs and runs[-1][:2] == (r.kind, r.cycles):
            runs[-1] = (r.kind, r.cycles, runs[-1][2] + 1)
        else:
            runs.append((r.kind, r.cycles, 1))
    if runs != want_runs:
        raise AssertionError(f"step kinds/cycles {runs} != the "
                             f"reference's {want_runs}")
    print(f"EngineStats and the {len(eng.step_log)} steps' kinds and "
          "cycles equal the JAX reference's, bit for bit")


def check_oracle(oracle, kv, want: tuple, decode_rids=(0, 1, 2, 3)
                 ) -> tuple:
    """One prefill_step (rids 0 and 1) and one decode_step (over
    ``decode_rids``) against the reference's (prefill cycles, decode
    cycles, decode hit rate); returns their host times (s)."""
    t0 = time.perf_counter()
    pre = oracle.prefill_step(kv, [0, 1])
    t1 = time.perf_counter()
    dec = oracle.decode_step(kv, list(decode_rids))
    t2 = time.perf_counter()
    if (pre.cycles, dec.cycles, dec.metrics.hit_rate) != want:
        raise AssertionError(f"oracle: prefill {pre.cycles}, decode "
                             f"{dec.cycles} (hit rate "
                             f"{dec.metrics.hit_rate}) != {want}")
    print(f"oracle anchors equal: prefill_step {pre.cycles} cycles "
          f"({t1 - t0:.2f} s), decode_step {dec.cycles} cycles, hit rate "
          f"{dec.metrics.hit_rate} ({t2 - t1:.2f} s)")
    return t1 - t0, t2 - t1


def serve_path(dev) -> tuple[dict, dict]:
    """The serving main path, with every launch counter at 0 before it:
    mamba2-130m at full width through ServeEngine, held to the JAX
    reference's anchors; then each prefill group's first-token logits
    through the kernel against the plain SSD step, and the kernel
    against its plain version on every layer's SSD operands of those
    prefills."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.convcore import kernel as cc_kernel
    from repro_torch.kernels.postproc import kernel as pp_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import (
        decode_working_set,
        init_caches,
        init_params,
        prefill,
        slot_decode_step,
    )
    from repro_torch.serve import PagedKVCache, ServeEngine, SoCLatencyOracle
    from repro_torch.types import param_values

    phase("serving path: mamba2-130m at full width through ServeEngine")
    cfg = get_config("mamba2-130m")
    params = param_values(init_params(
        torch.Generator(device=dev).manual_seed(0), cfg))
    eng = ServeEngine(cfg, params, cache_len=552, max_slots=4,
                      temperature=0.0, eos_id=-1, device=dev)
    requests = serve_requests(cfg.vocab_size)
    for req in requests:
        eng.submit(req)
    cc_kernel.launches = pp_kernel.launches = ssd_kernel.launches = 0
    t0 = time.perf_counter()
    stats = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"convcore": cc_kernel.launches,
                "postproc": pp_kernel.launches, "ssd": ssd_kernel.launches}
    print(f"EngineStats {json.dumps(stats.to_record())}")
    print(f"serve wall time {wall:.2f} s: model (prefill + decode) "
          f"{eng.wall_s['model']:.2f} s, oracle {eng.wall_s['oracle']:.2f}"
          f" s, {len(eng.oracle._memo)} distinct oracle traces")

    by_rid = {r.rid: r for r in requests}
    groups = prefill_groups(eng, requests)
    print(f"ssd launches on the serving path: {launches['ssd']} "
          f"({len(groups)} prefill groups x {cfg.num_layers} layers)")
    if launches["ssd"] != cfg.num_layers * len(groups):
        raise AssertionError(f"ssd launched {launches['ssd']} times, not "
                             f"{cfg.num_layers} per prefill group")
    check_engine(eng, stats, SERVE_STATS, SERVE_STEP_RUNS)

    oracle = SoCLatencyOracle(decode_working_set(cfg), device=dev)
    kv = PagedKVCache(num_blocks=140, block_size=16, token_bytes=1)
    for rid in range(4):
        kv.admit(rid, 512, 32)
    pre_s, dec_s = check_oracle(oracle, kv, (
        ORACLE_PREFILL_CYCLES, ORACLE_DECODE_CYCLES, ORACLE_DECODE_HIT_RATE))

    # each group's bf16 prefill through the kernel (its first tokens are
    # the engine's; the kernel against the plain version on every layer's
    # own operands), then the first-token logits through the kernel
    # against the plain SSD step, in bf16 (reported) and in fp32 (held to
    # LOGITS_TOL)
    first = {f["rid"]: f["tokens"][0] for f in eng.finished}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    worst = bf16_worst = ssd_worst = 0.0
    kernel_op = ssd_ops.ssd_intra_chunk

    def plain_prefill(batch, c):
        ssd_ops.ssd_intra_chunk = ssd_ops.ssd_intra_chunk_plain
        try:
            return prefill(params, batch, c, 552)[0]
        finally:
            ssd_ops.ssd_intra_chunk = kernel_op
    for rids in groups:
        batch = {"tokens": torch.as_tensor(
            [list(by_rid[r].tokens) for r in rids], device=dev)}
        operands = []

        def capture(*args, **kw):
            operands.append((args, kw))
            return kernel_op(*args, **kw)

        ssd_ops.ssd_intra_chunk = capture
        try:
            got, _, _ = prefill(params, batch, cfg, 552)
        finally:
            ssd_ops.ssd_intra_chunk = kernel_op
        # the kernel on this prefill's own operands, layer by layer
        for args, kw in operands:
            y, states, cum = kernel_op(*args, **kw)
            want_y, want_states, want_cum = ssd_ops.ssd_intra_chunk_plain(
                *args, **kw)
            torch.testing.assert_close(cum, want_cum, rtol=0, atol=0)
            torch.testing.assert_close(y, want_y, **SSD_TOL)
            torch.testing.assert_close(states, want_states, **SSD_TOL)
            ssd_worst = max(ssd_worst, max_err(y, want_y),
                            max_err(states, want_states))
        got_first = got[:, :cfg.vocab_size].argmax(dim=1).tolist()
        if got_first != [first[r] for r in rids]:
            raise AssertionError(f"group {rids}: first tokens "
                                 f"{got_first} differ from the engine's")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"group {rids}: logits not finite")
        bf16_worst = max(bf16_worst, max_err(
            got[:, :cfg.vocab_size],
            plain_prefill(batch, cfg)[:, :cfg.vocab_size]))
        got32, _, _ = prefill(params, batch, cfg32, 552)
        want32 = plain_prefill(batch, cfg32)
        torch.testing.assert_close(got32, want32, **LOGITS_TOL)
        worst = max(worst, max_err(got32[:, :cfg.vocab_size],
                                   want32[:, :cfg.vocab_size]))
    print(f"first-token logits of {len(groups)} prefill groups, kernel vs "
          f"plain SSD step: fp32 prefill max abs err {worst:.3e} (tolerance "
          f"{LOGITS_TOL}); bf16 prefill {bf16_worst:.3e}")
    print(f"ssd kernel vs plain on the {cfg.num_layers} layers' operands of "
          f"each of the {len(groups)} prefill groups: max abs err "
          f"{ssd_worst:.3e} (tolerance {SSD_TOL})")

    split = {"wall_s": wall, "model_s": eng.wall_s["model"],
             "oracle_s": eng.wall_s["oracle"],
             "oracle_prefill_s": pre_s, "oracle_decode_s": dec_s,
             "logits_fp32_max_abs_err": worst,
             "logits_bf16_max_abs_err": bf16_worst,
             "ssd_max_abs_err": ssd_worst}
    kinds = {"ssd": "ssd_"}
    caches = param_values(init_caches(cfg, 4, 552, device=dev))
    toks = torch.zeros((4, 1), dtype=torch.int64, device=dev)
    ts = torch.full((4,), 512, dtype=torch.int64, device=dev)
    one = {"tokens": torch.as_tensor([list(requests[0].tokens)],
                                     device=dev)}
    fresh = SoCLatencyOracle(decode_working_set(cfg), device=dev)
    # the first profiled call of a process pays the tracer's start-up
    # (~10 s on the card); keep it out of the measured splits
    device_split(lambda: torch.ones(1, device=dev).sum(), kinds)
    profiled = {
        "prefill_1x512": device_split(
            lambda: prefill(params, one, cfg, 552), kinds),
        "decode_step_4_slots": device_split(
            lambda: slot_decode_step(params, caches, toks, ts, cfg), kinds),
        "oracle_decode_step": device_split(
            lambda: fresh.decode_step(kv, [0, 1, 2, 3]), kinds)}
    print_splits(profiled, "ssd")
    split["profiled"] = profiled
    return launches, split


def print_splits(profiled: dict, kernel: str) -> None:
    for name, sp in profiled.items():
        busy = sp[kernel] + sp["other"]
        moe = "" if "moe" not in sp else \
            f"; MoE layers {ms_or_not(sp['moe'])} ms"
        print(f"{name}: wall {sp['wall_ms']:.2f} ms, device busy "
              f"{busy:.3f} ms ({busy / sp['wall_ms']:.1%}; {kernel} "
              f"{sp[kernel]:.3f} ms{moe})" if busy else
              f"{name}: wall {sp['wall_ms']:.2f} ms, device time not "
              "measured (no device events in the trace)")


def swa_inputs(b, s, hq, hkv, d, dtype, gen, dev, scale=1.0):
    """Seeded q (B, S, Hq, D) and k/v (B, S, Hkv, D) in ``dtype``."""
    q = torch.randn((b, s, hq, d), generator=gen, device=dev) * scale
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev) * scale
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def check_swa_close(q, k, v, **kw) -> float:
    """The SWA kernel against its plain version on the same operands
    and options, at the dtype's tolerance (fp32 2e-5, bf16 2e-2)."""
    from repro_torch.kernels.swa import ops

    got = ops.swa_attention(q, k, v, **kw)
    want = ops.swa_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = SWA_TOL[q.dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    return max_err(got, want)


def check_swa(dev) -> float:
    """The SWA kernels against their plain version on the card at every
    case of ``SWA_CASES`` in both dtypes (each through the path its dtype
    picks) and at the serving path's full-width prefill shape."""
    from repro_torch.kernels.swa import kernel as K

    phase("swa against its plain version")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    before = dict(K.launches_by_path)
    for b, s, hq, hkv, d, window, softcap, scale in SWA_CASES:
        for dtype in DTYPES:
            err = check_swa_close(
                *swa_inputs(b, s, hq, hkv, d, dtype, gen, dev, scale=scale),
                window=window, softcap=softcap)
            worst = max(worst, err)
            print(f"  swa b {b} s {s} hq {hq} hkv {hkv} d {d} window {window}"
                  f" softcap {softcap:g} {str(dtype)[6:]} "
                  f"({K.PATHS[dtype][0]}): max abs err {err:.2e}")
    b, s, hq, hkv, d, window = SWA_FULL
    err = check_swa_close(
        *swa_inputs(b, s, hq, hkv, d, torch.bfloat16, gen, dev),
        window=window)
    worst = max(worst, err)
    print(f"  swa full width b {b} s {s} hq {hq} hkv {hkv} d {d} window "
          f"{window} bf16 (tc): max abs err {err:.2e}")
    n = len(SWA_CASES)
    ran = {p: K.launches_by_path[p] - before[p] for p in before}
    if ran != {"tc": n + 1, "fma": n}:
        raise AssertionError(f"swa paths launched {ran}, not {n + 1} bf16 "
                             f"on tc and {n} fp32 on fma")
    return worst


def check_swa_groups(params, cfg, cache_len, groups, first, dev, tol,
                     extras=None) -> tuple[float, float, float]:
    """Each prefill group's bf16 prefill through the SWA kernel (its
    first tokens are the engine's, ``first`` by rid; the kernel against
    its plain version on every attention layer's own operands), then
    the first-token logits through the kernel against the plain
    version's, in bf16 (reported) and in fp32 (held to ``tol``).
    ``groups`` holds lists of requests; ``extras`` (by rid) the
    engine's per-request prefill inputs, stacked as the engine stacks
    them.  Returns the worst absolute errors: kernel vs plain per
    layer, fp32 logits, bf16 logits."""
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.models import prefill

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    worst = bf16_worst = swa_worst = 0.0
    kernel_op = swa_ops.swa_attention
    n_attn = cfg.layer_kinds().count("attn")   # the causal ones

    def plain_prefill(batch, c):
        swa_ops.swa_attention = swa_ops.swa_attention_plain
        try:
            return prefill(params, batch, c, cache_len)[0]
        finally:
            swa_ops.swa_attention = kernel_op

    for reqs in groups:
        batch = {"tokens": torch.as_tensor([list(r.tokens) for r in reqs],
                                           device=dev)}
        for key in (extras or {}).get(reqs[0].rid, {}):
            batch[key] = torch.as_tensor(np.stack(
                [extras[r.rid][key] for r in reqs]), device=dev)
        operands = []

        def capture(*args, **kw):
            operands.append((args, kw))
            return kernel_op(*args, **kw)

        swa_ops.swa_attention = capture
        try:
            got, _, _ = prefill(params, batch, cfg, cache_len)
        finally:
            swa_ops.swa_attention = kernel_op
        if len(operands) != n_attn:
            raise AssertionError(f"{len(operands)} swa calls in a prefill "
                                 f"of {n_attn} attention layers")
        for args, kw in operands:
            swa_worst = max(swa_worst, check_swa_close(*args, **kw))
        del operands
        got_first = got[:, :cfg.vocab_size].argmax(dim=1).tolist()
        if got_first != [first[r.rid] for r in reqs]:
            raise AssertionError(f"group {[r.rid for r in reqs]}: first "
                                 f"tokens {got_first} differ from the "
                                 "engine's")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"group {[r.rid for r in reqs]}: logits "
                                 "not finite")
        bf16_worst = max(bf16_worst, max_err(
            got[:, :cfg.vocab_size],
            plain_prefill(batch, cfg)[:, :cfg.vocab_size]))
        got32, _, _ = prefill(params, batch, cfg32, cache_len)
        want32 = plain_prefill(batch, cfg32)
        torch.testing.assert_close(got32, want32, **tol)
        worst = max(worst, max_err(got32[:, :cfg.vocab_size],
                                   want32[:, :cfg.vocab_size]))
    print(f"swa kernel vs plain on the {n_attn} attention layers' operands "
          f"of each of the {len(groups)} prefill groups: max abs err "
          f"{swa_worst:.3e} (tolerance {SWA_TOL[torch.bfloat16]})")
    print(f"first-token logits of {len(groups)} prefill groups, kernel vs "
          f"plain SWA: fp32 prefill max abs err {worst:.3e} (tolerance "
          f"{tol}); bf16 prefill {bf16_worst:.3e}")
    return swa_worst, worst, bf16_worst


def swa_serve_runs() -> dict:
    """The serving paths through the SWA kernel, by arch: traffic,
    oracle and the JAX reference's anchors (above).  ``layers`` cuts
    the depth, ``num_blocks`` sizes the engine's KV pool (the default
    backs every slot), ``admits`` are the oracle anchors' requests (4
    prompts and their new tokens by default), ``frames`` submits each
    request's frame embeddings as ``extras``."""
    return {
        "recurrentgemma-9b": dict(
            cache_len=2576, lengths=(2560, 2100), max_new=16,
            weight_bytes=RG_WEIGHT_BYTES, stats=RG_STATS,
            runs=RG_STEP_RUNS, kv_blocks=644, tol=RG_LOGITS_TOL,
            oracle=(RG_ORACLE_PREFILL_CYCLES, RG_ORACLE_DECODE_CYCLES,
                    RG_ORACLE_DECODE_HIT_RATE)),
        "qwen2-0.5b": dict(
            cache_len=2080, lengths=(2048, 1200), max_new=32,
            weight_bytes=QWEN_WEIGHT_BYTES, stats=QWEN_STATS,
            runs=QWEN_STEP_RUNS, kv_blocks=520, tol=DENSE_LOGITS_TOL,
            oracle=(QWEN_ORACLE_PREFILL_CYCLES, QWEN_ORACLE_DECODE_CYCLES,
                    QWEN_ORACLE_DECODE_HIT_RATE)),
        "mixtral-8x7b": dict(
            cache_len=5136, lengths=(5120, 4200), max_new=16,
            layers=MIXTRAL_LAYERS, weight_bytes=MIXTRAL_WEIGHT_BYTES,
            num_blocks=MIXTRAL_KV_BLOCKS, kv_blocks=MIXTRAL_KV_BLOCKS,
            admits=((5120, 16), (4200, 16)), stats=MIXTRAL_STATS,
            runs=MIXTRAL_STEP_RUNS, tol=DENSE_LOGITS_TOL,
            oracle=MIXTRAL_ORACLE),
        "whisper-tiny": dict(
            cache_len=256, lengths=(224, 120), max_new=32,
            weight_bytes=None, kv_blocks=64, frames=True,
            stats=WHISPER_STATS, runs=WHISPER_STEP_RUNS,
            tol=DENSE_LOGITS_TOL, oracle=WHISPER_ORACLE)}


def request_frames(cfg, rid: int) -> np.ndarray:
    """Request ``rid``'s frame embeddings (encoder_len, d_model), fp32,
    from ``np.random.default_rng(100 + rid)``."""
    return np.random.default_rng(100 + rid).standard_normal(
        (cfg.encoder_len, cfg.d_model)).astype(np.float32)


def moe_drops(params, cfg, batch, cache_len) -> list:
    """The token-choices each MoE layer of a prefill of ``batch``
    drops (past its expert's capacity), in layer order."""
    from repro_torch.models import moe, prefill

    apply_moe = moe.apply_moe
    drops = []

    def counting(p, x, c, **kw):
        b, s, d = x.shape
        group = moe.group_size(b * s)
        r = moe.route(moe.router_probs(p, x.reshape(-1, group, d)), c,
                      moe._capacity(group, c))
        drops.append(int((~r.fits).sum()))
        return apply_moe(p, x, c, **kw)

    moe.apply_moe = counting
    try:
        prefill(params, batch, cfg, cache_len)
    finally:
        moe.apply_moe = apply_moe
    return drops


def serve_swa_path(dev, arch: str) -> tuple[dict, dict]:
    """A serving main path through the SWA kernel, with every launch
    counter at 0 before it: ``arch`` at full width through ServeEngine
    (``swa_serve_runs``), held to the JAX reference's anchors; then each
    prefill group's first-token logits through the SWA kernel against
    the plain version, and the kernel against its plain version on
    every attention layer's operands of those prefills
    (``check_swa_groups``); for an MoE arch the token-choices each layer
    drops in one prefill.  A profiled prefill and decode step split the
    device time into ``swa``, the MoE layers (for an MoE arch) and the
    rest."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.convcore import kernel as cc_kernel
    from repro_torch.kernels.postproc import kernel as pp_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.swa import kernel as swa_kernel
    from repro_torch.models import (
        decode_working_set,
        init_caches,
        init_params,
        prefill,
        slot_decode_step,
    )
    from repro_torch.serve import PagedKVCache, ServeEngine, SoCLatencyOracle
    from repro_torch.types import param_values, tree_map

    run = swa_serve_runs()[arch]
    cache_len, plen = run["cache_len"], run["lengths"][0]
    cfg = get_config(arch)
    cut = ""
    if run.get("layers"):
        cut = f", depth cut to {run['layers']} of {cfg.num_layers} layers"
        cfg = dataclasses.replace(cfg, num_layers=run["layers"])
    phase(f"serving path: {arch} at full width{cut} through ServeEngine")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = param_values(init_params(
        torch.Generator(device=dev).manual_seed(0), cfg))
    torch.cuda.synchronize()
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    n_params = sum(sizes)
    print(f"{n_params:,} fp32 parameters in {time.perf_counter() - t0:.1f} "
          f"s; peak device memory {torch.cuda.max_memory_allocated():,} "
          "bytes")
    ws = decode_working_set(cfg)
    eng = ServeEngine(cfg, params, cache_len=cache_len, max_slots=4,
                      temperature=0.0, eos_id=-1, device=dev,
                      num_blocks=run.get("num_blocks"),
                      oracle=SoCLatencyOracle(
                          ws, weight_bytes=run["weight_bytes"], device=dev))
    requests = serve_requests(cfg.vocab_size, lengths=run["lengths"],
                              max_new=run["max_new"])
    extras = {r.rid: {"frames": request_frames(cfg, r.rid)}
              for r in requests} if run.get("frames") else {}
    for req in requests:
        eng.submit(req, extras=extras.get(req.rid))
    cc_kernel.launches = pp_kernel.launches = ssd_kernel.launches = 0
    swa_kernel.launches = 0
    swa_kernel.launches_by_path.update(tc=0, fma=0)
    t0 = time.perf_counter()
    stats = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"convcore": cc_kernel.launches,
                "postproc": pp_kernel.launches, "ssd": ssd_kernel.launches,
                "swa": swa_kernel.launches}
    by_path = dict(swa_kernel.launches_by_path)
    peak = torch.cuda.max_memory_allocated()
    print(f"EngineStats {json.dumps(stats.to_record())}")
    print(f"serve wall time {wall:.2f} s: model (prefill + decode) "
          f"{eng.wall_s['model']:.2f} s, oracle {eng.wall_s['oracle']:.2f}"
          f" s, {len(eng.oracle._memo)} distinct oracle traces; peak "
          f"device memory {peak:,} bytes")

    by_rid = {r.rid: r for r in requests}
    groups = prefill_groups(eng, requests)
    n_attn = cfg.layer_kinds().count("attn")
    print(f"launches on the serving path: {launches} ({len(groups)} "
          f"prefill groups x {n_attn} attention layers); swa by path "
          f"{by_path}")
    if launches["swa"] != n_attn * len(groups):
        raise AssertionError(f"swa launched {launches['swa']} times, not "
                             f"{n_attn} per prefill group")
    if by_path != {"tc": launches["swa"], "fma": 0}:
        raise AssertionError(f"bf16 serving launched swa by path {by_path},"
                             " not all on the tensor-core path")
    check_engine(eng, stats, run["stats"], run["runs"])

    kv = PagedKVCache(num_blocks=run["kv_blocks"], block_size=16,
                      token_bytes=ws.kv_token_bytes)
    admits = run.get("admits") or ((plen, run["max_new"]),) * 4
    for rid, (n, new) in enumerate(admits):
        kv.admit(rid, n, new)
    pre_s, dec_s = check_oracle(
        SoCLatencyOracle(ws, weight_bytes=run["weight_bytes"], device=dev),
        kv, run["oracle"], decode_rids=range(len(admits)))

    first = {f["rid"]: f["tokens"][0] for f in eng.finished}
    swa_worst, worst, bf16_worst = check_swa_groups(
        params, cfg, cache_len, [[by_rid[r] for r in rids] for rids in groups],
        first, dev, run["tol"], extras)

    split = {"wall_s": wall, "model_s": eng.wall_s["model"],
             "oracle_s": eng.wall_s["oracle"],
             "oracle_prefill_s": pre_s, "oracle_decode_s": dec_s,
             "n_params": n_params, "peak_memory_bytes": peak,
             "logits_fp32_max_abs_err": worst,
             "logits_bf16_max_abs_err": bf16_worst,
             "swa_max_abs_err": swa_worst}
    kinds = {"swa": "swa_tc_kernel"}     # the bf16 prefill's kernel
    caches = param_values(init_caches(cfg, 4, cache_len, device=dev))
    toks = torch.zeros((4, 1), dtype=torch.int64, device=dev)
    ts = torch.full((4,), plen, dtype=torch.int64, device=dev)
    one = {"tokens": torch.as_tensor([list(requests[0].tokens)],
                                     device=dev)}
    for key, val in extras.get(0, {}).items():
        one[key] = torch.as_tensor(val[None], device=dev)
    if cfg.num_experts:
        split["moe_drops_per_layer"] = moe_drops(params, cfg, one, cache_len)
        print(f"MoE token-choices dropped per layer in a 1 x {plen} prefill "
              f"({plen * cfg.num_experts_per_tok} choices a layer): "
              f"{split['moe_drops_per_layer']}")
    ranges = ("moe",) if cfg.num_experts else ()
    split["profiled"] = {
        f"prefill_1x{plen}": device_split(
            lambda: prefill(params, one, cfg, cache_len), kinds, ranges),
        "decode_step_4_slots": device_split(
            lambda: slot_decode_step(params, caches, toks, ts, cfg), kinds,
            ranges)}
    print_splits(split["profiled"], "swa")
    del params, eng, caches
    torch.cuda.empty_cache()
    return launches, split


def greedy_path(dev, arch: str, layers: int | None = None, *,
                kv_cache_dtype: str | None = None,
                splitk: tuple = ()) -> tuple[int, dict]:
    """One arch at full width (``layers`` cuts the depth), with the SWA
    launch counter at 0 before it: parameters from seed 0, one bf16
    prefill of 2048 tokens through the kernel (a VLM arch's prompt
    carries seeded (1, num_patches, d_model) fp32 patches from numpy
    before them) and 8 greedy decode steps; then the kernel against its
    plain version on every layer's own operands of that prefill, and in
    fp32 the prefill's logits through the kernel against the plain
    version's, and the 9 greedy tokens of both equal.  Serves
    granite-3-8b (40 layers, 32 query heads over 8 KV heads of 128, 8.4
    G fp32 parameters), grok-1-314b (2 of 64 layers: 48 query heads over
    8 KV heads of 128, softcap 30, 8 experts of d_ff 32768; 11.4 G),
    internvl2-26b (24 of 48 layers: 48 over 8 heads of 128, 256 patches;
    10.5 G) and deepseek-7b with ``kv_cache_dtype="int8"`` (30 layers,
    32 over 32 heads of 128; 6.9 G), where the first decode step's logits
    are also held against the same run with the bf16 cache as
    tests/test_decode_opt.py's ``rel``, and where an fp32 greedy token
    differed the int8 values that kernel and plain quantised apart are
    counted before the check fails.  ``splitk`` shard counts run
    ``splitk_decode`` on the bf16 greedy run's last decode step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.swa import kernel as swa_kernel
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.types import param_values, tree_map

    cfg = get_config(arch)
    cut = ""
    if layers:
        cut = f", depth cut to {layers} of {cfg.num_layers} layers"
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if kv_cache_dtype:
        cut += f", {kv_cache_dtype} KV cache"
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_cache_dtype)
    s, n_dec = GRANITE_PROMPT, GRANITE_DECODE
    n_prefix = cfg.num_patches if cfg.family == "vlm" else 0
    phase(f"{arch} at full width{cut}, one {s}-token prefill"
          f"{f' after {n_prefix} patches' if n_prefix else ''} and "
          f"{n_dec} decode steps")
    cache_len = n_prefix + s + n_dec
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = param_values(init_params(
        torch.Generator(device=dev).manual_seed(0), cfg))
    torch.cuda.synchronize()
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    n_params = sum(sizes)
    init_s = time.perf_counter() - t0
    print(f"{n_params:,} fp32 parameters in {init_s:.1f} s; peak device "
          f"memory {torch.cuda.max_memory_allocated():,} bytes")
    batch = {"tokens": torch.as_tensor([np.random.default_rng(1).integers(
        3, cfg.vocab_size, s).tolist()], device=dev)}
    if n_prefix:
        batch["patches"] = torch.from_numpy(np.random.default_rng(2)
                                            .standard_normal(
            (1, n_prefix, cfg.d_model)).astype(np.float32)).to(dev)
    kernel_op = swa_ops.swa_attention

    def greedy(c, op, wall=None, last=None):
        """Prefill through ``op``, then ``n_dec`` greedy decode steps:
        (first-token logits, the n_dec + 1 tokens, the first decode
        step's logits); ``last`` gets the last step's caches, token and
        position."""
        swa_ops.swa_attention = op
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches, t = prefill(params, batch, c, cache_len)
            tok = logits[:, :cfg.vocab_size].argmax(dim=1)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out, first_step = [int(tok)], None
            for i in range(n_dec):
                if last is not None:
                    last.update(caches=caches, tok=tok[:, None], t=t + i)
                step, caches = decode_step(params, caches, tok[:, None],
                                           t + i, c)
                first_step = step if first_step is None else first_step
                tok = step[:, :cfg.vocab_size].argmax(dim=1)
                out.append(int(tok))
            t2 = time.perf_counter()
        finally:
            swa_ops.swa_attention = kernel_op
        if wall is not None:
            wall.update(prefill_s=t1 - t0, decode_step_s=(t2 - t1) / n_dec)
        return logits, out, first_step

    operands, wall = [], {}

    def capture(*args, **kw):
        operands.append((args, kw))
        return kernel_op(*args, **kw)

    swa_kernel.launches = 0
    swa_kernel.launches_by_path.update(tc=0, fma=0)
    last: dict = {}
    logits, tokens, first_step = greedy(cfg, capture, wall, last)
    launches = swa_kernel.launches
    by_path = dict(swa_kernel.launches_by_path)
    peak = torch.cuda.max_memory_allocated()
    print(f"bf16: prefill 1 x {n_prefix + s} {wall['prefill_s']:.3f} s "
          f"wall, decode {wall['decode_step_s'] * 1e3:.1f} ms a step; "
          f"tokens {tokens}; swa launches {launches} by path {by_path}; "
          f"peak device memory {peak:,} bytes")
    if launches != cfg.num_layers or by_path != {"tc": launches, "fma": 0}:
        raise AssertionError(f"swa launched {by_path}, not once a layer "
                             "on the tensor-core path")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} bf16 logits not finite")
    if operands[0][0][0].shape[1] != n_prefix + s:
        raise AssertionError(f"swa saw {operands[0][0][0].shape[1]} "
                             f"positions, not {n_prefix + s}")
    swa_worst = max(check_swa_close(*args, **kw) for args, kw in operands)
    del operands
    bf16_gap = max_err(logits[:, :cfg.vocab_size], greedy(
        cfg, swa_ops.swa_attention_plain)[0][:, :cfg.vocab_size])
    int8 = {}
    if cfg.kv_cache_dtype == "int8":
        # tests/test_decode_opt.py's rel: the int8 cache's first decode
        # logits against the same run's with the bf16 cache
        bf16_cache = dataclasses.replace(cfg, kv_cache_dtype="bfloat16")
        _, bf16_tokens, ref_step = greedy(bf16_cache, kernel_op)
        rel = float((first_step.float() - ref_step.float()).abs().max()
                    / (ref_step.float().abs().max() + 1e-6))
        int8 = {"rel_vs_bf16_cache": rel, "bf16_cache_tokens": bf16_tokens}
        print(f"int8 KV cache: first decode logits vs the bf16 cache's rel "
              f"{rel:.4f} (tests/test_decode_opt.py holds rel < 0.08); "
              f"greedy tokens int8 {tokens}, bf16 cache {bf16_tokens}")
        if not rel < 0.08:
            raise AssertionError(f"int8-KV decode diverged (rel {rel:.3f})")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    got32, got_tokens, _ = greedy(cfg32, kernel_op)
    want32, want_tokens, _ = greedy(cfg32, swa_ops.swa_attention_plain)
    torch.testing.assert_close(got32, want32, **DENSE_LOGITS_TOL)
    worst = max_err(got32[:, :cfg.vocab_size], want32[:, :cfg.vocab_size])
    if got_tokens != want_tokens:
        if int8:
            flips = int8_flips(params, batch, cfg32, cache_len, kernel_op)
            print(f"fp32 greedy tokens differ; the prefill's int8 K/V "
                  f"values kernel vs plain: {flips}")
        raise AssertionError(f"fp32 greedy tokens through the kernel "
                             f"{got_tokens} != the plain version's "
                             f"{want_tokens}")
    print(f"swa kernel vs plain on the {cfg.num_layers} layers' operands: "
          f"max abs err {swa_worst:.3e} (tolerance "
          f"{SWA_TOL[torch.bfloat16]}); fp32 first-token logits kernel vs "
          f"plain {worst:.3e} (tolerance {DENSE_LOGITS_TOL}), the "
          f"{n_dec + 1} greedy tokens equal ({got_tokens}); bf16 logit gap "
          f"{bf16_gap:.3e}")
    kinds = {"swa": "swa_tc_kernel"}
    _, caches, t = prefill(params, batch, cfg, cache_len)
    tok = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    ranges = ("moe",) if cfg.num_experts else ()
    profiled = {
        f"prefill_1x{n_prefix + s}": device_split(
            lambda: prefill(params, batch, cfg, cache_len), kinds, ranges),
        "decode_step_1_slot": device_split(
            lambda: decode_step(params, caches, tok, t, cfg), kinds, ranges)}
    print_splits(profiled, "swa")
    split = splitk_decode(params, cfg, last, tokens[-1], splitk) \
        if splitk else {}
    del params, caches, last
    torch.cuda.empty_cache()
    return launches, {**split, "init_s": init_s, **wall,
                      "n_params": n_params,
                      "peak_memory_bytes": peak, "tokens": tokens,
                      "swa_max_abs_err": swa_worst,
                      "logits_fp32_max_abs_err": worst,
                      "logits_bf16_max_abs_err": bf16_gap,
                      **int8, "profiled": profiled}


def splitk_decode(params, cfg, last: dict, want_token: int,
                  shards: tuple) -> dict:
    """Split-K decode on the card: the greedy run's last decode step,
    from its caches, dense and then under ``activate_rules`` on a
    ("data", "model") port mesh of sizes (1, n) with ``cache_seq ->
    ("model",)`` for each n of ``shards``.  Each must go through
    ``_attend_decode_splitk`` with n shards in every layer (the
    reference falls back to dense where ``cache_len % n``, which must
    not pass here), give the dense step's greedy token — itself the
    greedy run's last token — and logits within ``SPLITK_GAP`` of
    max|logit|."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decode_step
    from repro_torch.sharding import activate_rules

    t0 = time.perf_counter()
    v = cfg.vocab_size
    dense = decode_step(params, last["caches"], last["tok"], last["t"],
                        cfg)[0][:, :v].float()
    token = int(dense.argmax(dim=1))
    scale = float(dense.abs().max())
    if token != want_token:
        raise AssertionError(f"the dense step from the kept caches gave "
                             f"{token}, the greedy run {want_token}")
    real, out = attn_mod._attend_decode_splitk, {}
    for n in shards:
        seen = []

        def spy(*args):
            seen.append(args[5])
            return real(*args)

        attn_mod._attend_decode_splitk = spy
        try:
            with activate_rules(make_mesh((1, n), ("data", "model")),
                                {"cache_seq": ("model",)}):
                got = decode_step(params, last["caches"], last["tok"],
                                  last["t"], cfg)[0][:, :v].float()
        finally:
            attn_mod._attend_decode_splitk = real
        torch.cuda.synchronize()
        gap = max_err(got, dense)
        got_token = int(got.argmax(dim=1))
        out[n] = {"shards_seen": seen, "token": got_token,
                  "logit_gap": gap, "gap_of_max": gap / scale}
        print(f"split-K decode over {n} sequence shards: "
              f"_splitk_shards {seen} (one a layer), token {got_token} "
              f"(dense {token}), logit gap {gap:.4e} = {gap / scale:.3e} "
              f"of max|logit| {scale:.4e} (bound {SPLITK_GAP})")
        if seen != [n] * cfg.num_layers:
            raise AssertionError(f"split-K ran with {seen} shards, not "
                                 f"{n} in each of {cfg.num_layers} layers")
        if got_token != token or not gap <= SPLITK_GAP * scale:
            raise AssertionError(f"split-K over {n} shards: token "
                                 f"{got_token} vs {token}, gap {gap:.3e}")
    seconds = time.perf_counter() - t0
    print(f"the split-K check added {seconds:.2f} s")
    return {"splitk": {"cache_len": last["caches"]["blocks"][0]["k"]
                       .shape[2], "position": int(last["t"]),
                       "dense_token": token, "max_abs_logit": scale,
                       "by_shards": out, "seconds": seconds}}


def int8_flips(params, batch, cfg, cache_len, kernel_op) -> dict:
    """The int8 K/V values of one prefill's caches, through the kernel
    and through the plain version, that differ: how many, of how many,
    and the largest difference in quanta."""
    from repro_torch.kernels.swa import ops as swa_ops
    from repro_torch.models import prefill
    from repro_torch.types import tree_map

    caches = []
    for op in (kernel_op, swa_ops.swa_attention_plain):
        swa_ops.swa_attention = op
        try:
            caches.append(prefill(params, batch, cfg, cache_len)[1])
        finally:
            swa_ops.swa_attention = kernel_op
    counts = {"differ": 0, "of": 0, "max_quanta": 0}

    def count(a, b):
        if a.dtype == torch.int8:
            d = (a.int() - b.int()).abs()
            counts["differ"] += int((d > 0).sum())
            counts["of"] += d.numel()
            counts["max_quanta"] = max(counts["max_quanta"], int(d.max()))

    tree_map(count, *caches)
    return counts


def dense_path(dev) -> tuple[int, dict]:
    """The dense transformer family's path: (a) serving qwen2-0.5b at
    full width, (b) granite-3-8b at full width; the SWA launches of
    both (full causal bands, D 64 and D 128)."""
    serve_launches, serve = serve_swa_path(dev, "qwen2-0.5b")
    granite_launches, granite = greedy_path(dev, "granite-3-8b")
    return serve_launches["swa"] + granite_launches, {
        "qwen2-0.5b": serve, "granite-3-8b": granite,
        "swa_max_abs_err": max(serve["swa_max_abs_err"],
                               granite["swa_max_abs_err"])}


def moe_path(dev) -> tuple[int, dict]:
    """The MoE family's path: (a) serving mixtral-8x7b at full width cut
    to 8 of 32 layers (banded attention, D 128, groups of 4), (b)
    grok-1-314b at full width cut to 2 of 64 layers (soft-capped full
    causal attention, D 128, groups of 6), then its last decode step
    split-K over 4 and 8 sequence shards (``splitk_decode``); the SWA
    launches of both."""
    serve_launches, serve = serve_swa_path(dev, "mixtral-8x7b")
    grok_launches, grok = greedy_path(dev, "grok-1-314b", GROK_LAYERS,
                                      splitk=GROK_SPLITK_SHARDS)
    return serve_launches["swa"] + grok_launches, {
        "mixtral-8x7b": serve, "grok-1-314b": grok,
        "swa_max_abs_err": max(serve["swa_max_abs_err"],
                               grok["swa_max_abs_err"])}


def encdec_path(dev) -> tuple[int, dict]:
    """The encoder-decoder path: serving whisper-tiny at full width and
    depth with each request's frames as ``extras``; the SWA launches of
    its decoder's causal self-attention (full causal, D 64, no
    grouping; the encoder and the cross-attention are plain torch, as
    in the reference)."""
    launches, serve = serve_swa_path(dev, "whisper-tiny")
    return launches["swa"], {"whisper-tiny": serve,
                             "swa_max_abs_err": serve["swa_max_abs_err"]}


def vlm_path(dev) -> tuple[int, dict]:
    """The VLM input stage: internvl2-26b at full width cut to 24 of its
    48 layers (10.5 G fp32 parameters; the full 19.9 G do not fit one
    card), a bf16 prefill of 256 seeded patches and 2048 tokens (full
    causal attention over 2304 positions, 48 query heads over 8 KV heads
    of 128, no softcap) and 8 greedy steps; the SWA launches."""
    launches, run = greedy_path(dev, "internvl2-26b", VLM_LAYERS)
    return launches, {"internvl2-26b": run,
                      "swa_max_abs_err": run["swa_max_abs_err"]}


def int8_kv_path(dev) -> tuple[int, dict]:
    """int8 KV caches: deepseek-7b at full width and depth (30 layers,
    32 query over 32 KV heads of 128, 6.9 G fp32 parameters) decoding
    from int8 caches with per-slot fp32 scales; the SWA launches of its
    prefill."""
    launches, run = greedy_path(dev, "deepseek-7b", kv_cache_dtype="int8")
    return launches, {"deepseek-7b-int8": run,
                      "swa_max_abs_err": run["swa_max_abs_err"]}


def farm_path(dev) -> dict:
    """benchmarks/fig6_tail.py's full sizes through the port's farm
    (``repro_torch.core.farm``, the NoC switch and the interference lane
    on the card): nodes 0, 1, 2 and 4, 2048 bursts, 256 KiB / 8-way /
    64 B LLC, unpartitioned and with the victim in ways 0x0F, every
    summary held exactly to the reference's (``FARM_ANCHORS``); the
    suite's own acceptance properties; the token-bundle switch at
    bundles 1, 7 and 64 against the per-cycle scheduler on nodes 0 and
    4 at 1024 bursts; walls and the device's busy share."""
    from repro_torch.core.cache import LLCConfig
    from repro_torch.core.dram import DRAMConfig
    from repro_torch.core.farm import (FarmConfig, farm_schedule,
                                       simulate_farm, victim_window)
    from repro_torch.core.noc import NoCConfig, NoCSwitch, simulate_reference
    from repro_torch.core.sweep import MixConfig, interference_lane_metrics
    from repro_torch.utils.stats import latency_summary

    phase("farm path (Fig. 6 tail: victim and co-runner nodes through the "
          "NoC switch and the shared LLC/DRAM)")
    llc, dram = LLCConfig(FARM_LLC_BYTES, 8, 64), DRAMConfig()
    wall, summaries, solo = {}, {}, None
    for mask in (None, FARM_MASK):
        for n in FARM_NODES:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = simulate_farm(llc=llc, dram=dram,
                                farm=FarmConfig(nodes=n, way_mask=mask),
                                max_bursts=FARM_BURSTS, device=dev)
            torch.cuda.synchronize()
            key = f"{'part_' if mask else ''}x{n}"
            wall[key] = time.perf_counter() - t0
            got = {**latency_summary(res.steady()),
                   "noc_mean": float(res.noc_latency.mean()),
                   "mem_mean": float(res.mem_latency.mean()),
                   "host_steps": res.noc.host_steps}
            if got != FARM_ANCHORS[mask][n]:
                raise AssertionError(f"farm {key}: {got} != the "
                                     f"reference's {FARM_ANCHORS[mask][n]}")
            summaries[key] = got
            if n == 0 and mask is None:
                solo = res
            print(f"  {key}: p50 {got['p50']} p99 {got['p99']} wcet "
                  f"{got['wcet']} noc_mean {got['noc_mean']} mem_mean "
                  f"{got['mem_mean']} host_steps {got['host_steps']}; "
                  f"{wall[key]:.3f} s wall on {dev}", flush=True)
    print(f"{len(summaries)} farm summaries == the reference's "
          "fig6_tail run(smoke=False)")
    # the suite's acceptance: superlinear p99, partitioning recovers it,
    # the solo farm's lane is the Fig. 6 solo lane
    p99 = {n: summaries[f"x{n}"]["p99"] for n in FARM_NODES}
    lo, hi = FARM_NODES[0], FARM_NODES[-1]
    mid = FARM_NODES[len(FARM_NODES) // 2]
    if not (p99[hi] - p99[mid] > p99[mid] - p99[lo]
            and summaries[f"part_x{hi}"]["p99"] < p99[hi]):
        raise AssertionError(f"farm QoS shape broken: {summaries}")
    ref = interference_lane_metrics(
        victim_window("nvdla", max_bursts=FARM_BURSTS) * 2, llc=llc,
        dram=dram, mix=MixConfig(0, "l1"), device=dev)
    if solo.metrics != ref:
        raise AssertionError("solo farm lane != interference_lane_metrics")
    # the token-bundle switch against the per-cycle scheduler
    requests = 2 * FARM_PARITY_BURSTS // 16
    for n in FARM_PARITY_NODES:
        farm = FarmConfig(nodes=n)
        sched = farm_schedule(requests, farm)
        cfg = NoCConfig(ports=n + 2, link_latency=farm.link_latency)
        want = simulate_reference(sched, cfg)
        for bundle in (1, 7, 64):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = NoCSwitch(cfg, device=dev).simulate(sched,
                                                      bundle_cycles=bundle)
            wall[f"switch_x{n}_bundle{bundle}"] = time.perf_counter() - t0
            for f in ("deliver_cycle", "egress", "src", "latency"):
                if not np.array_equal(getattr(got, f), getattr(want, f)):
                    raise AssertionError(
                        f"switch n={n} bundle={bundle}: {f} differs from "
                        "the per-cycle scheduler")
            print(f"  switch x{n} bundle {bundle}: {want.cycles_run} cycles "
                  f"in {got.host_steps} host steps, "
                  f"{wall[f'switch_x{n}_bundle{bundle}']:.3f} s wall; "
                  "== simulate_reference", flush=True)
    # device time of the heaviest farm, profiled again
    key = f"part_x{hi}"
    split = device_split(lambda: simulate_farm(
        llc=llc, dram=dram, farm=FarmConfig(nodes=hi, way_mask=FARM_MASK),
        max_bursts=FARM_BURSTS, device=dev))
    dev_ms = sum(v for k, v in split.items() if k != "wall_ms")
    print(f"{key} (profiled): device busy {dev_ms:.2f} ms, "
          f"{dev_ms / (wall[key] * 1e3):.1%} of its {wall[key]:.3f} s wall "
          f"(profiled wall {split['wall_ms'] / 1e3:.3f} s)" if dev_ms else
          f"{key} (profiled): device time not measured (no device events "
          "in the trace)")
    return {"wall_s": wall, "summaries": summaries,
            "profiled": {key: {"profiled_wall_ms": split["wall_ms"],
                               "device_ms": dev_ms}}}


def ptxas_report(log: str, kernel: str) -> dict:
    """Registers, stack and spill bytes of every kernel whose (mangled)
    name contains ``kernel`` in a ``ptxas -v`` log, by that name."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = m.group(1)
            continue
        if not name or kernel not in name:
            continue
        rec = out.setdefault(name, {})
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers")):
            found = re.search(pat, line)
            if found:
                rec[key] = int(found.group(1))
    return out


def check_ptxas(name: str, kernels: tuple, count: int, note: str = "") -> dict:
    """Print the ptxas report of each of ``kernels`` (name substrings) in
    ``csrc/<name>.cu``'s build and require ``count`` instances, each with
    no spill stores or loads."""
    from repro_torch.kernels import _build

    log = _build.report(name)
    report = {}
    for kernel in kernels:
        report.update(ptxas_report(log, kernel))
    for mangled, rec in sorted(report.items()):
        print(f"  ptxas {mangled}: {rec.get('registers')} registers{note}, "
              f"{rec.get('stack')} bytes stack, spill stores "
              f"{rec.get('spill_stores')}, spill loads "
              f"{rec.get('spill_loads')}")
    if len(report) != count or any(
            rec.get("spill_stores", 1) or rec.get("spill_loads", 1)
            for rec in report.values()):
        raise AssertionError(f"{name} ptxas report: {report}")
    return report


def behind_wait(enqueue, reps: int):
    """Run ``enqueue()`` (which queues ``reps`` timed calls) behind a
    device-side wait (``torch.cuda._sleep``), so that the card runs the
    calls back to back however slowly the host issues them; the wait is
    lengthened until it outlasts the host's enqueue.  Returns what
    ``enqueue`` returned, once the card has run it."""
    cycles = 1 << 21
    for _ in range(6):
        torch.cuda.synchronize()
        wait = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        wait[0].record()
        torch.cuda._sleep(cycles)
        wait[1].record()
        t0 = time.perf_counter()
        result = enqueue()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if wait[0].elapsed_time(wait[1]) > 1.5 * host_ms:
            return result
        cycles *= 4
    raise AssertionError("the device-side wait never outlasted the host's "
                         f"enqueue of {reps} calls")


def queued_ms(fn, reps: int) -> float:
    """Device time of one call of ``fn`` (ms): CUDA events around ``reps``
    calls queued behind a device-side wait (``behind_wait``)."""
    fn()

    def enqueue():
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        return start, end

    start, end = behind_wait(enqueue, reps)
    return start.elapsed_time(end) / reps


def cold_queued_ms(fn, reps: int, flush) -> float:
    """Device time of one call of ``fn`` (ms) with a cold L2: before each
    call the card runs ``flush`` (which sweeps at least twice the 50 MB
    L2), and CUDA events bracket the call alone; the calls are queued
    behind a device-side wait (``behind_wait``)."""
    fn()

    def enqueue():
        events = []
        for _ in range(reps):
            flush()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            events.append((start, end))
        return events

    return sum(start.elapsed_time(end)
               for start, end in behind_wait(enqueue, reps)) / reps


def device_times(fn, reps: int, match: str, expect: int | None = None):
    """Device time of one call of ``fn`` (ms) in the kernels whose name
    contains ``match`` and in every other device event: the events of a
    torch.profiler window that runs ``fn`` ``reps`` times after one
    warm-up call, summed and divided by ``reps``.  The window must hold
    ``expect`` matching kernels (at least ``reps`` where not given); on
    the card the tracer was seen to drop kernels, so a short trace is
    taken again, up to three times, and then gives None (not
    measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hit = rest = 0.0
        count = 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if match in e.name:
                    hit += e.device_time_total
                    count += 1
                else:
                    rest += e.device_time_total
        if (count == expect) if expect is not None else count >= reps:
            return hit / 1e3 / reps, rest / 1e3 / reps
    return None


def device_ms(fn, reps: int, match: str | None = None,
              expect: int | None = None) -> float | None:
    """Device time of one call of ``fn`` (ms) from the profiler: its
    kernels whose name contains ``match`` or, with none, every device
    event of the window; None where the trace stayed short."""
    times = device_times(fn, reps, match or "", expect)
    return None if times is None else times[0] if match else sum(times)


def ms_or_not(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def host_us(fn, n: int = 50) -> float:
    """Host time of one call of ``fn`` (µs), ``n`` calls back to back
    without a synchronise: what the caller waits before it goes on."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def swa_bound(out: dict, b, s, hq, hkv, d, window) -> tuple[int, int]:
    """The bf16 SWA call's least time into ``out`` (``bound_ms``,
    ``bound_by``): the FLOPs of the in-band pairs only (q.k and p.v, 2 D
    each) over the bf16 tensor-core peak, or the bytes of q, o and the
    un-expanded k, v over HBM.  Returns (FLOPs, bytes)."""
    pairs = sum(min(i + 1, window) for i in range(s))
    flops = 4 * d * pairs * hq * b
    nbytes = 2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    out["bound_ms"] = max(flops / BF16_OPS_PER_S,
                          nbytes / HBM_BYTES_PER_S) * 1e3
    out["bound_by"] = "operations" if flops / BF16_OPS_PER_S >= \
        nbytes / HBM_BYTES_PER_S else "bytes"
    return flops, nbytes


def time_swa(dev) -> dict:
    """The SWA kernel at recurrentgemma-9b's full-width prefill (1 x
    2560 tokens, 16 query heads, 1 KV head, D 256, window 2048, bf16)
    beside its plain version, scaled_dot_product_attention with the
    boolean band mask, its bound and the fp32 FMA kernel on the same
    operands; the host cost of a launch (the bf16 wrapper encodes three
    TMA descriptors per call) and the tensor-core kernel's ptxas report,
    which must show no spills."""
    from repro_torch.kernels.swa import kernel as K
    from repro_torch.kernels.swa import ops

    b, s, hq, hkv, d, window = SWA_FULL
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = swa_inputs(b, s, hq, hkv, d, torch.bfloat16, gen, dev)
    q32, k32, v32 = (x.float() for x in (q, k, v))

    def tc():
        return K.swa_attention_kernel(q, k, v, window=window, scale=d ** -0.5)

    def fma():
        return K.swa_attention_kernel(q32, k32, v32, window=window,
                                      scale=d ** -0.5)

    out = {"event_ms": cuda_ms(tc, 20), "ms": queued_ms(tc, 20),
           "profiled_ms": device_ms(tc, 20, "swa_tc_kernel", expect=20),
           "plain_ms": cuda_ms(lambda: ops.swa_attention_plain(
               q, k, v, window=window), 5),
           "fma_ms": cuda_ms(fma, 5)}
    out["host_us"] = {"tc": host_us(tc), "fma": host_us(fma, 10)}
    # the library yardstick: one PyTorch call on the same function (KV
    # heads expanded and the band as a boolean mask, outside the timing)
    pos = torch.arange(s, device=dev)
    band = (pos[:, None] >= pos[None, :]) & \
        (pos[:, None] - pos[None, :] < window)
    qh = q.transpose(1, 2)
    kh, vh = (x.transpose(1, 2).expand(b, hq, s, d).contiguous()
              for x in (k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=band)

    out["library_event_ms"] = cuda_ms(sdpa, 20)
    out["library_ms"] = queued_ms(sdpa, 20)
    out["library_profiled_ms"] = device_ms(sdpa, 20)
    lib_err = max_err(sdpa().transpose(1, 2),
                      ops.swa_attention_plain(q, k, v, window=window))
    flops, nbytes = swa_bound(out, b, s, hq, hkv, d, window)
    print(f"swa b {b} s {s} hq {hq} hkv {hkv} d {d} window {window} bf16: "
          f"kernel (tc) {out['ms']:.4f} ms of device time (profiler "
          f"{ms_or_not(out['profiled_ms'])}, events {out['event_ms']:.4f}), "
          f"plain {out['plain_ms']:.4f} ms, scaled_dot_product_attention "
          f"{out['library_ms']:.4f} ms of device time (profiler "
          f"{ms_or_not(out['library_profiled_ms'])}, events "
          f"{out['library_event_ms']:.4f}) (max abs "
          f"err vs plain {lib_err:.2e}), bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}: {flops / 1e9:.2f} GFLOP in band, "
          f"{nbytes / 1e6:.1f} MB); the same operands in fp32 through the "
          f"FMA kernel {out['fma_ms']:.4f} ms")
    print(f"  host time per launch (no synchronise): tc {out['host_us']['tc']:.1f}"
          f" µs (three TMA descriptors encoded), fma "
          f"{out['host_us']['fma']:.1f} µs")
    report = check_ptxas("swa", ("swa_tc_kernel",), 2 * len(K.HEAD_DIMS),
                         " at launch (setmaxnreg: producer 40, consumers 232)")
    print("  dynamic shared memory by D: " + ", ".join(
        f"{dim}: {K.tc_smem_bytes(dim)}" for dim in K.HEAD_DIMS))
    out["ptxas"] = report
    return out


def time_swa_archs(dev) -> dict:
    """The SWA kernel at the served archs' full-width prefill shapes
    (``SWA_ARCHS``, bf16) beside its plain version, its bound (the
    in-band pairs' FLOPs over the bf16 tensor-core peak, or the bytes
    over HBM) and scaled_dot_product_attention on the KV heads expanded
    outside the timing: ``is_causal=True`` for a full causal band, a
    boolean band mask for a narrower one; none for a soft-capped one
    (SDPA applies no tanh softcap)."""
    from repro_torch.kernels.swa import kernel as K
    from repro_torch.kernels.swa import ops

    out = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    for arch, (b, s, hq, hkv, d, window, cap) in SWA_ARCHS.items():
        q, k, v = swa_inputs(b, s, hq, hkv, d, torch.bfloat16, gen, dev)

        def tc():
            return K.swa_attention_kernel(q, k, v, window=window,
                                          scale=d ** -0.5, softcap=cap)

        qh = q.transpose(1, 2)
        kh, vh = (x.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
                  .contiguous() for x in (k, v))
        pos = torch.arange(s, device=dev)
        band = (pos[:, None] >= pos[None, :]) & \
            (pos[:, None] - pos[None, :] < window)
        full = window >= s

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=full, attn_mask=None if full else band)

        want = ops.swa_attention_plain(q, k, v, window=window, softcap=cap)
        tm = {"ms": queued_ms(tc, 20), "event_ms": cuda_ms(tc, 20),
              "plain_ms": cuda_ms(lambda: ops.swa_attention_plain(
                  q, k, v, window=window, softcap=cap), 5),
              "library_ms": None, "library_event_ms": None,
              "max_abs_err": max_err(tc(), want)}
        library = "scaled_dot_product_attention: none (no tanh softcap)"
        if not cap:
            tm["library_ms"] = queued_ms(sdpa, 20)
            tm["library_event_ms"] = cuda_ms(sdpa, 20)
            library = (f"scaled_dot_product_attention("
                       f"{'is_causal=True' if full else 'band mask'}) "
                       f"{tm['library_ms']:.4f} ms (events "
                       f"{tm['library_event_ms']:.4f}; max abs err vs plain "
                       f"{max_err(sdpa().transpose(1, 2), want):.2e})")
        flops, nbytes = swa_bound(tm, b, s, hq, hkv, d, window)
        if tm["max_abs_err"] > SWA_TOL[torch.bfloat16]:
            raise AssertionError(f"swa at {arch}'s shape: max abs err "
                                 f"{tm['max_abs_err']:.3e} vs plain")
        print(f"swa {arch} b {b} s {s} hq {hq} hkv {hkv} d {d} window "
              f"{window} softcap {cap:g} bf16: kernel (tc) {tm['ms']:.4f} ms "
              f"of device time (events {tm['event_ms']:.4f}), plain "
              f"{tm['plain_ms']:.4f} ms, {library}, bound "
              f"{tm['bound_ms']:.4f} ms ({tm['bound_by']}: "
              f"{flops / 1e9:.2f} GFLOP in band, {nbytes / 1e6:.1f} MB); "
              f"kernel vs plain max abs err {tm['max_abs_err']:.2e}")
        out[arch] = tm
        del q, k, v, qh, kh, vh, want, band
    return out


def time_ssd(dev) -> dict:
    """The SSD kernel at the serving path's full width (4 prompts of 512
    tokens: 8 chunks of 256, 24 heads, p 64, n 128) beside its plain
    version and its bound; its ptxas report, which must show no
    spills."""
    from repro_torch.kernels.ssd import kernel as K
    from repro_torch.kernels.ssd import ops, ref

    bb, l, chunk, h, p, n = SSD_SHAPES[3]
    gen = torch.Generator(device=dev).manual_seed(3)
    x, dt, A, B, C = ssd_inputs(bb, l, h, p, n, gen, dev)
    xc, dtc, cum, bc, cc = ops._chunked(x, dt, A, B, C, chunk)
    nc, q = xc.shape[1], xc.shape[2]

    def kernel():
        return K.ssd_intra_chunk_kernel(xc, dtc, cum, bc, cc)

    out = {"event_ms": cuda_ms(kernel, 50), "ms": queued_ms(kernel, 20),
           "profiled_ms": device_ms(kernel, 20, "ssd_", expect=40),
           "y_ms": device_ms(kernel, 20, "ssd_y_kernel", expect=20),
           "state_ms": device_ms(kernel, 20, "ssd_state_kernel", expect=20),
           "plain_ms": cuda_ms(lambda: ref.ssd_intra_chunk_ref(
               xc, dtc, cum, bc, cc), 20),
           "library_ms": None}
    # FLOPs the masked function needs: the causal (l >= s) pairs of C.B^T
    # (once per chunk) and of scores @ x, ~5 a pair per head for the
    # decay and mask, and the per-head state product B^T (w x)
    pairs = q * (q + 1) // 2
    flops = bb * nc * (2 * pairs * n + h * (2 * pairs * p + 5 * pairs
                                            + 2 * q * n * p))
    # the TPU kernel's own count (the full q x q), printed for comparison
    full_flops = bb * nc * (2 * q * q * n + h * (2 * q * q * p + 5 * q * q
                                                 + 2 * q * n * p))
    nbytes = 4 * bb * nc * (2 * q * h * p + h * n * p + 2 * q * n
                            + 2 * q * h)
    # fp32-accurate products at the TF32 tensor cores' rate: three TF32
    # products for each (3xTF32)
    rate = TF32_OPS_PER_S / 3
    out["bound_ms"] = max(flops / rate, nbytes / HBM_BYTES_PER_S) * 1e3
    out["bound_by"] = "operations" if flops / rate >= \
        nbytes / HBM_BYTES_PER_S else "bytes"
    out["fma_bound_ms"] = max(flops / FP32_OPS_PER_S,
                              nbytes / HBM_BYTES_PER_S) * 1e3
    print(f"ssd {bb}x{nc} chunks of {q}, h {h}, p {p}, n {n}: kernel "
          f"{out['ms']:.4f} ms of device time (profiler "
          f"{ms_or_not(out['profiled_ms'])}: y {ms_or_not(out['y_ms'])}, "
          f"states {ms_or_not(out['state_ms'])}; events "
          f"{out['event_ms']:.4f}), plain "
          f"{out['plain_ms']:.4f} ms, no library call computes it, bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}: {flops / 1e6:.0f} "
          f"MFLOP causal at {rate / 1e12:.0f} TFLOP/s (3xTF32), "
          f"{nbytes / 1e6:.1f} MB; at the fp32 FMA rate "
          f"{out['fma_bound_ms']:.4f} ms; the TPU kernel's full q x q count "
          f"{full_flops / 1e6:.0f} MFLOP would give "
          f"{full_flops / rate * 1e3:.4f} ms)")
    out["ptxas"] = check_ptxas("ssd", ("ssd_y_kernel", "ssd_state_kernel"), 2)
    print(f"  dynamic shared memory: {K.smem_bytes()}")
    out["grouped"] = {g: time_ssd_grouped(dev, g) for g in SSD_GROUPS}
    return out


def time_ssd_grouped(dev, g: int) -> dict:
    """The SSD kernel at the same width with ``g`` SSM groups: its ``g``
    launches (one a group, over h / g contiguous heads) on operands
    chunked outside the timing, the whole grouped op (per-group slicing
    and chunking included) and the plain version, beside the bound of
    the grouped function (each group's causal C.B^T pairs once, its
    heads' products, B/C read once a group)."""
    from repro_torch.kernels.ssd import kernel as K
    from repro_torch.kernels.ssd import ops

    bb, l, chunk, h, p, n = SSD_SHAPES[3]
    gen = torch.Generator(device=dev).manual_seed(30 + g)
    x, dt, A, B, C = ssd_inputs(bb, l, h, p, n, gen, dev, groups=g)
    hg = h // g
    parts = [tuple(ops._aligned(t) for t in ops._chunked(
        x[:, :, i * hg:(i + 1) * hg], dt[:, :, i * hg:(i + 1) * hg],
        A[i * hg:(i + 1) * hg], B[:, :, i], C[:, :, i], chunk))
        for i in range(g)]
    nc, q = parts[0][0].shape[1], parts[0][0].shape[2]

    def kernels():
        return [K.ssd_intra_chunk_kernel(*part) for part in parts]

    out = {"ms": queued_ms(kernels, 20),
           "op_ms": cuda_ms(lambda: ops.ssd_intra_chunk(x, dt, A, B, C,
                                                        chunk=chunk), 20),
           "plain_ms": cuda_ms(lambda: ops.ssd_intra_chunk_plain(
               x, dt, A, B, C, chunk=chunk), 5),
           "library_ms": None, "launches_per_call": g}
    pairs = q * (q + 1) // 2
    flops = bb * nc * (g * 2 * pairs * n + h * (2 * pairs * p + 5 * pairs
                                                + 2 * q * n * p))
    nbytes = 4 * bb * nc * (2 * q * h * p + h * n * p + 2 * g * q * n
                            + 2 * q * h)
    rate = TF32_OPS_PER_S / 3
    out["bound_ms"] = max(flops / rate, nbytes / HBM_BYTES_PER_S) * 1e3
    out["bound_by"] = "operations" if flops / rate >= \
        nbytes / HBM_BYTES_PER_S else "bytes"
    print(f"ssd {bb}x{nc} chunks of {q}, h {h}, p {p}, n {n}, {g} groups "
          f"of {hg} heads: kernel {out['ms']:.4f} ms of device time ({g} "
          f"launches), the grouped op {out['op_ms']:.4f} ms (events), plain "
          f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}: {flops / 1e6:.0f} MFLOP causal, "
          f"{nbytes / 1e6:.1f} MB)")
    return out


def int_mm_call(patches, wmat):
    """torch._int_mm on the same GEMM (K and N padded to multiples of 8,
    as it requires, outside the call), or None where it refuses the
    operands."""
    k, n = wmat.shape
    kp, np_ = k + (-k) % 8, n + (-n) % 8
    a = torch.nn.functional.pad(patches, (0, kp - k)).contiguous()
    b = torch.nn.functional.pad(wmat, (0, np_ - n, 0, kp - k)).contiguous()
    for bb in (b, b.t().contiguous().t()):
        try:
            torch._int_mm(a, bb)
        except RuntimeError as e:
            err = e
            continue
        return lambda: torch._int_mm(a, bb)
    print(f"  torch._int_mm refused {tuple(a.shape)} @ {tuple(b.shape)}: "
          f"{str(err).splitlines()[0]}")
    return None


def time_kernels(dev) -> tuple[dict, list]:
    """Per-kernel times at the main path's shapes: convcore per layer and
    summed over a frame's 75 convs (GEMM on prebuilt im2col patches; each
    layer's int32 accumulation first checked exact), then postproc
    (``time_postproc``); each beside its library call, by device time
    and by CUDA events."""
    from repro_torch.kernels.convcore import kernel as cc_kernel
    from repro_torch.kernels.convcore import matmul_int8
    from repro_torch.kernels.convcore.ops import im2col
    from repro_torch.kernels.convcore.ref import matmul_int8_ref

    phase("timing (device time: CUDA events around calls queued behind a "
          "device-side wait; torch.profiler and plain CUDA events beside)")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, lib_missing = [], False
    for l in frame_layers():
        x, w, scale, bias = frame_inputs(l, gen, dev)
        patches, _ = im2col(x, l.ksize, l.ksize, stride=l.stride,
                            padding=l.ksize // 2)
        wmat = w.reshape(-1, l.cout)
        m, k = patches.shape
        n = l.cout
        exact = matmul_int8(patches, wmat, torch.ones(n, device=dev),
                            torch.zeros(n, device=dev),
                            out_dtype=torch.float32)
        if not torch.equal(exact, (patches.double() @ wmat.double()).float()):
            raise AssertionError(f"layer {l.index} {m}x{k}x{n}: int "
                                 "accumulation not exact")
        kw = dict(relu=True, out_dtype=torch.float32)

        def call():
            return matmul_int8(patches, wmat, scale, bias, **kw)

        # the kernel alone, on the operands the wrapper would give it
        plan = cc_kernel.launch_plan(m, n, k)
        pad = plan.kp - k
        a_p = torch.nn.functional.pad(patches, (0, pad)).contiguous()
        bt = torch.nn.functional.pad(wmat.t(), (0, pad)).contiguous()
        out = torch.empty((m, n), device=dev)

        def kernel_call():
            return cc_kernel.matmul_int8_kernel(a_p, bt, scale, bias, out,
                                                relu=True)

        lib = int_mm_call(patches, wmat)
        lib_missing |= lib is None
        ms = queued_ms(kernel_call, 5)
        ops_s = 2 * m * n * k / INT8_OPS_PER_S
        bytes_s = (m * k + k * n + 8 * n + 4 * m * n) / HBM_BYTES_PER_S
        rows.append({
            "layer": l.index, "m": m, "k": k, "n": n,
            "plan": dataclasses.asdict(plan),
            "ms": ms, "wrapper_ms": queued_ms(call, 5) - ms,
            "profiled_ms": device_ms(call, 5, "convcore_",
                                     expect=5 * (1 + (plan.splits > 1))),
            "event_ms": cuda_ms(call, 5),
            "plain_ms": cuda_ms(
                lambda: matmul_int8_ref(patches, wmat, scale, bias, **kw), 2, 1),
            "library_ms": None if lib is None else queued_ms(lib, 5),
            "library_profiled_ms": None if lib is None else device_ms(lib, 5),
            "library_event_ms": None if lib is None else cuda_ms(lib, 5),
            "ops_ms": ops_s * 1e3, "bytes_ms": bytes_s * 1e3})
    print(f"int32 accumulation exact at all {len(rows)} frame convs "
          "(unit scale, zero bias, fp32 out)")
    print("convcore per layer (ms of device time: kernel, wrapper copies, "
          "torch._int_mm; the kernel by the profiler; bound; plan "
          "bn/splits/kps/m_blocks):")
    for r in rows:
        p = r["plan"]
        print(f"  layer {r['layer']:3d} {r['m']}x{r['k']}x{r['n']}: "
              f"{r['ms']:.4f}, {r['wrapper_ms']:.4f}, "
              f"{ms_or_not(r['library_ms'])}; {ms_or_not(r['profiled_ms'])}; "
              f"{max(r['ops_ms'], r['bytes_ms']):.4f}; {p['bn']}/"
              f"{p['splits']}/{p['kps']}/{p['m_blocks']}")

    def total(key):
        return None if any(r[key] is None for r in rows) \
            else sum(r[key] for r in rows)

    cc = {key: total(key) for key in (
        "ms", "wrapper_ms", "profiled_ms", "event_ms", "plain_ms",
        "library_ms", "library_profiled_ms", "library_event_ms")}
    cc["bound_ms"] = sum(max(r["ops_ms"], r["bytes_ms"]) for r in rows)
    by_ops = sum(r["ops_ms"] for r in rows if r["ops_ms"] >= r["bytes_ms"])
    cc["bound_by"] = "operations" if by_ops >= cc["bound_ms"] / 2 \
        else "bytes"
    heavy = max(rows, key=lambda r: r["m"] * r["n"] * r["k"])
    print(f"convcore per frame (75 convs): kernel {cc['ms']:.4f} ms of device"
          f" time (profiler {ms_or_not(cc['profiled_ms'])}, events through "
          f"the wrapper {cc['event_ms']:.3f}), the wrapper's copies "
          f"{cc['wrapper_ms']:.4f} ms, plain {cc['plain_ms']:.3f} ms, "
          f"torch._int_mm {ms_or_not(cc['library_ms'])} ms of device time "
          f"(profiler {ms_or_not(cc['library_profiled_ms'])}, events "
          f"{ms_or_not(cc['library_event_ms'])}), bound "
          f"{cc['bound_ms']:.4f} ms ({cc['bound_by']})")
    print(f"  heaviest, layer {heavy['layer']} {heavy['m']}x{heavy['k']}x"
          f"{heavy['n']}: kernel {heavy['ms']:.4f} ms, _int_mm "
          f"{ms_or_not(heavy['library_ms'])} ms, bound "
          f"{max(heavy['ops_ms'], heavy['bytes_ms']):.4f} ms")
    cc["ptxas"] = check_ptxas("convcore", ("convcore_wgmma_kernel",
                                           "convcore_splitk_reduce"), 6,
                              " at launch (wgmma: setmaxnreg 40/232)")
    print(f"  dynamic shared memory: bn 64 {cc_kernel.smem_bytes(64)}, bn 128 "
          f"{cc_kernel.smem_bytes(128)} bytes")

    return {"convcore": cc, "postproc": time_postproc(dev)}, rows


def time_postproc(dev) -> dict:
    """postproc on the numeric stage's 208 x 208 x 64 fp32 map, pool 2,
    bf16 out: the kernel beside max_pool2d (the same function at unit
    scale, zero bias and no activation) by device time with a warm L2
    (back-to-back calls: the 11 MB input stays in the 50 MB L2) and a
    cold one (after a 128 MiB write sweep, whose dirty lines the call
    then evicts; after a read sweep beside it), with what the cold method
    costs a launch that moves nothing; the kernel's launch plan and its
    ptxas report."""
    from repro_torch.kernels.postproc import kernel as pp_kernel
    from repro_torch.kernels.postproc import postprocess
    from repro_torch.kernels.postproc.ref import postprocess_ref

    gen = torch.Generator(device=dev).manual_seed(2)
    n_, h, w, c = 1, 208, 208, 64
    x = torch.randn((n_, h, w, c), generator=gen, device=dev)
    ones, zeros = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    kw = dict(act="none", pool=2)
    xc = x.permute(0, 3, 1, 2)          # channels_last view, no copy
    scratch = torch.empty(1 << 25, device=dev)       # 128 MiB

    def pp_call():
        return postprocess(x, ones, zeros, **kw)

    def pool():
        # unit scale, zero bias, no activation: max-pool is the same
        # function on these inputs
        return torch.nn.functional.max_pool2d(xc, 2)

    if not torch.equal(pp_call(), pool().permute(0, 2, 3, 1).to(
            torch.bfloat16)):
        raise AssertionError("postproc and max_pool2d differ on the timed "
                             "inputs")

    def write():
        scratch.fill_(1.0)

    def read():       # leaves the L2 full of clean lines
        scratch.sum()

    tiny = torch.zeros(64, device=dev)
    pp = {"ms": queued_ms(pp_call, 50),
          "cold_ms": cold_queued_ms(pp_call, 50, write),
          "cold_read_ms": cold_queued_ms(pp_call, 50, read),
          # what the cold method costs a launch that moves nothing
          "cold_launch_ms": cold_queued_ms(lambda: tiny.add_(1.0), 50, write),
          "profiled_ms": device_ms(pp_call, 50, "postproc_",
                                   expect=50),
          "event_ms": cuda_ms(pp_call, 50),
          "plain_ms": cuda_ms(lambda: postprocess_ref(x, ones, zeros, **kw),
                              20),
          "library_ms": queued_ms(pool, 50),
          "library_cold_ms": cold_queued_ms(pool, 50, write),
          "library_cold_read_ms": cold_queued_ms(pool, 50, read),
          "library_profiled_ms": device_ms(pool, 50),
          "library_event_ms": cuda_ms(pool, 50)}
    out_bytes = n_ * (h // 2) * (w // 2) * c * 2        # bf16 output
    pp_bytes = n_ * h * w * c * 4 + out_bytes + 8 * c
    pp_ops = n_ * h * w * c * 3                         # mul, add, max
    pp["bound_ms"] = max(pp_bytes / HBM_BYTES_PER_S,
                         pp_ops / FP32_OPS_PER_S) * 1e3
    pp["bound_by"] = "bytes" if pp_bytes / HBM_BYTES_PER_S >= \
        pp_ops / FP32_OPS_PER_S else "operations"
    print(f"postproc {n_}x{h}x{w}x{c} pool 2, fp32 -> bf16: kernel "
          f"{pp['ms']:.4f} ms of device time warm, {pp['cold_ms']:.4f} cold "
          f"({pp['cold_read_ms']:.4f} after a read sweep) (profiler, warm: "
          f"{ms_or_not(pp['profiled_ms'])}; events, wrapper-paced, "
          f"{pp['event_ms']:.4f}), plain {pp['plain_ms']:.4f} ms, max_pool2d "
          f"{pp['library_ms']:.4f} ms warm, {pp['library_cold_ms']:.4f} cold "
          f"({pp['library_cold_read_ms']:.4f}) (profiler "
          f"{ms_or_not(pp['library_profiled_ms'])}; events "
          f"{pp['library_event_ms']:.4f}), bound {pp['bound_ms']:.4f} ms "
          f"({pp['bound_by']}); a 64-element add takes "
          f"{pp['cold_launch_ms']:.4f} ms cold")
    share = pp["bound_ms"] / pp["cold_ms"]
    warm = "under the HBM bound (its input is read from L2)" \
        if pp["ms"] < pp["bound_ms"] \
        else f"{pp['bound_ms'] / pp['ms']:.1%} of the bound"
    print(f"  cold L2 (after a write sweep): {share:.1%} of the bound; warm "
          f"L2: {warm}")
    plan = pp_kernel.launch_plan(n_, h, w, c, 2, 4, torch.cuda.
                                 get_device_properties(dev).
                                 multi_processor_count)
    pp["plan"] = dataclasses.asdict(plan)
    print(f"  launch plan: {pp['plan']}")
    pp["ptxas"] = check_ptxas("postproc", ("postproc_ring_kernel",
                                           "postproc_direct_kernel"), 12)
    return pp


def device_split(fn, kinds=None, ranges=()) -> dict:
    """Wall time of ``fn`` and the device time of the kernels it
    launches, by kind (name -> substring of the kernel's name), from a
    torch.profiler trace (ms; the wall time includes the profiler's own
    cost).  ``ranges`` may hold ``"moe"``: every MoE layer runs inside a
    ``record_function`` range of that name, and ``split["moe"]`` is the
    device time of the kernels launched inside them (a part of the
    other kernels' time; None where the trace linked none)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import moe

    apply_moe = moe.apply_moe

    def ranged(*args, **kw):
        with record_function("moe"):
            return apply_moe(*args, **kw)

    if "moe" in ranges:
        moe.apply_moe = ranged
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        moe.apply_moe = apply_moe
    kinds = kinds or {"convcore": "convcore_",
                      "postproc": "postproc_"}
    split = {"wall_ms": wall * 1e3, "other": 0.0, **{k: 0.0 for k in kinds}}
    for name in ranges:
        split[name] = 0.0
    for e in prof.events():
        if e.name in ranges:
            # the CPU range sums its kernels; its GPU annotation (a
            # device event spanning them) is no kernel
            if e.device_type == torch.autograd.DeviceType.CPU:
                split[e.name] += e.device_time_total / 1e3
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            kind = next((k for k, sub in kinds.items() if sub in e.name),
                        "other")
            split[kind] += e.device_time_total / 1e3
    for name in ranges:
        split[name] = split[name] or None
    return split


def where_time_goes(dev) -> dict:
    """Device busy time against wall time for a frame's 75 convs through
    ``conv2d_int8`` and for the simulated frame's segment-lane replay."""
    from repro_torch.core.soc import run_yolov3
    from repro_torch.kernels.convcore import conv2d_int8

    phase("where the time goes (torch.profiler)")
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = [(l, *frame_inputs(l, gen, dev)) for l in frame_layers()]

    def frame():
        for l, x, w, scale, bias in inputs:
            conv2d_int8(x, w, scale, bias, stride=l.stride,
                        padding=l.ksize // 2, relu=True,
                        out_dtype=torch.float32)

    frame()
    out = {"frame_convs": device_split(frame),
           "simulated_frame": device_split(
               lambda: run_yolov3(mode="simulated", device=dev))}
    for name, split in out.items():
        busy = split["convcore"] + split["postproc"] + split["other"]
        if busy == 0.0:
            print(f"{name}: wall {split['wall_ms']:.2f} ms, device time "
                  "not measured (no device events in the trace)")
            continue
        print(f"{name}: wall {split['wall_ms']:.2f} ms, device busy "
              f"{busy:.3f} ms ({busy / split['wall_ms']:.1%}): convcore "
              f"kernels {split['convcore']:.3f}, postproc "
              f"{split['postproc']:.3f}, other kernels (for the frame: "
              f"conv2d_int8's im2col, padding and weight copies) "
              f"{split['other']:.3f} ms")
    return out


# --------------------------------------------------------------------------
# training: the swa backward kernels and qwen2-0.5b at full width
# --------------------------------------------------------------------------
# the swa backward (b, s, hq, hkv, d, window, softcap), each in bf16 and
# fp32: every arch shape time_swa_archs times (SWA_ARCHS), qwen2-0.5b's
# training shape (4 x 1024, 14 query heads over 2 KV heads of 64, full
# causal), a ragged S at every head dim with a band narrower than S, and
# grok's softcap over a band
SWA_TRAIN = (4, 1024, 14, 2, 64, 1024, 0.0)
# a D 128 training shape (granite's and mixtral's heads: 32 over 8 of 128),
# timed beside SWA_TRAIN
SWA_TRAIN_D128 = (4, 1024, 32, 8, 128, 1024, 0.0)
SWA_BWD_CASES = [tuple(v) for v in SWA_ARCHS.values()] + [SWA_TRAIN] \
    + [(2, 200, 4, 2, d, 50, 0.0) for d in (16, 32, 64, 128, 256)] \
    + [(1, 300, 16, 1, 256, 128, 30.0), (2, 333, 48, 8, 128, 100, 30.0)]
# relative to max|grad| of each gradient: fp32 summation order, and the
# gradients' one bf16 rounding (tests/test_torch_swa_bwd.py)
SWA_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the bf16 forward's log-sum-exp against the plain one (absolute): fp32
# sums of up to 5120 terms in another order and exp2 / log2 of the special
# function unit; an error e would scale every P of the row by exp(e)
SWA_LSE_TOL = 1e-3
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 12
TRAIN_FAIL_AT, TRAIN_CKPT_EVERY = 6, 4
TRAIN_TIMED_STEPS = 3
# one bf16 step through the kernels against the same step through
# swa_attention_plain and autograd: the two forwards round differently
# (the tensor-core kernel rounds P to bf16 before P.V, the plain version
# keeps it fp32) and 24 bf16 layers carry the difference into the loss
# and every gradient
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GNORM_RTOL = 5e-2
TRAIN_LEAF_RTOL = 5e-2      # ||g_kernel - g_plain|| / ||g_plain||, per leaf


def swa_bwd_bound(out: dict, b, s, hq, hkv, d, window, itemsize=2):
    """The backward's least time into ``out`` (``bound_ms``,
    ``bound_by``): 10 D FLOP for each in-band pair and query head (q.k,
    dO.v, dS.k, dS.q, P.dO) over the bf16 tensor-core peak, or the bytes
    of q, k, v, o, dO read and dq, dk, dv written over HBM.  Returns
    (FLOPs, bytes)."""
    pairs = sum(min(i + 1, window) for i in range(s))
    flops = 10 * d * pairs * hq * b
    nbytes = itemsize * (4 * b * s * hq * d + 4 * b * s * hkv * d)
    out["bound_ms"] = max(flops / BF16_OPS_PER_S,
                          nbytes / HBM_BYTES_PER_S) * 1e3
    out["bound_by"] = "operations" if flops / BF16_OPS_PER_S >= \
        nbytes / HBM_BYTES_PER_S else "bytes"
    return flops, nbytes


def swa_bwd_rel(got, want) -> float:
    """The largest of |dX - dX_plain| / max|dX_plain| over dq, dk, dv."""
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max().clamp_min(1e-30))
               for g, w in zip(got, want))


def plain_lse(q, k, window, scale, softcap=0.0, block=256):
    """Each row's log-sum-exp of its scaled, capped in-band scores in
    fp32 (B, Hq, S): the plain counterpart of the bf16 forward's lse."""
    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    qf = q.float().reshape(b, s, k.shape[2], g, d)
    kf = k.float()
    pos = torch.arange(s, device=q.device)
    out = []
    for i0 in range(0, s, block):
        i1 = min(i0 + block, s)
        j0 = max(0, i0 - window + 1)
        sc = torch.einsum("blkgd,btkd->bkglt", qf[:, i0:i1], kf[:, j0:i1]) * scale
        if softcap > 0:
            sc = softcap * torch.tanh(sc / softcap)
        qp, kp = pos[i0:i1, None], pos[None, j0:i1]
        sc = torch.where((qp >= kp) & (qp - kp < window), sc, -torch.inf)
        out.append(torch.logsumexp(sc, dim=-1))
    return torch.cat(out, dim=-1).reshape(b, hq, s)


def time_swa_bwd(name, shape, gen, dev) -> dict:
    """The bf16 backward at ``shape`` (full causal, D <= 128: the
    tensor-core route) beside its plain version, its bound and
    scaled_dot_product_attention's backward (``is_causal``, KV heads
    expanded outside the timing); its three kernels' split; and the
    forward with and without its lse, in turns."""
    from repro_torch.kernels.swa import kernel as K
    from repro_torch.kernels.swa import ops

    b, s, hq, hkv, d, window, cap = shape
    q, k, v = swa_inputs(b, s, hq, hkv, d, torch.bfloat16, gen, dev)
    do = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    o, lse = K.swa_attention_kernel(q, k, v, window=window, scale=d ** -0.5,
                                    with_lse=True)

    def kernel():
        return K.swa_attention_bwd_kernel(q, k, v, o, do, window=window,
                                          scale=d ** -0.5, lse=lse)

    def plain():
        return ops.swa_attention_bwd_plain(q, k, v, o, do, window=window)

    qh = q.transpose(1, 2).detach().requires_grad_()
    kh, vh = (x.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
              .contiguous().requires_grad_() for x in (k, v))
    out_lib = torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True)
    do_h = do.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(out_lib, (qh, kh, vh), do_h,
                                   retain_graph=True)

    def forward(with_lse):
        return lambda: K.swa_attention_kernel(q, k, v, window=window,
                                              scale=d ** -0.5,
                                              with_lse=with_lse)

    tm = {"ms": queued_ms(kernel, 10), "event_ms": cuda_ms(kernel, 5),
          "plain_ms": cuda_ms(plain, 3),
          "library_ms": queued_ms(sdpa_bwd, 10),
          "max_abs_err": max(max_err(g, w) for g, w in zip(kernel(), plain())),
          # what writing the lse costs the forward: without, with, without, with
          "forward_ms": [queued_ms(forward(w), 20) for w in (False, True) * 2]}
    flops, nbytes = swa_bwd_bound(tm, b, s, hq, hkv, d, window)
    print(f"swa_bwd {name} b {b} s {s} hq {hq} hkv {hkv} d {d} full causal "
          f"bf16 ({K.bwd_route(q.dtype, d)}): kernels {tm['ms']:.4f} ms of "
          f"device time (events {tm['event_ms']:.4f}), plain "
          f"{tm['plain_ms']:.4f} ms, scaled_dot_product_attention backward "
          f"(is_causal=True) {tm['library_ms']:.4f} ms, bound "
          f"{tm['bound_ms']:.4f} ms ({tm['bound_by']}: {flops / 1e9:.2f} "
          f"GFLOP in band, {nbytes / 1e6:.1f} MB); kernel vs plain max abs "
          f"err {tm['max_abs_err']:.2e}")
    print("  the forward without / with its lse, in turns: " + ", ".join(
        f"{x:.4f}" for x in tm["forward_ms"]) + " ms")
    tm["split_ms"] = {part: device_ms(kernel, 5, f"swa_bwd_{part}", expect=5)
                      for part in ("tc_dq", "tc_dkdv", "reduce")}
    print("  by kernel (profiler): " + ", ".join(
        f"{part} {ms_or_not(ms)}" for part, ms in tm["split_ms"].items())
        + " ms")
    return tm


def check_swa_bwd(dev) -> dict:
    """The swa backward kernels (through ``swa_attention``'s autograd
    Function) against ``swa_attention_bwd_plain`` on the same q, k, v,
    o and dO, at every ``SWA_BWD_CASES`` shape in bf16 and fp32, each by
    the route ``bwd_route`` gives it; the bf16 forward's log-sum-exp
    against the plain one at every bf16 case on the tensor-core route;
    two bf16 backward launches at ``SWA_TRAIN`` bit-equal; then the bf16
    backward timed at ``SWA_TRAIN`` and ``SWA_TRAIN_D128`` beside the
    plain backward, its bound and SDPA's backward, and the new kernels'
    ptxas report, which must show no spills."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.swa import kernel as K
    from repro_torch.kernels.swa import ops

    phase("swa backward against its plain version")
    print("  dynamic shared memory by D: " + ", ".join(
        f"{dim}: {K.bwd_smem_bytes(dim)}" for dim in K.HEAD_DIMS))
    gen = torch.Generator(device=dev).manual_seed(6)
    worst_rel, worst_abs, worst_lse = 0.0, 0.0, 0.0
    before = K.bwd_launches
    routes = dict(K.bwd_launches_by_path)
    want_routes = {"tc": 0, "fma": 0}
    for b, s, hq, hkv, d, window, cap in SWA_BWD_CASES:
        for dtype in DTYPES:
            route = K.bwd_route(dtype, d)
            want_routes[route] += 1
            q, k, v = swa_inputs(b, s, hq, hkv, d, dtype, gen, dev)
            do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = ops.swa_attention(*leaves, window=window, softcap=cap)
            got = torch.autograd.grad(o, leaves, do)
            want = ops.swa_attention_bwd_plain(q, k, v, o.detach(), do,
                                               window=window, softcap=cap)
            torch.cuda.synchronize()
            rel = swa_bwd_rel(got, want)
            err = max(max_err(g, w) for g, w in zip(got, want))
            lse_note = ""
            if route == "tc":
                _, lse = K.swa_attention_kernel(q, k, v, window=window,
                                                scale=d ** -0.5, softcap=cap,
                                                with_lse=True)
                lse_err = max_err(lse, plain_lse(q, k, window, d ** -0.5, cap))
                worst_lse = max(worst_lse, lse_err)
                lse_note = f"; forward lse max abs err {lse_err:.2e}"
                if lse_err > SWA_LSE_TOL:
                    raise AssertionError(f"swa forward lse off by {lse_err:.3e}"
                                         f" at {(b, s, hq, hkv, d, window, cap)}")
            print(f"  swa_bwd b {b} s {s} hq {hq} hkv {hkv} d {d} window "
                  f"{window} softcap {cap:g} {str(dtype)[6:]} ({route}): max "
                  f"err {rel:.2e} of max|grad| ({err:.2e} abs){lse_note}")
            if rel > SWA_BWD_TOL[dtype]:
                raise AssertionError(f"swa_bwd off by {rel:.3e} of max|grad| "
                                     f"at {(b, s, hq, hkv, d, window, cap)} "
                                     f"{dtype}")
            worst_rel = max(worst_rel, rel)
            worst_abs = max(worst_abs, err)
            del q, k, v, do, leaves, o, got, want
    n = 2 * len(SWA_BWD_CASES)
    ran = {r: K.bwd_launches_by_path[r] - routes[r] for r in routes}
    if K.bwd_launches - before != n or ran != want_routes:
        raise AssertionError(f"swa_bwd launched {K.bwd_launches - before} "
                             f"times ({ran}) for {n} checks ({want_routes})")

    # no atomics: two launches on the same inputs are bit-equal
    b, s, hq, hkv, d, window, cap = SWA_TRAIN
    q, k, v = swa_inputs(b, s, hq, hkv, d, torch.bfloat16, gen, dev)
    do = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    o, lse = K.swa_attention_kernel(q, k, v, window=window, scale=d ** -0.5,
                                    with_lse=True)
    runs = [K.swa_attention_bwd_kernel(q, k, v, o, do, window=window,
                                       scale=d ** -0.5, lse=lse)
            for _ in range(2)]
    same = all(torch.equal(x, y) for x, y in zip(*runs))
    print(f"  swa_bwd at the training shape, two bf16 launches bit-equal: "
          f"{same}")
    if not same:
        raise AssertionError("swa_bwd: two launches on the same inputs differ")
    del q, k, v, do, o, lse, runs

    tm = time_swa_bwd("qwen2-0.5b training shape", SWA_TRAIN, gen, dev)
    tm["d128"] = time_swa_bwd("D 128 training shape", SWA_TRAIN_D128, gen,
                              dev)
    tm["max_abs_err"] = max(worst_abs, tm["max_abs_err"],
                            tm["d128"]["max_abs_err"])
    tm["max_rel_err"] = worst_rel
    tm["lse_max_abs_err"] = worst_lse
    tm["deterministic"] = same
    tm["ptxas"] = check_ptxas(
        "swa_bwd", ("swa_bwd_tc", "swa_bwd_reduce"), 2 * 4 + 1,
        " at launch (setmaxnreg: producer 24, consumers 240; the reduce 256 "
        "threads)")
    fma = ptxas_report(_build.report("swa_bwd"), "swa_bwd_d")
    for name, rec in sorted(fma.items()):
        print(f"  ptxas {name}: {rec.get('registers')} registers, "
              f"{rec.get('stack')} bytes stack, spill stores "
              f"{rec.get('spill_stores')}, spill loads "
              f"{rec.get('spill_loads')}")
    tm["ptxas"].update(fma)
    return tm


SWA_KINDS = {"swa": ("swa_tc_kernel", "swa_fma_kernel"),
             "swa_bwd": ("swa_bwd_",)}
SSD_KINDS = {"ssd": ("ssd_y_kernel", "ssd_state_kernel"),
             "ssd_bwd": ("ssd_bwd_",)}


def train_step_split(step_fn, state, batch, kinds=SWA_KINDS) -> dict:
    """One train step's wall time and device time by kind from a
    torch.profiler trace (ms): ``kinds``' kernels (kind -> substrings of
    their names; the swa forward and backward by default) and the
    matrix products by kernel name; the cross entropy (its forward
    inside a ``record_function`` range, its backward under autograd's
    Logsumexp/Gather nodes) and the optimizer (a range around
    ``adamw_update``) by range (the CPU range sums its kernels; its GPU
    annotation is no kernel and is left out); ``other`` the rest; the
    count of device events; and the ten kernels (by name) that took the
    most device time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import layers
    from repro_torch.train import step as step_mod

    ce, update = layers.cross_entropy, step_mod.adamw_update

    def ranged(name, fn):
        def wrapped(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return wrapped

    layers.cross_entropy = ranged("cross_entropy", ce)
    step_mod.adamw_update = ranged("optimizer", update)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, metrics = step_fn(state, batch)
            float(metrics["loss"])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        layers.cross_entropy, step_mod.adamw_update = ce, update
    kernels = {**kinds,
               "matmul": ("gemm", "nvjet", "xmma", "cutlass", "sm90_")}
    # CPU events by exact name: the two ranges, and autograd's node for
    # each of the cross entropy's backward ops (one level only: the
    # node's own op event sums the same kernels again)
    node = "autograd::engine::evaluate_function: "
    ranges = {"cross_entropy": ("cross_entropy", node + "LogsumexpBackward0",
                                node + "GatherBackward0"),
              "optimizer": ("optimizer",)}
    split = {"wall_ms": wall * 1e3, "device_ms": 0.0, "launches": 0,
             **{k: 0.0 for k in (*kernels, *ranges)}}
    by_name: dict = {}
    for e in prof.events():
        kind = next((k for k, names in ranges.items() if e.name in names),
                    None)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if kind:
                continue    # a range's GPU annotation, no kernel
            split["device_ms"] += e.device_time_total / 1e3
            split["launches"] += 1
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
            kind = next((k for k, subs in kernels.items()
                         if any(sub in e.name for sub in subs)), None)
            if kind:
                split[kind] += e.device_time_total / 1e3
        elif kind:
            split[kind] += e.device_time_total / 1e3
    split["other"] = split["device_ms"] - sum(
        split[k] for k in (*kernels, *ranges))
    split["top_kernels"] = sorted(
        ((name[:100], ms, n) for name, (ms, n) in by_name.items()),
        key=lambda t: -t[1])[:10]
    return split


def train_path(dev) -> tuple[dict, dict]:
    """qwen2-0.5b at full width and depth (24 layers, d_model 896, 14
    query heads over 2 KV heads of 64, d_ff 4864, vocab 151,936 tied;
    fp32 parameters and moments, bf16 compute, layer remat) trained
    through ``repro_torch.train.loop.train``: global batch 4 x 1024
    tokens, AdamW (lr 3e-3, warmup 5, decay 100), 12 steps, an async
    checkpoint every 4 and a failure injected at step 6; then an
    unbroken 12-step run, whose losses the resumed steps must equal.
    The swa backward kernel must run once a layer a step, and neither
    run may reach the plain attention.  Then three timed steps, one
    profiled step's device-time split, and one step through the kernels
    against the same step through ``swa_attention_plain`` and autograd
    (loss, grad norm, every gradient leaf).  Checkpoints go to
    ``build/train_ckpt`` (git-ignored, never copied back) and are removed
    at the end.  Returns ({"swa": forward launches, "swa_bwd": backward
    launches} of the two runs, the record)."""
    import shutil

    from repro_torch.checkpoint import latest_step
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.kernels.swa import kernel as K
    from repro_torch.kernels.swa import ops
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.step import grads_of, make_train_step
    from repro_torch.types import global_norm, tree_leaves

    cfg = get_config(TRAIN_ARCH)
    b, s, steps = TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS
    phase(f"train_path: {TRAIN_ARCH} at full width ({cfg.num_layers} "
          f"layers, remat {cfg.remat}, {cfg.dtype} compute), batch {b} x "
          f"{s}, {steps} AdamW steps, a failure at step {TRAIN_FAIL_AT}")
    t_phase = time.perf_counter()
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=100)
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    plain_calls = [0]
    fwd_plain, bwd_plain = ops.swa_attention_plain, ops.swa_attention_bwd_plain

    def counted(fn):
        def wrapped(*args, **kw):
            plain_calls[0] += 1
            return fn(*args, **kw)
        return wrapped

    def run(name, every, hook):
        loop_cfg = LoopConfig(total_steps=steps, checkpoint_every=every,
                              checkpoint_dir=str(ckpt / name), keep=2,
                              async_save=True, log_every=1)
        t0 = time.perf_counter()
        res = train(cfg, opt, loop_cfg, global_batch=b, seq_len=s,
                    failure_hook=hook, device=dev,
                    log=lambda line: print(f"  [{name}] {line}"))
        return res, time.perf_counter() - t0

    armed = [True]

    def failure_hook(step):
        if step == TRAIN_FAIL_AT and armed[0]:
            armed[0] = False
            raise RuntimeError(f"injected node failure at step {step}")

    torch.cuda.reset_peak_memory_stats()
    ops.swa_attention_plain = counted(fwd_plain)
    ops.swa_attention_bwd_plain = counted(bwd_plain)
    tc_before = K.bwd_launches_by_path["tc"]
    try:
        K.launches, K.bwd_launches = 0, 0
        broken, broken_s = run("broken", TRAIN_CKPT_EVERY, failure_hook)
        launches = {"swa": K.launches, "swa_bwd": K.bwd_launches}
        last = latest_step(str(ckpt / "broken"))
        K.launches, K.bwd_launches = 0, 0
        whole, whole_s = run("whole", 10 * steps, None)
        launches["swa"] += K.launches
        launches["swa_bwd"] += K.bwd_launches
        tc_runs = K.bwd_launches_by_path["tc"] - tc_before
    finally:
        ops.swa_attention_plain = fwd_plain
        ops.swa_attention_bwd_plain = bwd_plain
        shutil.rmtree(ckpt, ignore_errors=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ran = len(broken.losses) + len(whole.losses)
    print(f"  broken run {broken_s:.1f} s ({len(broken.losses)} steps, "
          f"{broken.restarts} restart, latest checkpoint {last}), unbroken "
          f"run {whole_s:.1f} s; peak {peak_gb:.1f} GB; swa launches "
          f"{launches['swa']}, swa_bwd launches {launches['swa_bwd']} "
          f"({cfg.num_layers} x {ran} steps; {tc_runs} on the tensor-core "
          f"route); plain attention calls "
          f"{plain_calls[0]}")
    losses = broken.losses
    first, final = np.mean(losses[:4]), np.mean(losses[-4:])
    checks = {
        "every loss finite": all(math.isfinite(x) for x in losses
                                 + whole.losses),
        "losses fall": final < first,
        "one restart, at step 12": broken.restarts == 1
        and int(broken.state.step) == steps and last == steps,
        "resumed losses equal the unbroken run's":
            losses[:TRAIN_FAIL_AT] == whole.losses[:TRAIN_FAIL_AT]
            and losses[TRAIN_FAIL_AT:] == whole.losses[TRAIN_CKPT_EVERY:],
        "swa_bwd once a layer a step, on the tensor cores":
            launches["swa_bwd"] == cfg.num_layers * ran == tc_runs,
        "swa forward twice a layer a step (remat)":
            launches["swa"] == 2 * cfg.num_layers * ran,
        "no plain attention": plain_calls[0] == 0,
    }
    gaps = [abs(a - c) for a, c in zip(losses[TRAIN_FAIL_AT:],
                                       whole.losses[TRAIN_CKPT_EVERY:])]
    print(f"  losses: first 4 mean {first:.4f}, last 4 mean {final:.4f}; "
          f"broken {[round(x, 5) for x in losses]}; resumed vs unbroken "
          f"max gap {max(gaps):.3e}")
    del broken

    # step wall and tokens/s: steps 12.. of the unbroken run's state
    stream = SyntheticStream(cfg, b, s, seed=0, device=dev)
    step_fn = make_train_step(cfg, opt)
    state = whole.state
    walls = []
    for i in range(steps, steps + TRAIN_TIMED_STEPS):
        batch = stream.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[len(walls) // 2]
    split = train_step_split(step_fn, state, stream.batch_at(
        steps + TRAIN_TIMED_STEPS))
    print(f"  step wall {wall * 1e3:.1f} ms (median of "
          f"{TRAIN_TIMED_STEPS}: {[round(w * 1e3, 1) for w in walls]}), "
          f"{b * s / wall:.0f} tokens/s")
    if split["device_ms"]:
        print(f"  profiled step: wall {split['wall_ms']:.1f} ms, device "
              f"{split['device_ms']:.1f} ms in {split['launches']} device "
              "events: " + ", ".join(
                  f"{k} {split[k]:.2f}" for k in (
                      "swa", "swa_bwd", "matmul", "cross_entropy",
                      "optimizer", "other")) + " ms")
        for name, ms, n in split["top_kernels"]:
            print(f"    {ms:8.2f} ms in {n:5d} launches of {name}")
    else:
        print("  profiled step: device time not measured (no device "
              "events in the trace)")

    # one step through the kernels against the plain attention
    params = state.params
    batch = stream.batch_at(0)
    before = K.bwd_launches
    g_k, m_k = grads_of(params, batch, cfg)
    kernel_bwd = K.bwd_launches - before
    swa_attention = ops.swa_attention
    ops.swa_attention = lambda q, k, v, **kw: fwd_plain(q, k, v, **kw)
    try:
        g_p, m_p = grads_of(params, batch, cfg)
    finally:
        ops.swa_attention = swa_attention
    norms = (float(global_norm(g_k)), float(global_norm(g_p)))
    leaf_rel = max(float((a.float() - c.float()).norm()
                         / c.float().norm().clamp_min(1e-30))
                   for a, c in zip(tree_leaves(g_k), tree_leaves(g_p)))
    loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
    print(f"  one step, kernels vs plain attention: loss {loss_k:.6f} vs "
          f"{loss_p:.6f}, grad norm {norms[0]:.5f} vs {norms[1]:.5f}, "
          f"worst leaf ||g_k - g_p|| / ||g_p|| {leaf_rel:.3e} "
          f"({kernel_bwd} swa_bwd launches in the kernel step)")
    checks["comparison step within bf16 tolerances"] = (
        abs(loss_k - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p)
        and abs(norms[0] - norms[1]) <= TRAIN_GNORM_RTOL * norms[1]
        and leaf_rel <= TRAIN_LEAF_RTOL and kernel_bwd == cfg.num_layers)
    unbroken = whole.losses
    del state, whole, params, g_k, g_p
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"  train_path took {phase_s:.1f} s")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train_path: {failed}")
    return launches, {
        "losses": losses, "unbroken_losses": unbroken,
        "restarts": 1, "latest_step": last, "peak_gb": peak_gb,
        "step_wall_ms": wall * 1e3, "step_walls_ms": [w * 1e3 for w in walls],
        "tokens_per_s": b * s / wall, "split": split,
        "compare": {"loss": (loss_k, loss_p), "grad_norm": norms,
                    "worst_leaf_rel": leaf_rel},
        "broken_s": broken_s, "whole_s": whole_s, "phase_s": phase_s}



# --------------------------------------------------------------------------
# training the SSM family: the ssd backward kernels and mamba2-130m
# --------------------------------------------------------------------------
# mamba2-130m's training shape (bb, l, chunk, h, p, n): 4 x 2048 tokens, 32
# chunks of 256, 24 heads of 64, state 128
SSD_TRAIN = (4, 2048, 256, 24, 64, 128)
# relative to max|g| of each gradient, against the plain backward in float64:
# the forward's own 1e-4 (SSD_TOL)
SSD_BWD_TOL = 1e-4
# beyond SSD_SHAPES and the grouped launches, the backward's own edges:
# 3 heads at one ragged chunk of 300 (a head group h does not fill and a
# ragged tile together) and p and n off TMA's 16-byte row strides (the
# 4-byte copy route)
SSD_BWD_EDGES = [(1, 300, 256, 3, 64, 128), (1, 96, 32, 3, 10, 20)]
SSM_TRAIN_ARCH = "mamba2-130m"
# 2048 tokens: Mamba-2's pretraining context (arXiv:2405.21060)
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 4, 2048, 8


def ssd_bwd_rel(got, want) -> list:
    """|g - g_plain| / max|g_plain| of each gradient."""
    return [float((a.double() - w).abs().max()
                  / w.abs().max().clamp_min(1e-300))
            for a, w in zip(got, want)]


def ssd_bwd_operands(shape, gen, dev):
    """The chunked fp32 kernel operands of seeded SSD inputs at ``shape``
    with seeded cotangents: (xc, dtc, cum, bc, cc, gy, gst)."""
    from repro_torch.kernels.ssd import ops

    bb, l, chunk, h, p, n = shape
    chunked = ops._chunked(*ssd_inputs(bb, l, h, p, n, gen, dev), chunk)
    nc, q = chunked[0].shape[1], chunked[0].shape[2]
    gy = torch.randn((bb, nc, q, h, p), generator=gen, device=dev)
    gst = torch.randn((bb, nc, h, n, p), generator=gen, device=dev)
    return (*chunked, gy, gst)


def ssd_bwd_bound(out: dict, cells, q, h, p, n) -> tuple[int, int]:
    """The SSD backward's least time into ``out`` (``bound_ms``,
    ``bound_by``), counted as ``time_ssd`` counts: the causal (l >= s)
    pairs of C.B^T, gC and gB's gCB products (once a cell), of dS = gy
    x^T and S^T gy a head, ~10 FLOP a pair and head for E, S, P, Q, gCB
    and the sums, U = B gst, the state term of gB and r per head, over
    3xTF32's 495 / 3 TFLOP/s; or the bytes of x, dt, cum, B, C, gy, gst
    read and gx, gdt, gcum, gB, gC written over HBM.  Returns (FLOPs,
    bytes)."""
    pairs = q * (q + 1) // 2
    flops = cells * (6 * pairs * n + h * (4 * pairs * p + 10 * pairs
                                          + 4 * q * n * p + 2 * q * p))
    nbytes = 4 * cells * (3 * q * h * p + 4 * q * h + 4 * q * n + h * n * p)
    rate = TF32_OPS_PER_S / 3
    out["bound_ms"] = max(flops / rate, nbytes / HBM_BYTES_PER_S) * 1e3
    out["bound_by"] = "operations" if flops / rate >= \
        nbytes / HBM_BYTES_PER_S else "bytes"
    return flops, nbytes


def time_ssd_bwd(dev) -> dict:
    """The SSD backward at mamba2-130m's training shape (``SSD_TRAIN``)
    beside the plain backward (fp32) and its bound; no PyTorch call
    computes it.  Its five grids' split by the profiler, and the FLOPs
    they issue a cell beside the bound's count."""
    from repro_torch.kernels.ssd import kernel as K
    from repro_torch.kernels.ssd import ref

    gen = torch.Generator(device=dev).manual_seed(41)
    operands = ssd_bwd_operands(SSD_TRAIN, gen, dev)
    xc = operands[0]
    bb, nc, q, h, p = xc.shape
    n = operands[3].shape[-1]

    def kernel():
        return K.ssd_intra_chunk_bwd_kernel(*operands)

    tm = {"ms": queued_ms(kernel, 10), "event_ms": cuda_ms(kernel, 5),
          "plain_ms": cuda_ms(lambda: ref.ssd_intra_chunk_bwd_ref(*operands),
                              3),
          "library_ms": None,
          "profiled_ms": device_ms(kernel, 5, "ssd_bwd_", expect=25)}
    flops, nbytes = ssd_bwd_bound(tm, bb * nc, q, h, p, n)
    tm["split_ms"] = {part: device_ms(kernel, 5, f"ssd_bwd_{part}", expect=5)
                      for part in ("cb", "ds", "dx", "bc", "reduce")}
    tm["issued_flops_a_cell"] = K.bwd_issued_flops(q, h, p, n)
    tm["bound_flops_a_cell"] = flops // (bb * nc)
    print(f"ssd_bwd {bb}x{nc} chunks of {q}, h {h}, p {p}, n {n}: kernels "
          f"{tm['ms']:.4f} ms of device time (events {tm['event_ms']:.4f}, "
          f"profiler {ms_or_not(tm['profiled_ms'])}), plain "
          f"{tm['plain_ms']:.4f} ms, no library call computes it, bound "
          f"{tm['bound_ms']:.4f} ms ({tm['bound_by']}: {flops / 1e9:.2f} GFLOP "
          f"causal at {TF32_OPS_PER_S / 3e12:.0f} TFLOP/s (3xTF32), "
          f"{nbytes / 1e6:.1f} MB)")
    print("  by kernel (profiler): " + ", ".join(
        f"{part} {ms_or_not(ms)}" for part, ms in tm["split_ms"].items())
        + " ms")
    print(f"  FLOPs issued a cell: {tm['issued_flops_a_cell'] / 1e6:.1f} M "
          f"(whole 64 x 64 tiles, p and n padded to 64) against the bound's "
          f"{tm['bound_flops_a_cell'] / 1e6:.1f} M")
    return tm


def check_ssd_bwd(dev) -> dict:
    """The SSD backward kernels against ``ssd_intra_chunk_bwd_ref`` in
    float64 on the same operands and cotangents, each of the five
    gradients within ``SSD_BWD_TOL`` of its max|g|: at every
    ``SSD_SHAPES`` case, a group's launch at ``SSD_GROUPS`` groups (h / g
    heads), ``SSD_BWD_EDGES`` and the training shape ``SSD_TRAIN`` through
    the wrapper;
    with ``SSD_GROUPS`` groups through the op's autograd Function (one
    backward launch a group; the gradients of x, dt, A, B and C against
    the plain op's); two launches at the training shape bit-equal; then
    the backward timed, and its ptxas report, which must show no
    spills."""
    from repro_torch.kernels.ssd import kernel as K
    from repro_torch.kernels.ssd import ops, ref

    phase("ssd backward against its plain version in float64")
    smem = K.bwd_smem_bytes()
    groups = K.built_head_groups()
    print(f"  dynamic shared memory of each grid (bytes): {smem}; heads a "
          f"ds block, a dx block: {groups}")
    if groups[0] != K.BWD_HEAD_GROUP:
        raise AssertionError("ssd_bwd: the built ds head group is not the "
                             "one the wrapper sizes the scratch by")
    gen = torch.Generator(device=dev).manual_seed(40)
    worst_rel, worst_abs = 0.0, 0.0
    # a group's launch of grouped SSD is the kernel over its h / g heads
    bb, l, chunk, h, p, n = SSD_SHAPES[3]
    group_shapes = [(bb, l, chunk, h // g, p, n) for g in SSD_GROUPS]
    for shape in [*SSD_SHAPES, *group_shapes, *SSD_BWD_EDGES, SSD_TRAIN]:
        operands = ssd_bwd_operands(shape, gen, dev)
        got = K.ssd_intra_chunk_bwd_kernel(*operands)
        want = ref.ssd_intra_chunk_bwd_ref(*(t.double() for t in operands))
        torch.cuda.synchronize()
        rel = ssd_bwd_rel(got, want)
        err = max(max_err(a, w) for a, w in zip(got, want))
        print(f"  ssd_bwd bb {shape[0]} l {shape[1]} q "
              f"{operands[0].shape[2]} h {shape[3]} p {shape[4]} n "
              f"{shape[5]}: max err / max|g| gx {rel[0]:.2e}, gdt "
              f"{rel[1]:.2e}, gcum {rel[2]:.2e}, gB {rel[3]:.2e}, gC "
              f"{rel[4]:.2e} ({err:.2e} abs)")
        if max(rel) > SSD_BWD_TOL or not all(
                bool(torch.isfinite(a).all()) for a in got):
            raise AssertionError(f"ssd_bwd off by {rel} of max|g| at {shape}")
        worst_rel, worst_abs = max(worst_rel, *rel), max(worst_abs, err)
        del operands, got, want
    for g in SSD_GROUPS:
        args = ssd_inputs(bb, l, h, p, n, gen, dev, groups=g)
        gy = torch.randn((bb, l // chunk, chunk, h, p), generator=gen,
                         device=dev)
        gst = torch.randn((bb, l // chunk, h, n, p), generator=gen,
                          device=dev)

        def grads(op):
            leaves = [t.detach().clone().requires_grad_() for t in args]
            y, states, _ = op(*leaves, chunk=chunk)
            return torch.autograd.grad((y * gy).sum() + (states * gst).sum(),
                                       leaves)

        before = K.bwd_launches
        got = grads(ops.ssd_intra_chunk)
        launched = K.bwd_launches - before
        want = grads(ops.ssd_intra_chunk_plain)
        torch.cuda.synchronize()
        rel = ssd_bwd_rel(got, want)
        print(f"  ssd_bwd bb {bb} l {l} h {h} p {p} n {n}, {g} groups "
              f"({launched} launches) through the op against the plain op "
              f"(fp32): max err / max|g| x {rel[0]:.2e}, dt {rel[1]:.2e}, A "
              f"{rel[2]:.2e}, B {rel[3]:.2e}, C {rel[4]:.2e}")
        if launched != g or max(rel) > SSD_BWD_TOL:
            raise AssertionError(f"grouped ssd_bwd: {launched} launches for "
                                 f"{g} groups, off by {rel}")

    # no atomics: two launches on the same inputs are bit-equal
    operands = ssd_bwd_operands(SSD_TRAIN, gen, dev)
    runs = [K.ssd_intra_chunk_bwd_kernel(*operands) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"  ssd_bwd at the training shape, two launches bit-equal: {same}")
    if not same:
        raise AssertionError("ssd_bwd: two launches on the same inputs differ")
    del operands, runs

    tm = time_ssd_bwd(dev)
    tm["max_abs_err"] = worst_abs
    tm["max_rel_err"] = worst_rel
    tm["deterministic"] = same
    tm["smem_bytes"] = smem
    tm["ptxas"] = check_ptxas("ssd_bwd", ("ssd_bwd_",), 5)
    return tm



def train_ssm_path(dev) -> tuple[dict, dict]:
    """mamba2-130m at full width and depth (24 layers, d_model 768,
    d_inner 1536, 24 SSM heads of 64, state 128, chunk 256, vocab 50,280
    tied; fp32 parameters and moments, bf16 compute, layer remat) trained
    through ``repro_torch.train.loop.train``: global batch 4 x 2048
    tokens from the synthetic stream, AdamW (lr 3e-3, warmup 5, decay
    100), 8 steps, no checkpoints (``train_path`` covers the store).
    Losses finite; each step launches the ssd forward twice a layer
    (remat) and its backward once, and never reaches the plain SSD or
    its plain backward.  Then three timed steps, one profiled step's
    device-time split, and one step through the kernels against the same
    step through ``ssd_intra_chunk_plain`` and its plain backward, in
    fp32 compute (loss, grad norm, every gradient leaf) and in bf16
    (loss, grad norm; the worst leaf reported), and in bf16 against the
    same step with the forward kernel and the plain backward (grad norm,
    every leaf).  Returns ({"ssd": forward launches, "ssd_bwd": backward
    launches}, the record)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import SyntheticStream
    from repro_torch.kernels.ssd import kernel as K
    from repro_torch.kernels.ssd import ops, ref
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.step import grads_of, make_train_step
    from repro_torch.types import global_norm, tree_leaves

    cfg = get_config(SSM_TRAIN_ARCH)
    b, s, steps = SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS
    phase(f"train_ssm_path: {SSM_TRAIN_ARCH} at full width ({cfg.num_layers} "
          f"layers, remat {cfg.remat}, {cfg.dtype} compute), batch {b} x {s}, "
          f"{steps} AdamW steps")
    t_phase = time.perf_counter()
    opt = AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=100)
    ckpt = ROOT / "build" / "train_ssm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    plain_calls = [0]
    fwd_plain, bwd_plain = ref.ssd_intra_chunk_ref, ref.ssd_intra_chunk_bwd_ref

    def counted(fn):
        def wrapped(*args, **kw):
            plain_calls[0] += 1
            return fn(*args, **kw)
        return wrapped

    loop_cfg = LoopConfig(total_steps=steps, checkpoint_every=10 * steps,
                          checkpoint_dir=str(ckpt), async_save=False,
                          log_every=1)
    torch.cuda.reset_peak_memory_stats()
    ref.ssd_intra_chunk_ref = counted(fwd_plain)
    ref.ssd_intra_chunk_bwd_ref = counted(bwd_plain)
    try:
        K.launches, K.bwd_launches = 0, 0
        t0 = time.perf_counter()
        res = train(cfg, opt, loop_cfg, global_batch=b, seq_len=s,
                    device=dev, log=lambda line: print(f"  {line}"))
        run_s = time.perf_counter() - t0
        launches = {"ssd": K.launches, "ssd_bwd": K.bwd_launches}
    finally:
        ref.ssd_intra_chunk_ref, ref.ssd_intra_chunk_bwd_ref = \
            fwd_plain, bwd_plain
        shutil.rmtree(ckpt, ignore_errors=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = res.losses
    print(f"  {steps} steps in {run_s:.1f} s (init included); peak "
          f"{peak_gb:.1f} GB; ssd launches {launches['ssd']}, ssd_bwd "
          f"launches {launches['ssd_bwd']} ({cfg.num_layers} layers x "
          f"{len(losses)} steps); plain SSD calls {plain_calls[0]}; losses "
          f"{[round(x, 5) for x in losses]}")
    checks = {
        "every loss finite": len(losses) == steps
        and all(math.isfinite(x) for x in losses),
        "ssd_bwd once a layer a step":
            launches["ssd_bwd"] == cfg.num_layers * steps,
        "ssd forward twice a layer a step (remat)":
            launches["ssd"] == 2 * cfg.num_layers * steps,
        "no plain SSD": plain_calls[0] == 0,
    }

    # step wall and tokens/s: steps 8.. of the run's state
    stream = SyntheticStream(cfg, b, s, seed=0, device=dev)
    step_fn = make_train_step(cfg, opt)
    state = res.state
    del res
    walls = []
    for i in range(steps, steps + TRAIN_TIMED_STEPS):
        batch = stream.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[len(walls) // 2]
    split = train_step_split(step_fn, state, stream.batch_at(
        steps + TRAIN_TIMED_STEPS), SSD_KINDS)
    print(f"  step wall {wall * 1e3:.1f} ms (median of "
          f"{TRAIN_TIMED_STEPS}: {[round(w * 1e3, 1) for w in walls]}), "
          f"{b * s / wall:.0f} tokens/s")
    if split["device_ms"]:
        print(f"  profiled step: wall {split['wall_ms']:.1f} ms, device "
              f"{split['device_ms']:.1f} ms in {split['launches']} device "
              "events: " + ", ".join(
                  f"{k} {split[k]:.2f}" for k in (
                      "ssd", "ssd_bwd", "matmul", "cross_entropy",
                      "optimizer", "other")) + " ms")
        for name, ms, n in split["top_kernels"]:
            print(f"    {ms:8.2f} ms in {n:5d} launches of {name}")
    else:
        print("  profiled step: device time not measured (no device "
              "events in the trace)")

    # one step through the kernels against the same step through the plain
    # SSD and its plain backward.  In fp32 compute the two differ by the
    # SSD's own ~1e-7 (3xTF32 against fp32 products) and every leaf is
    # held.  In the training's bf16, 24 random-weight layers amplify any
    # such difference of the forward into leaf gaps of 0.05-0.6: the plain
    # SSD in fp32 against itself in float64 differs as much
    # (scripts/ssd_grad_gap.py), so there the loss and grad norm are held
    # against the plain step, and every leaf against the same step with
    # the forward kernel and the plain backward, which isolates the
    # backward kernel
    params = state.params
    batch = stream.batch_at(0)
    ssd_intra_chunk = ops.ssd_intra_chunk
    bwd_kernel = K.ssd_intra_chunk_bwd_kernel

    def kernels(c):
        before = K.bwd_launches
        g, m = grads_of(params, batch, c)
        return g, m, K.bwd_launches - before

    def plain(c):
        ops.ssd_intra_chunk = ops.ssd_intra_chunk_plain
        try:
            return grads_of(params, batch, c)
        finally:
            ops.ssd_intra_chunk = ssd_intra_chunk

    def plain_backward(c):
        K.ssd_intra_chunk_bwd_kernel = bwd_plain
        try:
            return grads_of(params, batch, c)
        finally:
            K.ssd_intra_chunk_bwd_kernel = bwd_kernel

    def gap(c, got, want, against: str) -> dict:
        (g_k, m_k, launched), (g_p, m_p) = got, want
        rels = [float((a.float() - w.float()).norm()
                      / w.float().norm().clamp_min(1e-30))
                for a, w in zip(tree_leaves(g_k), tree_leaves(g_p))]
        worst = max(range(len(rels)), key=rels.__getitem__)
        out = {"loss": (float(m_k["loss"]), float(m_p["loss"])),
               "grad_norm": (float(global_norm(g_k)), float(global_norm(g_p))),
               "worst_leaf_rel": rels[worst],
               "worst_leaf": (worst, tuple(tree_leaves(g_p)[worst].shape)),
               "ssd_bwd_launches": launched}
        print(f"  one {c.dtype} step, kernels vs {against}: loss "
              f"{out['loss'][0]:.6f} vs {out['loss'][1]:.6f}, grad norm "
              f"{out['grad_norm'][0]:.5f} vs {out['grad_norm'][1]:.5f}, worst "
              f"leaf ||g_k - g_p|| / ||g_p|| {rels[worst]:.3e} (leaf {worst} "
              f"of {len(rels)}, {out['worst_leaf'][1]}; {launched} ssd_bwd "
              "launches in the kernel step)")
        return out

    def within(r, loss: bool, leaves: bool) -> bool:
        (lk, lp), (nk, np_) = r["loss"], r["grad_norm"]
        return ((abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp) or not loss)
                and abs(nk - np_) <= TRAIN_GNORM_RTOL * np_
                and (r["worst_leaf_rel"] <= TRAIN_LEAF_RTOL or not leaves)
                and r["ssd_bwd_launches"] == cfg.num_layers)

    c32 = dataclasses.replace(cfg, dtype="float32")
    got = kernels(c32)
    compared = {"float32": gap(c32, got, plain(c32), "plain SSD")}
    got = kernels(cfg)
    compared[cfg.dtype] = gap(cfg, got, plain(cfg), "plain SSD")
    compared[f"{cfg.dtype} backward"] = gap(cfg, got, plain_backward(cfg),
                                            "plain SSD backward")
    del got
    checks["fp32 comparison step: loss, grad norm, every leaf"] = within(
        compared["float32"], True, True)
    checks["bf16 comparison step: loss and grad norm"] = within(
        compared[cfg.dtype], True, False)
    checks["bf16 backward kernel vs plain backward: grad norm, every leaf"] \
        = within(compared[f"{cfg.dtype} backward"], False, True)
    del state, params
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"  train_ssm_path took {phase_s:.1f} s")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train_ssm_path: {failed}")
    return launches, {
        "losses": losses, "peak_gb": peak_gb, "run_s": run_s,
        "step_wall_ms": wall * 1e3, "step_walls_ms": [w * 1e3 for w in walls],
        "tokens_per_s": b * s / wall, "split": split, "compare": compared,
        "phase_s": phase_s}


QUICKSTART_STEPS = 20   # the reference quickstart's training steps


def quickstart_path(dev) -> tuple[dict, dict]:
    """``python -m repro_torch.quickstart`` on the card, part by part:
    the paper numbers equal to ROADMAP's anchors (rounded as
    ``paper_chain`` rounds them), 20 steps of qwen2's reduced config
    through the swa kernels (the backward once a layer a step) with
    finite losses, and its four requests served.  Returns ({"swa":
    forward launches, "swa_bwd": backward launches}, the record)."""
    from repro_torch import quickstart
    from repro_torch.kernels.swa import kernel as K

    phase("quickstart_path: python -m repro_torch.quickstart on the card")
    t0 = time.perf_counter()
    paper = quickstart.paper_experiments()
    got = (round(paper["fps"], 3),
           tuple(round(paper["llc_1mib"][b], 4) for b in (32, 64, 128)),
           round(paper["llc_x4"], 4), round(paper["dram_x4"], 4))
    want = (7.394, (1.0611, 1.3414, 1.5455), 2.0728, 2.4457)
    fwd, bwd = K.launches, K.bwd_launches
    cfg, state, losses = quickstart.train_small_lm(QUICKSTART_STEPS,
                                                   device=dev)
    stats = quickstart.serve_small_lm(cfg, state, device=dev)
    torch.cuda.synchronize()
    launches = {"swa": K.launches - fwd, "swa_bwd": K.bwd_launches - bwd}
    phase_s = time.perf_counter() - t0
    print(f"  paper numbers {got}; swa launches {launches['swa']}, swa_bwd "
          f"launches {launches['swa_bwd']} ({cfg.num_layers} layers x "
          f"{QUICKSTART_STEPS} steps); losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; served {stats.requests} requests / "
          f"{stats.tokens} tokens in {stats.steps} steps; {phase_s:.1f} s")
    checks = {
        "paper numbers equal the anchors": got == want,
        "swa_bwd once a layer a step":
            launches["swa_bwd"] == QUICKSTART_STEPS * cfg.num_layers,
        "every loss finite": all(math.isfinite(x) for x in losses),
        "four requests served": stats.requests == 4,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"quickstart_path: {failed} ({got} vs {want})")
    return launches, {"paper": got, "losses": losses,
                      "served": (stats.requests, stats.tokens, stats.steps),
                      "phase_s": phase_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = setup()
    errs = check_kernels(dev)
    errs["ssd"] = check_ssd(dev)
    errs["swa"] = check_swa(dev)
    timed_bwd = check_swa_bwd(dev)
    timed_ssd_bwd = check_ssd_bwd(dev)
    # the kernels' timings first: after the serving phases' long traces,
    # profiler windows missed kernels more often
    timed, rows = time_kernels(dev)
    timed["ssd"] = time_ssd(dev)
    timed["swa"] = time_swa(dev)
    timed["swa_archs"] = time_swa_archs(dev)
    timed["swa_bwd"] = timed_bwd
    timed["ssd_bwd"] = timed_ssd_bwd
    train_launches, trained = train_path(dev)
    ssm_launches, trained_ssm = train_ssm_path(dev)
    quick_launches, quick = quickstart_path(dev)
    res, launches, main_errs = main_path(dev)
    engine_times = paper_chain(res, dev)
    sim = sim_path(dev)
    campaign = campaign_path(dev)
    serve_launches, serve = serve_path(dev)
    launches["ssd"] = serve_launches["ssd"] + ssm_launches["ssd"]
    launches["ssd_bwd"] = ssm_launches["ssd_bwd"]
    main_errs["ssd"] = serve["ssd_max_abs_err"]
    rg_launches, serve_rg = serve_swa_path(dev, "recurrentgemma-9b")
    farm = farm_path(dev)
    dense_launches, dense = dense_path(dev)
    moe_launches, moe = moe_path(dev)
    encdec_launches, encdec = encdec_path(dev)
    vlm_launches, vlm = vlm_path(dev)
    int8_launches, int8 = int8_kv_path(dev)
    launches["swa"] = rg_launches["swa"] + dense_launches + moe_launches \
        + encdec_launches + vlm_launches + int8_launches \
        + train_launches["swa"] + quick_launches["swa"]
    launches["swa_bwd"] = train_launches["swa_bwd"] \
        + quick_launches["swa_bwd"]
    main_errs["swa"] = max(serve_rg["swa_max_abs_err"],
                           dense["swa_max_abs_err"], moe["swa_max_abs_err"],
                           encdec["swa_max_abs_err"], vlm["swa_max_abs_err"],
                           int8["swa_max_abs_err"])
    errs["swa_bwd"] = main_errs["swa_bwd"] = timed_bwd["max_abs_err"]
    errs["ssd_bwd"] = main_errs["ssd_bwd"] = timed_ssd_bwd["max_abs_err"]
    profiled = where_time_goes(dev)

    meta = {
        "convcore": ("src/repro_torch/csrc/convcore.cu",
                     "src/repro/kernels/convcore/kernel.py:62"),
        "postproc": ("src/repro_torch/csrc/postproc.cu",
                     "src/repro/kernels/postproc/kernel.py:50"),
        "ssd": ("src/repro_torch/csrc/ssd.cu",
                "src/repro/kernels/ssd/kernel.py:60"),
        "swa": ("src/repro_torch/csrc/swa.cu",
                "src/repro/kernels/swa/kernel.py:78"),
        "swa_bwd": ("src/repro_torch/csrc/swa_bwd.cu",
                    "src/repro/models/attention.py:151"),
        "ssd_bwd": ("src/repro_torch/csrc/ssd_bwd.cu",
                    "src/repro/models/ssm.py:67"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        tm = timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs[name], main_errs[name]),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"]})
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms"):
            if not (isinstance(k[key], float) and math.isfinite(k[key])):
                raise AssertionError(f"{k['name']} {key} = {k[key]!r}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "kernels": kernels, "convcore_layers": rows,
         "engine_wall_s": engine_times, "sim_path": sim,
         "campaign_path": campaign, "farm_path": farm,
         "dense_path": dense, "moe_path": moe, "encdec_path": encdec,
         "vlm_path": vlm, "int8_kv_path": int8, "train_path": trained,
         "train_ssm_path": trained_ssm, "quickstart_path": quick,
         "profiled": profiled,
         "timed": timed,
         "serve": serve, "serve_recurrentgemma": serve_rg}, indent=1))
    print(f"\nchip_smoke finished in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
