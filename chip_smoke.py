#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc/` and
holds each against its plain PyTorch version at its path's full-width
shapes, with an empty kernel's launch timed as the floor under them (the
serving kernels also at a long serving shape: 8 slots of a 4096-row cache;
`swiglu` also at 16 to 4096 rows, where its tensor-core tiles run;
`flash_decode` also at starcoder2-3b's 12-head GQA groups), and the two
backward kernels, `rms_norm_bwd` and `swiglu_bwd`, at gemma3-4b's
training rows (`rms_norm_bwd` also at phi3's d = 5120 and qwen's 8192,
`swiglu_bwd`, from the pair its forward keeps, also at twice the rows;
`rms_norm` also at d = 5120 and 8192, where its rows are staged in shared
memory, each row bitwise the strided path's output; `swiglu`,
`flash_decode` and `flash_attention` also at phi3-medium-14b's,
qwen1.5-110b's and paligemma-3b's shapes, the last with its 256-token
image prefix; `flash_attention` and `flash_decode` also at whisper-base's
shapes: its encoder over 1500 frames, its decoder, its cross-attention
from a prompt and from one decode row; `flash_decode` on gemma3-4b's
1024-row ring; `rms_norm` and `rms_norm_bwd` at mamba2-130m's and
zamba2-1.2b's widths, the attention kernels at zamba2's 32 heads of 64;
`flash_decode` and `flash_attention` at dbrx-132b's G = 6 and kimi-k2's
G = 8, `rms_norm`, `rms_norm_bwd`, `swiglu` and `swiglu_bwd` at kimi-k2's
d = 7168 and its shared expert's [., 7168] x [7168, 2048]; the attention
kernels at a microbatch chunk's batch: ViT-B/16's q[16,196,12,64],
starcoder2-3b's q[2,1024,24,128] and q[1,1024,24,128]).
Then it drives both of the port's paths on the card:

* serving: gemma3-4b at full width (random weights drawn on the card from
  a seed) through the continuous-batching loop, the device time of one
  decode step there and at 8 slots x 4096 (a second `service` line, beside
  its bytes floor), the card against the CPU at 2 layers, and a hot weight
  swap; then starcoder2-3b at full width and all 30 layers through the
  same loop and one-shot `generate` (equal tokens), its decode step's
  device time and kernels, and its card against the CPU at 2 layers;
  phi3-medium-14b (untied head) at full width and all 40 layers and
  qwen1.5-110b (QKV bias, random) at full width cut to 2 layers (its 80
  do not fit) through the same loop and `generate`, with their decode
  steps' device times and kernels; paligemma-3b at all 18 layers through
  one-shot `generate` after its 256-token image prefix (prefill against
  decode) and a timed prefill of 4 x (256 + 1024) rows; and the card
  against the CPU for the three (phi3 at 2 layers, qwen at 1, paligemma
  at 2 with the prefix); whisper-base at full width and depth through
  one-shot `generate` after stub frames (prefill against decode, card
  against CPU); gemma3-4b at 6 of its 34 layers through one-shot
  `generate` at `--window 512` (a 1024-row ring cache, 40 decode steps
  past its wrap), its card against the CPU at 2 layers past the wrap;
  mamba2-130m (the ssm family) at full width and all 24 layers through
  the same loop and `generate` (its decode step in a CUDA graph), and
  zamba2-1.2b (the hybrid family) at all 38 layers one-shot, flat and at
  `--window 64` past the wrap (`--slots` refused), each with a timed 4 x
  1024 prefill and its card against the CPU (mamba2 at 2 layers, zamba2
  at 8, flat and through a ring); the MoE family: dbrx-132b at full width
  and 4 of its 40 layers (all 16 experts), kimi-k2-1t at 1 of its 61
  layers with 128 of its 384 experts, each through the same loop and
  `generate` (equal tokens) with a timed 4 x 1024 prefill, and each held
  against the CPU at 1 layer (kimi with 16 experts) with the card's
  plain versions beside the kernels;
* training: ViT-B/16 at full width with Local AdamW under the QSR schedule
  through `train()` (W = 4 workers, 32 images each, 10 rounds), the flat
  layout with the quantized sync for 2 rounds, and the card against the
  CPU at 2 layers;
* the sync variants of that training path at full width, flat layout,
  int8 sync, 2 rounds each: overlap at depth 0 (bitwise the blocking flat
  run) and depth 1 (`synced_view` pure, `flush` clears the pending sync),
  partial participation with the mask [1, 1, 0, 1] (every lane
  re-anchored), and the ring-int8 wire (16 + 12 + 1 launches per sync, the
  card's ring codes equal the CPU's, the mean within `ring_tolerance`);
  and overlap at depth 1 on the card against the CPU at 2 layers;
* the adaptive controller (`--schedule adaptive`) on that path at full
  width: 24 steps through `train()` on the flat int8 overlap sync, the
  controller correcting H by the measured divergence, growing the
  effective batch (`batch_epoch`) and choosing the overlap depth on the
  frontier `train_overlap` measured (a table4-form JSON); its trace
  rebuilt byte for byte by a fresh controller fed the card's telemetry;
  and the card against the CPU at 2 layers, the CPU replaying the card's
  (H, lanes, depth) sequence;
* the LM path: gemma3-4b's one-shot `generate` (prefill through the
  full-sequence attention kernel, then decode) at full width, its tokens
  equal to the `--slots 2` service's, and a timed prefill of 4 x 1024
  tokens; starcoder2-3b Local AdamW under QSR at full width (2 layers, W = 4
  x 4 sequences of 1024 tokens from the built-in token stream, the training
  CLI's recipe, 8 steps), at its full 30 layers (W = 1, remat) for 2 steps,
  and the card against the CPU at 2 layers; gemma3-4b Local AdamW under
  QSR at full width (2 layers, W = 4 x 1 sequence of 1024 tokens, the
  same recipe, 8 steps: every norm and MLP through the `rms_norm` /
  `swiglu` autograd Functions and their backward kernels, and in a
  profiled step one swiglu forward tile and one dW and dX launch a layer
  and lane), and its card against the CPU at 2 layers; the same recipe
  on phi3-medium-14b (W = 2 x 1 x 1024: every norm on the staged rms_norm
  instances, forward and backward) and paligemma-3b (W = 4 x 1 x (256 +
  1024), attention with prefix_len 256), each with its card against the
  CPU at 2 layers; whisper-base at 3 + 3 of its 6 + 6 layers (W = 4 x 8
  x 64) on host and on device data, and its card against the CPU (the
  decoder at 2 layers); starcoder2-3b's path on device data (two engines
  with one seed draw the same batches); mamba2-130m at 12 of its 24
  layers (W = 4 x 4 x 1024) and zamba2-1.2b at 8 layers (W = 4 x 1 x
  1024) through the
  rms_norm backward kernel, each with its card against the CPU;
  kimi-k2-1t at 1 layer and 16 experts (W = 1 x 1 x 1024, remat): the
  MoE backward and its aux loss, held against the card's plain versions
  (its 51.7 GB state has no CPU side); starcoder2-3b's path at
  microbatch 2 and 4 (gradient accumulation: attention at the chunk's
  batch, peak memory below microbatch 1's, one step's loss and gradients
  against microbatch 1 and against the card's plain versions);
* one rank a process (`torch.distributed`): NCCL at world size 1 on the
  card (every collective verb of `launch/mesh.py` on device tensors); the
  sync harness (`launch/multihost.py`, suite mode) on 4 ranks over gloo on
  the one card, beside the same suite on 4 CPU ranks: the verbs at 2 and 4
  ranks with host staging and the int16 ring, then 2x2 dp quantized, with
  outer momentum and split across rounds, 4x1 dp with the membership mask
  1,1,0,1 and on the ring-int8 wire, 2x1x2 fsdp: every rank's chunks equal
  its host path's (the flat sync kernels' bf16 instances on the demo
  params' bf16 bucket), the digests the CPU's; ViT-B/16 at full width on a
  2x2 dp mesh (W = 2 x S = 2, 4 ranks, the quantized flat_sharded sync at
  the int16 auto wire, 2 rounds of H = 2) bitwise, sync by sync, against
  the single-process engine on the card, and on a 4x1 mesh on the ring-int8
  wire (1 round) within `ring_tolerance` of the host ring; per rank: wall
  and event ms a local step, ms a sync, its wire bytes, host staging, peak
  memory; the 2x2 run's state saved as a manifest checkpoint
  (`save_sharded`: a shard file a rank) and restored bitwise by its ranks,
  by the 4x1 ranks at W = 4 (the whole route, one rank at a time) and by
  mesh-less engines at W = 2 and 4, with the seconds, rates and host RSS;
  elastic rounds (`launch/multihost.py run_elastic`: 4 ranks at the
  starcoder2 smoke config, preempt-restore) held to the reference's
  verdicts and tolerances;
* checkpoints: ViT-B/16's W = 4 state saved in the tree layout after 2
  rounds and resumed in the flat layout, bitwise the run without the
  checkpoint, with save and restore rates; and train to serve: starcoder2-3b
  at 1 layer trained with the async observer, which checkpoints and
  publishes the consensus into a directory a live server watches; the
  server swaps it in mid-sequence, and its tokens equal a restart's.  The
  checkpoint directories live under `_ckpt/` and are deleted after.

The training card-vs-CPU gates' CPU sides (their params drawn on the card
at the start, kept on the host) run in order on a background thread from
the start of the run, beside the card's phases; each gate's card side
then waits for what is left of its own (`cpu_wait_s`).

Each path runs with the kernels' launch counters set to 0 just before it
and read just after, and fails unless every kernel of the path ran (a
spawned rank counts its own and reports them).  One
JSON line per phase, each with its `seconds`; the `run` line also carries
the machine's lowest available host memory over the run (sampled every
2 s).  Any mismatch or error raises, so the exit code is not 0.  The last
line is `{"ok": true, "device": {...}}`.

Imports nothing of JAX or of the JAX package.  Needs one CUDA card; without
one (or without the rest of the repository beside it) it exits non-zero
before printing a result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data sheet (the published peaks the bounds are computed against)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12          # fp32 outside the tensor cores
PEAK_TF32_FLOP_PER_S = 495e12         # dense TF32 on the tensor cores
# the attention kernels' times before they moved onto the tensor cores (fp32
# FMAs on the CUDA cores), from this script on an NVIDIA H100 80GB HBM3 at
# 700 W, ViT-B/16's [32,196,12,64]: printed beside this run's for comparison
CUDA_CORE_MS = {"flash_attention_fwd": 0.2834, "flash_attention_bwd": 0.9132}
# host seconds kept between a profile's capture window and the profiled
# work at either end (see `profile_device_ms`)
PROFILE_MARGIN_S = 0.05
ARCH = "gemma3-4b"
SLOTS, MAX_NEW = 2, 16
# the long serving shape: 8 slots of a 4096-row cache, slot s at position
# (s+1) 512 - 1 (a decode batch of staggered long requests)
LONG_SLOTS, LONG_LEN = 8, 4096
LONG_POS = [(s + 1) * 512 - 1 for s in range(LONG_SLOTS)]
PROMPT_LENS = (16, 48, 32, 24)        # 4 requests, 16-48 tokens: slots recycle
# tolerances x max(|plain|, 1): fp32 sums in another order (the attention
# gradients go through two more contractions); AdamW's bias-correction pow
# may differ by an ulp; the quantized sync is held bitwise
# (the unquantized sync sums fp32 deltas in another order: 1e-6, and is
# held bitwise against its ops in lane order); the
# split sync's apply and the ring's combine and quantize are held bitwise;
# rms_norm_bwd's dx like the forward (a row's sums over D in another
# order), its dscale, a sum over the n rows, to the worst case of two
# n-term fp32 sums in different orders, 2 n 2^-24 of the largest column
# sum of |dy x r| (`dscale_tol`); swiglu_bwd's gradients like the products
# (3xTF32 sums over N or 2F against fp32 ones, from the same pair; end to
# end, and the pair against the plain forward's, within 2e-5 too)
TOL = {"rms_norm": 1e-5, "swiglu": 2e-5, "rms_norm_bwd": 1e-5,
       "swiglu_bwd": 2e-5, "flash_decode": 2e-5,
       "flash_attention_fwd": 2e-5, "flash_attention_bwd": 5e-5,
       "adamw_update": 1e-6, "sync_flat_update": 1e-6,
       "sync_apply_update": 0.0, "ring_combine": 0.0, "ring_quantize": 0.0}
REPLACES = {
    "rms_norm": "src/repro/kernels/rmsnorm.py:36",
    "swiglu": "src/repro/kernels/swiglu.py:44",
    "rms_norm_bwd": "the port's own: JAX has none",
    "swiglu_bwd": "the port's own: JAX has none",
    "flash_decode": "src/repro/kernels/flash_attention.py:239",
    "flash_attention_fwd": "src/repro/kernels/flash_attention.py:128",
    "flash_attention_bwd": "src/repro/kernels/flash_attention.py:128",
    "adamw_update": "src/repro/kernels/adamw_update.py:57",
    "sync_flat_update": "src/repro/kernels/sync_update.py:87",
    "sync_apply_update": "src/repro/kernels/sync_update.py:147",
    "ring_combine": "src/repro/kernels/sync_update.py:186",
    "ring_quantize": "src/repro/kernels/sync_update.py:212",
}
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "rms_norm": CSRC + "rmsnorm.cu",
    "swiglu": CSRC + "swiglu.cu",
    "rms_norm_bwd": CSRC + "rmsnorm_bwd.cu",
    "swiglu_bwd": CSRC + "swiglu.cu",
    "flash_decode": CSRC + "flash_decode.cu",
    "flash_attention_fwd": CSRC + "flash_attention.cu",
    "flash_attention_bwd": CSRC + "flash_attention.cu",
    "adamw_update": CSRC + "adamw_update.cu",
    "sync_flat_update": CSRC + "sync_update.cu",
    "sync_apply_update": CSRC + "sync_update.cu",
    "ring_combine": CSRC + "ring.cu",
    "ring_quantize": CSRC + "ring.cu",
}
SERVING_KERNELS = ("flash_decode", "rms_norm", "swiglu")
TRAINING_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
                    "adamw_update", "sync_flat_update")
SYNC_KERNELS = ("sync_apply_update", "ring_combine", "ring_quantize")
BACKWARD_KERNELS = ("rms_norm_bwd", "swiglu_bwd")

# the training main path: examples/vit_local_adamw.py's recipe at full width
TRAIN_ARCH = "vit-b16"
W, B_LOC, IMAGE = 4, 32, 224
TRAIN_RUN = dict(schedule="qsr", optimizer="adamw", total_steps=24,
                 warmup_steps=2, peak_lr=6e-3, end_lr=1e-5, h_base=2,
                 alpha=3.5e-3, weight_decay=0.01, remat=False)
QSR_TRACE = [(t, 2) for t in range(0, 16, 2)] + [(16, 3), (19, 5)]
VIT_PARAMS = 86_332_648

# the LM training path: the training CLI's recipe (launch/train.py main:
# peak lr 3e-3, alpha 0.002, H_base 2, warmup max(steps // 20, 1), remat
# off) on starcoder2-3b at full width, cut to 2 layers, on the engine's
# built-in token stream
LM_ARCH = "starcoder2-3b"
LM_W, LM_B, LM_SEQ, LM_LAYERS, LM_STEPS = 4, 4, 1024, 2, 8
LM_RUN = dict(schedule="qsr", optimizer="adamw", total_steps=LM_STEPS,
              peak_lr=3e-3, alpha=0.002, h_base=2,
              warmup_steps=max(LM_STEPS // 20, 1), remat=False)
LM_TRACE = [(t, 2) for t in range(0, LM_STEPS, 2)]
LM_PARAMS = {1: 246_958_080, 2: 342_915_072, 30: 3_029_710_848}
LM_LEAVES = 13                  # tree leaves: the AdamW launches per step
# gemma3-4b training: the same recipe at full width cut to 2 layers, W = 4
# workers x 1 sequence of 1024 tokens: 55.0 GB of params, m, v and grad,
# a 65.8 GB peak (PERF.md)
G3_ARCH = "gemma3-4b"
G3_W, G3_B, G3_SEQ, G3_LAYERS = 4, 1, 1024, 2
G3_PARAMS, G3_LEAVES = 859_845_120, 11
# the backward kernels' rows: one lane's 1 x 1024 tokens of gemma3-4b;
# rms_norm_bwd also at phi3-medium-14b's and qwen1.5-110b's widths
BWD_ROWS = G3_B * G3_SEQ
PHI3_D, QWEN_D = 5120, 8192
# phi3-medium-14b (an untied head), qwen1.5-110b (QKV bias) and
# paligemma-3b (a bidirectional prefix of 256 stub image tokens): served
# at full width (phi3 and paligemma at full depth, qwen at 2 layers: its
# 80 layers are 444.8 GB of fp32 weights), held against the CPU, and
# trained at 2 layers with the LM recipe; parameters by depth
PHI3_ARCH, QWEN_ARCH, VLM_ARCH = "phi3-medium-14b", "qwen1.5-110b", "paligemma-3b"
PHI3_PARAMS = {2: 1_709_204_480, 40: 14_659_507_200}
QWEN_PARAMS = {1: 3_850_405_888, 2: 5_209_387_008, 80: 111_209_914_368}
VLM_PARAMS = {2: 746_989_568, 18: 2_508_662_784}
QWEN_SERVE_LAYERS = 2
# training: phi3 W = 2 x 1 x 1024 tokens (2 x 1.709 G params x 16 B = 54.7
# GB + a 6.8 GB anchor), paligemma W = 4 x 1 x (256 prefix + 1024 text);
# tree leaves (AdamW launches a step): phi3 12 (the untied head), paligemma
# 11
PHI3_W, VLM_W = 2, 4
PHI3_LEAVES, VLM_LEAVES = 12, 11
VLM_PREFIX = 256
# starcoder2-3b's decode attention (GQA 12: 24 query heads over 2 kv heads
# of 128, every layer windowed at 4096) at the main serving step and the
# long one, as flash_decode kernel rows
SC2_HEADS, SC2_KV, SC2_HD, SC2_WINDOW = 24, 2, 128, 4096
SC2_DECODE = (
    f"starcoder2-3b q[{SLOTS},1,24,128] kv[{SLOTS},64,2,128] w4096 p0",
    f"starcoder2-3b q[{LONG_SLOTS},1,24,128] kv[{LONG_SLOTS},{LONG_LEN},2,"
    "128] w4096 p0 q_offset (s+1)512-1")
# train to serve: starcoder2-3b at T2S_LAYERS layer trained W = 2 x 1 x
# 256 for 4 steps (2 rounds, a checkpoint and a publish at each), served
# from a watch directory by 2 slots (1 layer, not 2, since the adaptive
# slice: chip_smoke's time; the contract is the same at any depth)
T2S_W, T2S_B, T2S_SEQ, T2S_STEPS, T2S_LAYERS = 2, 1, 256, 4, 1
# checkpoint directories: under the checkout, listed in .gitignore, deleted
# after the run
CKPT_ROOT = os.path.join(ROOT, "_ckpt")
# one-shot generate (gemma3-4b): prompts x prompt tokens, new tokens; and
# the timed prefill
GEN_B, GEN_PLEN, GEN_NEW = 4, 32, 16
# paligemma-3b's one-shot cache: the image prefix, the prompt, the new tokens
VLM_GEN_LEN = VLM_PREFIX + GEN_PLEN + GEN_NEW
PREFILL_B, PREFILL_LEN = 4, 1024
# whisper-base (the audio family: an encoder over 1500 stub frames, a
# causal decoder with cross-attention, layernorm and GELU) at full width
# and depth: one-shot generate of WH_B prompts x WH_PLEN tokens after stub
# frames, WH_NEW new; trained W = 4 x 8 x 64 tokens (the training CLI's
# defaults) with the LM recipe, on host and on device data, cut to
# WH_TRAIN_LAYERS encoder and decoder layers (3 + 3 since the adaptive
# slice: chip_smoke's time); parameters (full depth and the training cut)
# and tree leaves (AdamW launches a step)
WH_ARCH = "whisper-base"
WH_B, WH_PLEN, WH_NEW = 4, 32, 32
WH_W, WH_BLOC, WH_SEQ = 4, 8, 64
WH_PARAMS, WH_LEAVES = 70_627_840, 31
WH_TRAIN_LAYERS, WH_TRAIN_PARAMS = 3, 48_592_384
WH_ATTN = {
    "enc": "whisper-base encoder q[4,1500,8,64] non-causal",
    "enc_train": "whisper-base encoder train q[8,1500,8,64] non-causal",
    "dec": "whisper-base decoder q[4,32,8,64] causal",
    "dec_train": "whisper-base decoder train q[8,64,8,64] causal",
    "cross": "whisper-base cross q[4,32,8,64] kv[4,1500,8,64] non-causal",
    "cross_train": ("whisper-base cross train q[8,64,8,64] kv[8,1500,8,64] "
                    "non-causal"),
    "cross_decode": ("whisper-base decode cross q[4,1,8,64] kv[4,1500,8,64] "
                     "non-causal")}
# ring serving: gemma3-4b one-shot at --window 512 (every local layer keeps
# its 1024-key window, so the ring cache holds 1024 rows), RING_B prompts x
# RING_PLEN tokens and RING_NEW new ones: 40 decode steps past the wrap.
# Card against CPU at 2 layers: a RING_CPU_PROMPT-token prefill, then
# teacher-forced ring decode steps to the same end, 8 before the wrap
RING_WINDOW, RING_B, RING_PLEN, RING_NEW = 512, 2, 64, 1000
RING_ROWS, RING_CPU_PROMPT = 1024, 1016
# its depth: 6 of gemma3-4b's 34 layers (five local, one global: both
# kinds of layer on the ring), since its 1000 decode steps are host-bound
# and took 63-67 s at 34 layers
RING_LAYERS = 6
# mamba2-130m (the ssm family: conv and SSM state in the cache, no
# attention, d = 768 and gated rows of 1536) and zamba2-1.2b (the hybrid
# family: a mamba2 backbone of 38 layers, d = 2048 and gated rows of 4096,
# with one weight-shared attention block, 32 heads of 64, after every 6):
# mamba2 served at full depth and trained cut to M2_TRAIN_LAYERS (12 of
# 24 since the adaptive slice: chip_smoke's time), zamba2 served at full
# depth and trained cut to Z2_TRAIN_LAYERS (one group of 6, the shared
# block, the real tail of 2); parameters by depth, tree leaves (AdamW
# launches a step)
M2_ARCH, Z2_ARCH = "mamba2-130m", "zamba2-1.2b"
M2_PARAMS = {2: 46_146_448, 12: 83_799_648, 24: 128_983_488}
M2_TRAIN_LAYERS = 12
Z2_PARAMS = {8: 333_148_672, 38: 1_100_743_552}
M2_LEAVES, Z2_LEAVES = 13, 34
Z2_TRAIN_LAYERS = 8
M2_W, M2_B, Z2_W, Z2_B = 4, 4, 4, 1
# the serving prefill's cache: the prompt and 64 new tokens (zamba2's
# flash_decode row over [4, 1088] is the last of them)
SSM_PREFILL_CACHE = PREFILL_LEN + 64
# card against CPU: a prefill of two of the configs' 256-token SSD chunks,
# then teacher-forced decode steps (mamba2 at 2 layers, zamba2 at 8); and
# zamba2 through a 32-row ring, a 16-token prefill and 40 steps
SSM_CPU_PROMPT, SSM_CPU_STEPS = 512, 6
Z2_CPU_RING, Z2_CPU_RING_PROMPT, Z2_CPU_RING_STEPS = 32, 16, 40
# zamba2's one-shot ring (--window): a 64-row KV ring, Z2_RING_B prompts x
# Z2_RING_PLEN tokens, Z2_RING_NEW new: 80 decode steps past the wrap
Z2_RING_WINDOW, Z2_RING_B, Z2_RING_PLEN, Z2_RING_NEW = 64, 2, 32, 112
# the training gates' sequence (both sides on the same batches): mamba2's
# two 256-token chunks, zamba2's one (its CPU side at 8 layers)
SSM_GATE_SEQ = {M2_ARCH: 512, Z2_ARCH: 256}
Z2_ATTN = {
    "train": "zamba2-1.2b train q[1,1024,32,64] kv[.,.,32,.] causal",
    "prefill": (f"zamba2-1.2b prefill q[4,1024,32,64] "
                f"kv[4,{SSM_PREFILL_CACHE},32,64] causal")}
# the MoE family at full width: dbrx-132b (16 experts, top-4, layernorm,
# 48 query heads over 8 kv heads: G = 6) served at DBRX_LAYERS of its 40
# layers (57.1 GB of fp32 weights: 13.0 GB a layer, 4.9 GB of embedding
# and untied head); kimi-k2-1t-a32b (384 experts, top-8, one shared
# expert, RMSNorm at d = 7168, G = 8) served at 1 of its 61 layers with
# KIMI_SERVE_EXPERTS of its 384 experts (32.7 GB; one layer with all 384
# is 77.8 GB, which leaves ~7 GB of the card for everything else) and
# trained at 1 layer with KIMI_TRAIN_EXPERTS, W = 1 x 1 x 1024, remat
# (3.23 G parameters x 16 B of params, m, v and grad = 51.7 GB); their
# card-vs-CPU gates at 1 layer (kimi with KIMI_TRAIN_EXPERTS experts).
# Parameters by depth (dbrx) and by experts at 1 layer (kimi); kimi's
# tree leaves (AdamW launches a step)
DBRX_ARCH, KIMI_ARCH = "dbrx-132b", "kimi-k2-1t-a32b"
DBRX_LAYERS, KIMI_SERVE_EXPERTS, KIMI_TRAIN_EXPERTS = 4, 128, 16
DBRX_PARAMS = {1: 4_492_234_752, 4: 14_269_526_016}
KIMI_PARAMS = {128: 8_163_054_592, 16: 3_229_750_272}
KIMI_LEAVES, KIMI_D, KIMI_F = 16, 7168, 2048
# an MoE model's one-shot generate: 2 prompts x 4 tokens, so that its
# prefill's 8 tokens fit the capacity's floor of 8 rows an expert and drop
# no pick, as no decode step of the --slots 2 service (2 tokens) does: the
# two paths then emit the same tokens by the semantics.  (A prefill of
# more tokens sizes its capacity to them, ceil(T k 1.25 / E), and can drop
# picks the one-token-a-step service keeps.)
MOE_GEN = (2, 4)
# card against CPU: a prefill of 2 x 32 tokens, then 4 greedy decode steps
MOE_CPU_B, MOE_CPU_PROMPT, MOE_CPU_STEPS = 2, 32, 4
DBRX_PREFILL_ATTN = ("dbrx-132b prefill q[4,1024,48,128] kv[.,.,8,.] "
                     "causal")
KIMI_ATTN = tuple(f"kimi-k2-1t-a32b {what} q[{b},1024,64,128] kv[.,.,8,.] "
                  "causal" for what, b in (("train", 1), ("prefill", 4)))
# prefill's last-position logits against the prompt fed through
# decode_step, x max(|logits|, 1): fp32 sums in another order in every
# product (the full-sequence attention kernel in 3xTF32 against the decode
# kernel's fp32 FMAs, cuBLAS at another M) through 34 layers
PREFILL_TOL = 2e-4
# serving logits, card against CPU at the same weights (absolute): fp32
# sums in another order in every product, through the layers and the
# unembedding
SERVE_TOL = 2e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


_LAST_EMIT = [time.perf_counter()]
_LAST_PHASE = ["start"]


def emit(phase: str, **kw) -> None:
    """One JSON line.  Every line carries `seconds`: the phase's own span
    where it measures one, else the time since the line before it (the work
    that produced this line), so the lines' seconds add up to the run's."""
    now = time.perf_counter()
    kw.setdefault("seconds", now - _LAST_EMIT[0])
    _LAST_EMIT[0] = now
    _LAST_PHASE[0] = phase
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing --

class Timer:
    """Median device time of one call, from CUDA events around each launch.
    A 256 MB buffer is zeroed before every timed launch so that no input is
    left in the 50 MB L2 by the previous launch: the serving path reads
    every layer's weights and cache cold.  A ~1 ms sleep kernel after the
    flush keeps the device busy while the host enqueues the start event and
    the call, so the host's own time never falls between the events."""

    def __init__(self, torch, iters: int = 25):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, setup=None) -> float:
        """`setup`, when given, runs before each timed launch's flush,
        outside the events (an in-place kernel's inputs restored)."""
        torch = self.torch
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(self.iters):
            if setup is not None:
                setup()
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)          # ~1 ms of GPU clock cycles
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in pairs)
        return times[len(times) // 2]


def bound_ms(nbytes: float, flops: float,
             peak: float = PEAK_FP32_FLOP_PER_S) -> tuple[float, str]:
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def tensor_core_bound(row) -> None:
    """The attention kernels and swiglu's tile path run every product in
    3xTF32 on the tensor cores (three TF32 products for each fp32 one), so
    their bound is that arithmetic's against the same bytes.  The fp32
    CUDA-core bound the kernels had before stays beside it as
    `bound_fp32_ms`."""
    row["bound_fp32_ms"], row["bound_fp32_by"] = row["bound_ms"], row["bound_by"]
    row["bound_ms"], row["bound_by"] = bound_ms(
        row["bytes"], 3.0 * row["flops"], PEAK_TF32_FLOP_PER_S)
    row["bound_share"] = row["bound_ms"] / row["ms"]


# ------------------------------------------------------- kernel cases ------

# the SSM families' norms: mamba2's gated rows (d_inner 1536) and zamba2's
# (4096, staged) at a 4 x 1024 prefill, and their decode steps' model-width
# rows (768, 2048) at 2 slots
SSM_NORM_ROWS = ((PREFILL_B * PREFILL_LEN, 1536),
                 (PREFILL_B * PREFILL_LEN, 4096), (SLOTS, 768), (SLOTS, 2048))


# kimi-k2's d = 7168 (staged) at its decode step's 2 rows, a training
# lane's 1024 and a 4 x 1024 prefill
KIMI_NORM_ROWS = ((SLOTS, KIMI_D), (BWD_ROWS, KIMI_D),
                  (PREFILL_B * PREFILL_LEN, KIMI_D))


def kernel_cases(torch, main_len: int):
    """(kernel, label, inputs dict, is_main_path_shape, timed).  Shapes are
    gemma3-4b's: D 2560, F 10240, Hq 8, Hkv 4, head_dim 256."""
    g = torch.Generator(device="cuda").manual_seed(1234)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    def ragged(b, hi):
        return torch.randint(0, hi, (b,), generator=g, device="cuda",
                             dtype=torch.int32)

    d, f, hq, hkv, hd = 2560, 10240, 8, 4, 256
    cases = []
    # the main path's [2, 2560], a decode batch of 8 slots, the prefill's
    # 4 x 1024 rows, and a bytes-bound [8192, 2560]
    for n, main in ((4, False), (SLOTS, True), (LONG_SLOTS, False),
                    (PREFILL_B * PREFILL_LEN, False), (8192, False)):
        cases.append(("rms_norm", f"[{n},{d}]",
                      dict(x=rnd(n, d), scale=rnd(d)), main, True))
    # rows past the registers, staged in shared memory: phi3-medium-14b's d
    # = 5120 at its decode step's 2 rows, a training lane's 1024 and the
    # prefill's 4096; qwen1.5-110b's 8192 at 1024 and 4096
    for n, dd in ((SLOTS, PHI3_D), (BWD_ROWS, PHI3_D),
                  (PREFILL_B * PREFILL_LEN, PHI3_D), (BWD_ROWS, QWEN_D),
                  (PREFILL_B * PREFILL_LEN, QWEN_D)) + SSM_NORM_ROWS + KIMI_NORM_ROWS:
        cases.append(("rms_norm", f"[{n},{dd}]",
                      dict(x=rnd(n, dd), scale=rnd(dd)), False, True))

    def sw(n, d, f, main=False, timed=True):
        cases.append(("swiglu", f"[{n},{d}]x[{d},{f}]",
                      dict(x=rnd(n, d), wg=rnd(d, f, std=d ** -0.5),
                           wi=rnd(d, f, std=d ** -0.5)), main, timed))

    for n, main in ((4, False), (SLOTS, True), (256, False),
                    (PREFILL_B * PREFILL_LEN, False)):
        sw(n, d, f, main)

    def fd(b, sk, *, window, prefix_len=0, ring=False, main=False, timed=True,
           qoff=None, note="", heads=(hq, hkv, hd), arch=""):
        nq, nkv, dh = heads
        kpos = None
        if ring:        # a ring after wrap-around, with empty (-1) slots
            kpos = torch.arange(sk, device="cuda", dtype=torch.int32) + 300
            kpos[: sk // 8] = -1
        label = (f"{arch}q[{b},1,{nq},{dh}] kv[{b},{sk},{nkv},{dh}] w{window}"
                 f" p{prefix_len}{' ring' if ring else ''}{note}")
        hi = sk + 300 if ring else sk
        qo = ragged(b, hi) if qoff is None else torch.tensor(
            qoff, dtype=torch.int32, device="cuda")
        args = dict(q=rnd(b, 1, nq, dh), k=rnd(b, sk, nkv, dh),
                    v=rnd(b, sk, nkv, dh), window=window,
                    prefix_len=prefix_len, q_offset=qo, k_positions=kpos)
        cases.append(("flash_decode", label, args, main, timed))

    fd(4, 512, window=1024)
    fd(4, 512, window=0, timed=False)
    fd(4, 512, window=64, timed=False)
    fd(4, 500, window=1024, ring=True, timed=False)   # Sk % 64 != 0
    fd(4, 500, window=0, prefix_len=37, timed=False)
    # a real serving shape: 8 slots of a 4096-row cache, the slots at
    # positions (s+1) 512 - 1, through a local (window 1024) and a global
    # layer: split-K over the SMs and the skipped tiles show here
    for w in (1024, 0):
        fd(LONG_SLOTS, LONG_LEN, window=w, qoff=LONG_POS,
           note=" q_offset (s+1)512-1")
    # edges: Sk one past a split unit, an uneven cut of 17 units over 16
    # splits, rows with no allowed key (before the cache; past the window)
    # under splits, ring positions under splits
    fd(4, 65, window=0, timed=False, qoff=[64, 63, 0, -1], note=" dead row")
    fd(4, 1089, window=100, timed=False, qoff=[1088, 700, 1300, 5],
       note=" dead row")
    fd(4, 4097, window=0, prefix_len=70, timed=False, qoff=[4096, 64, -1, 2047])
    fd(4, 700, window=1024, ring=True, timed=False)
    fd(4, 1089, window=0, ring=True, timed=False, qoff=[1388, 900, 100, 310],
       note=" dead row")
    fd(SLOTS, main_len, window=1024, main=True)
    # starcoder2-3b (g = 12, the G = 16 instance): its serving step and the
    # long step, timed; g = 12 past the split cap and through a ring, not
    sc2 = dict(heads=(SC2_HEADS, SC2_KV, SC2_HD), arch="starcoder2-3b ")
    fd(SLOTS, main_len, window=SC2_WINDOW, **sc2)
    fd(LONG_SLOTS, LONG_LEN, window=SC2_WINDOW, qoff=LONG_POS,
       note=" q_offset (s+1)512-1", **sc2)
    fd(4, 4097, window=1000, prefix_len=7, timed=False,
       qoff=[4096, 2000, -1, 3], **sc2)
    fd(4, 700, window=300, ring=True, timed=False, **sc2)
    # the decode steps of phi3-medium-14b (G = 4, D = 128) and qwen1.5-110b
    # (G = 8, D = 128) at the serving step, and paligemma-3b's (G = 8, D =
    # 256) after its 256-token image prefix: the one-shot path's 4 rows at
    # the last new token's position
    fd(SLOTS, main_len, window=0, heads=(40, 10, 128), arch="phi3-medium-14b ")
    fd(SLOTS, main_len, window=0, heads=(64, 8, 128), arch="qwen1.5-110b ")
    fd(GEN_B, VLM_GEN_LEN, window=0, prefix_len=VLM_PREFIX,
       qoff=[VLM_GEN_LEN - 1] * GEN_B, heads=(8, 1, 256),
       arch="paligemma-3b ")
    # whisper-base's decode step (G = 1, D = 64) at its one-shot path's last
    # position, and gemma3-4b's local layer on the --window ring of 1024
    # rows after its wrap
    fd(WH_B, WH_PLEN + WH_NEW, window=0, qoff=[WH_PLEN + WH_NEW - 1] * WH_B,
       heads=(8, 8, 64), arch="whisper-base ")
    fd(RING_B, RING_ROWS, window=1024, ring=True, arch="gemma3-4b ",
       note=" (the --window ring)")
    # zamba2-1.2b's shared block (32 heads of 64, G = 1): the last decode
    # step after a 4 x 1024 prefill and 64 new tokens, and its --window ring
    fd(PREFILL_B, SSM_PREFILL_CACHE, window=0,
       qoff=[SSM_PREFILL_CACHE - 1] * PREFILL_B, heads=(32, 32, 64),
       arch="zamba2-1.2b ")
    fd(Z2_RING_B, Z2_RING_WINDOW, window=0, ring=True, heads=(32, 32, 64),
       arch="zamba2-1.2b ", note=" (the --window ring)")
    # the MoE family's decode steps: dbrx-132b's G = 6 (the G = 8 instance
    # with g = 6) and kimi-k2's G = 8, D = 128, at the serving step
    fd(SLOTS, main_len, window=0, heads=(48, 8, 128), arch="dbrx-132b ")
    fd(SLOTS, main_len, window=0, heads=(64, 8, 128),
       arch="kimi-k2-1t-a32b ")
    # swiglu's tile path (from 9 rows): prefills of 16 to 128 rows, timed;
    # edges one past a tile (9, 129, 4097 rows), and D = 98, a k-tail that
    # is neither a multiple of the 32-wide chunk nor of 4
    for n in (16, 48, 128):
        sw(n, d, f)
    for n in (9, 129, 4097):
        sw(n, d, f, timed=False)
    for n in (9, 129):
        sw(n, 98, 516, timed=False)
    # phi3-medium-14b's MLP at its decode step and a training lane's rows,
    # qwen1.5-110b's at its decode step
    sw(SLOTS, PHI3_D, 17920)
    sw(BWD_ROWS, PHI3_D, 17920)
    sw(SLOTS, QWEN_D, 49152)
    # kimi-k2's shared expert at its decode step, a training lane's rows
    # and a 4 x 1024 prefill
    for n in (SLOTS, BWD_ROWS, PREFILL_B * PREFILL_LEN):
        sw(n, KIMI_D, KIMI_F)
    return cases


def run_kernel(torch, kernels, name, a):
    if name == "rms_norm":
        return kernels[name](a["x"], a["scale"])
    if name == "swiglu":
        return kernels[name](a["x"], a["wg"], a["wi"])
    return kernels[name](a["q"], a["k"], a["v"], window=a["window"],
                         prefix_len=a["prefix_len"], q_offset=a["q_offset"],
                         k_positions=a["k_positions"])


def library_call(torch, name, a):
    """One PyTorch call computing the same function: timed as a yardstick,
    never used by the port."""
    F = torch.nn.functional
    if name == "rms_norm":
        d = a["x"].shape[-1]
        return lambda: F.rms_norm(a["x"], (d,), a["scale"], 1e-6)
    if name == "swiglu":
        return lambda: F.silu(a["x"] @ a["wg"]) * (a["x"] @ a["wi"])
    from repro_torch.kernels import ref
    q, k, v = a["q"], a["k"], a["v"]
    b, _, hq, hd = q.shape
    sk = k.shape[1]
    mask = ref._mask(1, sk, causal=True, window=a["window"],
                     prefix_len=a["prefix_len"], q_offset=a["q_offset"],
                     k_positions=a["k_positions"], device=q.device)
    mask = mask[:, None]                               # [B,1,1,Sk]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)


def work(torch, name, a) -> tuple[float, float]:
    """(bytes the function must move, operations it does) for this input."""
    if name == "rms_norm":
        n, d = a["x"].shape
        return 4.0 * (2 * n * d + d), 4.0 * n * d
    if name == "swiglu":
        n, d = a["x"].shape
        f = a["wg"].shape[1]
        return 4.0 * (n * d + 2 * d * f + n * f), 4.0 * n * d * f + 5.0 * n * f
    from repro_torch.kernels import ref
    b, _, hq, hd = a["q"].shape
    sk, hkv = a["k"].shape[1], a["k"].shape[2]
    mask = ref._mask(1, sk, causal=True, window=a["window"],
                     prefix_len=a["prefix_len"], q_offset=a["q_offset"],
                     k_positions=a["k_positions"], device=a["q"].device)
    need = mask[:, 0].sum(-1)                          # keys each row needs
    need = torch.where(need == 0, torch.full_like(need, sk), need)
    keys = float(need.sum())
    nbytes = 4.0 * (2 * b * hq * hd + keys * hkv * hd * 2 + b
                    + (sk if a["k_positions"] is not None else 0))
    flops = keys * hq * (4.0 * hd + 5.0)
    return nbytes, flops


# the paths of csrc/rmsnorm.cu's and csrc/rmsnorm_bwd.cu's instances by
# their template argument VEC (VEC > 0: rows held in registers)
RMS_NORM_PATHS = {"rmsnorm_kernel": {0: "strided", -2: "staged"},
                  "rmsnorm_bwd_kernel": {-1: "scalar", -2: "staged"}}


def rms_norm_path(names, kernel: str) -> str:
    """The path of the one instance of `kernel` (`kernel<VEC>`) among the
    profiled kernel `names`: the instance that launched."""
    vecs = {int(m.group(1)) for n in names
            for m in [re.search(kernel + r"<(-?\d+)>", n)] if m}
    check(len(vecs) == 1, f"{kernel}: instances {sorted(vecs)} launched")
    vec = vecs.pop()
    path = "registers" if vec > 0 else RMS_NORM_PATHS[kernel].get(vec)
    check(path is not None, f"{kernel}<{vec}>: no such path")
    return path


def check_row(name, label, err, scale, main, **extra) -> dict:
    tol = TOL[name] * max(scale, 1.0)
    row = dict(kernel=name, shape=label, main_path_shape=main,
               max_abs_err=err, max_rel_err=err / max(scale, 1e-30), tol=tol,
               **extra)
    check(err <= tol, f"{name} {label}: max abs err {err} > tol {tol}")
    return row


def timed_row(row, timer, kernel, plain, library, nbytes, flops) -> dict:
    b_ms, b_by = bound_ms(nbytes, flops)
    row.update(ms=timer(kernel), plain_ms=timer(plain),
               library_ms=None if library is None else timer(library),
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
    row["kernel_ms"] = row["ms"]
    row["bound_share"] = b_ms / row["ms"]
    return row


def launch_floor_ms(torch, timer) -> float:
    """Device time of an empty kernel's launch with the kernels' `Timer`:
    the least any launch costs, against which the decode-size rows (bounds
    of nanoseconds) are read."""
    from repro_torch.kernels import build
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        build.check(lib.empty_launch(stream), "empty_launch")
    return timer(launch)


def phase_kernels(torch, main_len):
    """Returns (the main path's rows by kernel, every timed row by (kernel,
    shape))."""
    from repro_torch.kernels import build, ops, ref
    timer = Timer(torch)
    floor = launch_floor_ms(torch, timer)
    emit("launch_floor", launch_floor_ms=floor)
    tile_rows = build.library().swiglu_tile_min_rows()
    summary, rows = {}, {}
    for name, label, a, main, timed in kernel_cases(torch, main_len):
        plain = {"rms_norm": ref.rms_norm, "swiglu": ref.swiglu,
                 "flash_decode": ref.attention}[name]
        got = run_kernel(torch, ops.KERNELS, name, a)
        want = run_kernel(torch, {name: plain}, name, a)
        torch.cuda.synchronize()
        row = check_row(name, label, float((got - want).abs().max()),
                        float(want.abs().max()), main)
        tiles = name == "swiglu" and a["x"].shape[0] >= tile_rows
        if name == "swiglu":
            row["path"] = "tiles" if tiles else "rows"
        if name == "rms_norm":
            prof = profile_device_ms(
                torch, lambda: run_kernel(torch, ops.KERNELS, name, a),
                count=("rmsnorm_kernel",))
            row["path"] = rms_norm_path([t["name"] for t in prof["top"]],
                                        "rmsnorm_kernel")
            # the same rows one float off 16-byte alignment take the strided
            # path (the parent's for rows past the registers): every path
            # sums in one order, so the bits are the same
            xs = torch.empty(a["x"].numel() + 1, device="cuda")[1:]
            xs = xs.view_as(a["x"]).copy_(a["x"])
            row["bitwise_strided_path"] = bool(torch.equal(
                got, ops.KERNELS[name](xs, a["scale"])))
            check(row["bitwise_strided_path"],
                  f"rms_norm {label}: not bitwise the strided path's output")
            del xs
        if timed:
            lib = library_call(torch, name, a)
            row["library_max_abs_err"] = float((lib() - want).abs().max())
            timed_row(row, timer,
                      lambda: run_kernel(torch, ops.KERNELS, name, a),
                      lambda: run_kernel(torch, {name: plain}, name, a),
                      lib, *work(torch, name, a))
            row["launch_floor_ms"] = floor
            if tiles:
                tensor_core_bound(row)
            rows[name, label] = row
            if main:
                summary[name] = row
        emit("kernel_check", **row)
    return summary, rows


# ------------------------------------------------ training kernels ---------

def attention_work(torch, a, backward: bool) -> tuple[float, float]:
    """(bytes, operations) attention needs at these inputs: each row's
    allowed (query, key) pairs, all Sk keys for a row with none.  Forward:
    read q, k, v, write o and lse; 4 D operations per pair.  Backward: read
    q, k, v, o, dout, lse, write dq, dk, dv; 10 D per pair (S, dP, dV, dK,
    dQ)."""
    from repro_torch.kernels import ref
    b, sq, hq, d = a["q"].shape
    sk, hkv = a["k"].shape[1], a["k"].shape[2]
    m = ref._mask(sq, sk, causal=a["causal"], window=a["window"],
                  prefix_len=a["prefix_len"], q_offset=a["q_offset"],
                  device=a["q"].device)
    need = m.sum(-1)
    need = torch.where(need == 0, torch.full_like(need, sk), need)
    pairs = float(need.sum()) * b * hq
    qo, kv, lse = 4.0 * b * sq * hq * d, 4.0 * b * sk * hkv * d, 4.0 * b * hq * sq
    if backward:
        return 4 * qo + 4 * kv + lse, pairs * 10.0 * d
    return 2 * qo + 2 * kv + lse, pairs * 4.0 * d


LM_TRAIN_ATTN = ("starcoder2-3b train q[4,1024,24,128] kv[.,.,2,.] causal "
                 "window 4096")
PHI3_TRAIN_ATTN = "phi3-medium-14b train q[1,1024,40,128] kv[.,.,10,.] causal"
# a microbatched step runs attention at its chunk's batch: ViT-B/16 at
# microbatch 2, starcoder2-3b's training lanes at microbatch 2 and 4
VIT_MB_ATTN = "vit-b microbatch 2 q[16,196,12,64] non-causal"
LM_MB_ATTN = {mb: f"starcoder2-3b train microbatch {mb} q[{LM_B // mb},1024,"
                  f"24,128] kv[.,.,2,.] causal window 4096" for mb in (2, 4)}
VLM_ATTN = tuple(f"paligemma-3b {what} q[{b},1280,8,256] kv[.,.,1,.] causal "
                 f"prefix 256" for what, b in (("train", 1), ("prefill", 4)))
PREFILL_ATTN = tuple(f"gemma3-4b prefill q[4,1024,8,256] kv[.,.,4,.] causal "
                     f"window {w}" for w in (1024, 0))


def attention_cases(rnd):
    """(label, inputs, main-path shape?, timed?).  The main path's: ViT-B/16,
    [32,196,12,64] non-causal (196 tokens: no tile divides it).  Also timed:
    the LM path's shapes (starcoder2-3b training, GQA 12, and gemma3-4b's
    prefill of 4 x 1024 tokens through a local and a global layer), a
    gemma3-4b prefill of 2048 tokens through a sliding-window layer (D =
    256, GQA 2), and a causal D = 128 case with GQA 4.  D = 32 (the
    starcoder2 smoke config's) is checked, not timed."""
    def fa(label, b, sq, sk, hkv, g, d, causal, window=0, prefix_len=0,
           q_offset=0, main=False, timed=False):
        return (label, dict(q=rnd(b, sq, hkv * g, d), k=rnd(b, sk, hkv, d),
                            v=rnd(b, sk, hkv, d), dout=rnd(b, sq, hkv * g, d),
                            causal=causal, window=window,
                            prefix_len=prefix_len, q_offset=q_offset), main,
                main or timed)
    return [
        fa("vit-b q[32,196,12,64] non-causal", 32, 196, 196, 12, 1, 64,
           False, main=True),
        fa(LM_TRAIN_ATTN, LM_B, LM_SEQ, LM_SEQ, 2, 12, 128, True,
           window=4096, timed=True),
        fa(VIT_MB_ATTN, B_LOC // 2, 196, 196, 12, 1, 64, False, timed=True),
        *(fa(label, LM_B // mb, LM_SEQ, LM_SEQ, 2, 12, 128, True,
             window=4096, timed=True) for mb, label in LM_MB_ATTN.items()),
        fa(PREFILL_ATTN[0], PREFILL_B, PREFILL_LEN, PREFILL_LEN, 4, 2, 256,
           True, window=1024, timed=True),
        fa(PREFILL_ATTN[1], PREFILL_B, PREFILL_LEN, PREFILL_LEN, 4, 2, 256,
           True, timed=True),
        fa("starcoder2-smoke q[2,64,8,32] kv[.,.,2,.] causal window 64", 2,
           64, 64, 2, 4, 32, True, window=64),
        fa("q[1,197,8,32] kv[.,.,1,.] gqa 8 causal window 16 prefix 5", 1,
           197, 197, 1, 8, 32, True, window=16, prefix_len=5),
        fa("q[2,130,4,32] non-causal", 2, 130, 130, 4, 1, 32, False),
        fa("gemma3-4b prefill q[1,2048,8,256] kv[.,.,4,.] causal window 1024",
           1, 2048, 2048, 4, 2, 256, True, window=1024, timed=True),
        fa("q[4,1024,16,128] kv[.,.,4,.] gqa 4 causal", 4, 1024, 1024, 4, 4,
           128, True, timed=True),
        fa("q[4,300,8,64] causal", 4, 300, 300, 8, 1, 64, True),
        fa("q[4,300,8,64] causal window 64", 4, 300, 300, 8, 1, 64, True,
           window=64),
        fa("q[4,300,8,64] causal prefix 17", 4, 300, 300, 8, 1, 64, True,
           prefix_len=17),
        fa("q[2,300,8,64] kv 500 causal q_offset 200", 2, 300, 500, 8, 1, 64,
           True, q_offset=200),
        fa("q[2,256,8,128] kv[.,.,4,.] gqa 2 causal", 2, 256, 256, 4, 2, 128,
           True),
        fa("q[2,256,8,128] kv[.,.,2,.] gqa 4 causal", 2, 256, 256, 2, 4, 128,
           True),
        fa("q[1,130,4,256] gqa 2 window 32 prefix 5", 1, 130, 130, 2, 2, 256,
           True, window=32, prefix_len=5),
        fa(PHI3_TRAIN_ATTN, 1, LM_SEQ, LM_SEQ, 10, 4, 128, True, timed=True),
        *(fa(label, b, VLM_PREFIX + LM_SEQ, VLM_PREFIX + LM_SEQ, 1, 8, 256,
             True, prefix_len=VLM_PREFIX, timed=True)
          for label, b in zip(VLM_ATTN, (1, PREFILL_B))),
        # whisper-base (8 heads of 64, one kv head each): the encoder's 1500
        # frames at the serving batch and at a training lane's (dS in key
        # chunks), the decoder's causal prompt, its cross-attention from the
        # prompt and from one decode row
        fa(WH_ATTN["enc"], WH_B, 1500, 1500, 8, 1, 64, False, timed=True),
        fa(WH_ATTN["enc_train"], WH_BLOC, 1500, 1500, 8, 1, 64, False,
           timed=True),
        fa(WH_ATTN["dec"], WH_B, WH_PLEN, WH_PLEN, 8, 1, 64, True,
           timed=True),
        fa(WH_ATTN["dec_train"], WH_BLOC, WH_SEQ, WH_SEQ, 8, 1, 64, True,
           timed=True),
        fa(WH_ATTN["cross"], WH_B, WH_PLEN, 1500, 8, 1, 64, False,
           timed=True),
        fa(WH_ATTN["cross_train"], WH_BLOC, WH_SEQ, 1500, 8, 1, 64, False,
           timed=True),
        fa(WH_ATTN["cross_decode"], WH_B, 1, 1500, 8, 1, 64, False,
           timed=True),
        # zamba2-1.2b's shared block (32 heads of 64, G = 1): a training
        # lane's 1 x 1024 tokens, and the prefill's 4 x 1024 against the
        # cache of 1088 rows
        fa(Z2_ATTN["train"], 1, LM_SEQ, LM_SEQ, 32, 1, 64, True, timed=True),
        fa(Z2_ATTN["prefill"], PREFILL_B, PREFILL_LEN, SSM_PREFILL_CACHE, 32,
           1, 64, True, timed=True),
        # the MoE family: dbrx-132b's prefill (G = 6), kimi-k2's training
        # lane and prefill (G = 8), D = 128
        fa(DBRX_PREFILL_ATTN, PREFILL_B, PREFILL_LEN, PREFILL_LEN, 8, 6, 128,
           True, timed=True),
        *(fa(label, b, LM_SEQ, LM_SEQ, 8, 8, 128, True, timed=True)
          for label, b in zip(KIMI_ATTN, (1, PREFILL_B))),
    ]


def sdpa_inputs(torch, a):
    """SDPA's operands for the same function as the attention case `a`:
    [B,H,S,D] views that require grad, the kv heads repeated for GQA, and
    the mask as a boolean attn_mask (None where every key is allowed)."""
    from repro_torch.kernels import ref
    q, k, v = a["q"], a["k"], a["v"]
    gh = q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if gh > 1:
        kt, vt = (x.repeat_interleave(gh, dim=1) for x in (kt, vt))
    am = None
    if a["causal"] or a["window"] or a["prefix_len"]:
        am = ref._mask(q.shape[1], k.shape[1], causal=a["causal"],
                       window=a["window"], prefix_len=a["prefix_len"],
                       q_offset=a["q_offset"], device=q.device)
    return (*(x.detach().requires_grad_(True) for x in (qt, kt, vt)), am)


def phase_training_kernels(torch):
    """flash_attention forward and backward, adamw_update and
    sync_flat_update against their plain versions at the training path's
    shapes, with kernel / plain / library / bound times at the main path's.
    Returns (the main path's rows by kernel, every timed attention row by
    (kernel, shape))."""
    from repro_torch.kernels import adamw_update as _ad
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import sync_update as _su
    F = torch.nn.functional
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(4321)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    summary, rows = {}, {}
    for label, a, main, timed in attention_cases(rnd):
        q, k, v, do = a["q"], a["k"], a["v"], a["dout"]
        mask = {key: a[key] for key in ("causal", "window", "prefix_len",
                                        "q_offset")}
        kw = dict(mask, scale=q.shape[-1] ** -0.5)
        o, lse = _fa.flash_attention_fwd(q, k, v, **kw)
        grads = _fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        want = ref.attention(*ins, **mask)
        want_g = torch.autograd.grad(want, ins, do, retain_graph=True)
        torch.cuda.synchronize()
        err = float((o - want.detach()).abs().max())
        fwd = check_row("flash_attention_fwd", label, err,
                        float(want.detach().abs().max()), main)
        gerr = max(float((x - y).abs().max()) for x, y in zip(grads, want_g))
        bwd = check_row("flash_attention_bwd", label, gerr,
                        max(float(y.abs().max()) for y in want_g), main)
        if timed:
            qt, kt, vt, am = sdpa_inputs(torch, a)
            lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
            dot = do.transpose(1, 2)
            with torch.no_grad():
                timed_row(fwd, timer,
                          lambda: _fa.flash_attention_fwd(q, k, v, **kw),
                          lambda: ref.attention(q, k, v, **mask),
                          lambda: F.scaled_dot_product_attention(
                              qt, kt, vt, attn_mask=am),
                          *attention_work(torch, a, False))
            timed_row(bwd, timer,
                      lambda: _fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                      **kw),
                      lambda: torch.autograd.grad(want, ins, do,
                                                  retain_graph=True),
                      lambda: torch.autograd.grad(lib, (qt, kt, vt), dot,
                                                  retain_graph=True),
                      *attention_work(torch, a, True))
            tensor_core_bound(fwd)
            tensor_core_bound(bwd)
            rows["flash_attention_fwd", label] = fwd
            rows["flash_attention_bwd", label] = bwd
        if main:
            # no atomics, a fixed summation order: a second run on the same
            # inputs gives the same bits (the overlap gate rests on it)
            o2, lse2 = _fa.flash_attention_fwd(q, k, v, **kw)
            grads2 = _fa.flash_attention_bwd(q, k, v, o2, lse2, do, **kw)
            torch.cuda.synchronize()
            same = all(bool(torch.equal(x, y)) for x, y in
                       zip((o, lse, *grads), (o2, lse2, *grads2)))
            check(same, f"flash_attention {label}: a second run differs")
            fwd["bitwise_repeat"] = bwd["bitwise_repeat"] = same
            del o2, lse2, grads2

            def fwd_bwd(fn, xs, d_out):
                out = fn(*xs)
                return torch.autograd.grad(out, xs, d_out)
            kq = [x.detach().requires_grad_(True) for x in (q, k, v)]
            bwd["kernel_fwd_bwd_ms"] = timer(lambda: fwd_bwd(
                lambda *x: _fa.flash_attention(*x, **mask), kq, do))
            bwd["library_fwd_bwd_ms"] = timer(lambda: fwd_bwd(
                F.scaled_dot_product_attention, (qt, kt, vt), dot))
            summary["flash_attention_fwd"], summary["flash_attention_bwd"] = \
                fwd, bwd
        if timed:
            del lib
        emit("kernel_check", **fwd)
        emit("kernel_check", **bwd)
        del o, lse, grads, ins, want, want_g

    hyper = dict(lr=3e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
                 step=torch.tensor(5.0))
    for label, shape, main in (
            ("largest tree leaf [4,12,768,3072]", (W, 12, 768, 3072), True),
            (f"flat bucket [4,{VIT_PARAMS}]", (W, VIT_PARAMS), False)):
        p, m, grad = rnd(*shape, std=0.02), rnd(*shape, std=1e-3), \
            rnd(*shape, std=1e-2)
        v = rnd(*shape, std=1e-3).abs_()
        want = ref.adamw_update(p, m, v, grad, **hyper)
        got = _ad.adamw_update(p.clone(), m.clone(), v.clone(), grad, **hyper)
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) for x, y in zip(got, want))
        row = check_row("adamw_update", label, err,
                        max(float(y.abs().max()) for y in want), main)
        del want, got
        lib_p = torch.nn.Parameter(p.clone())
        lib_p.grad = grad
        lib = torch.optim.AdamW([lib_p], lr=3e-3, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=0.01, fused=True)
        n = p.numel()
        timed_row(row, timer,
                  lambda: _ad.adamw_update(p, m, v, grad, **hyper),
                  lambda: ref.adamw_update(p, m, v, grad, **hyper),
                  lib.step, 28.0 * n, 16.0 * n)
        if main:
            summary["adamw_update"] = row
        emit("kernel_check", **row)
        del p, m, v, grad, lib_p, lib

    n = VIT_PARAMS
    anchor = rnd(n, std=0.02)
    p = anchor[None] + rnd(W, n, std=1e-3)
    scale = (rnd(n).abs_() + 0.1) * 3e-3
    mu0 = rnd(n, std=1e-4)
    # the four modes at W = 4, and the main mode at W = 2 (its own instance)
    for w, quantize, momentum in ((W, True, 0.0), (W, False, 0.0),
                                  (W, True, 0.9), (W, False, 0.9),
                                  (2, True, 0.0)):
        pw = p[:w]
        kw = dict(scale=scale if quantize else None,
                  mu=mu0 if momentum else None, momentum=momentum)
        label = (f"[{w},{n}] quantize {'on' if quantize else 'off'} "
                 f"momentum {momentum}")
        want = ref.sync_flat_update(pw, anchor, **kw)
        got = _su.sync_flat_update(
            pw.clone(), anchor.clone(), scale=kw["scale"],
            mu=None if kw["mu"] is None else mu0.clone(), momentum=momentum)
        # the same ops lane by lane in the kernel's order 0..W-1: bitwise
        in_order = ref.sync_flat_update_lane_order(pw, anchor, **kw)
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) for x, y in zip(got, want)
                  if y is not None)
        if quantize:        # integer codes, no FMA: bitwise
            check(err == 0.0, f"sync_flat_update {label}: not bitwise "
                  f"({err})")
        lane_order = all(x is None or torch.equal(x, y)
                         for x, y in zip(got, in_order))
        check(lane_order, f"sync_flat_update {label}: not bitwise its ops "
              "in lane order")
        row = check_row("sync_flat_update", label, err,
                        float(want[0].abs().max()),
                        w == W and quantize and not momentum,
                        bitwise=err == 0.0, bitwise_lane_order=lane_order)
        del want, got, in_order
        pk, ak = pw.clone(), anchor.clone()
        muk = None if kw["mu"] is None else mu0.clone()
        words = 2 * w + 2 + quantize + 2 * (momentum > 0)
        timed_row(row, timer,
                  lambda: _su.sync_flat_update(pk, ak, scale=kw["scale"],
                                               mu=muk, momentum=momentum),
                  lambda: ref.sync_flat_update(pw, anchor, **kw), None,
                  4.0 * n * words, n * (w * (5.0 if quantize else 2.0) + 6))
        if row["main_path_shape"]:
            summary["sync_flat_update"] = row
        emit("kernel_check", **row)
        del pk, ak, muk
    del p, anchor, scale, mu0
    torch.cuda.empty_cache()
    return summary, rows


def phase_sync_kernels(torch):
    """sync_apply_update on the flat bucket [86,332,648] and the ring's
    combine and quantize on one ring chunk [21,583,162] (the main path's
    shapes), each held bitwise against its plain version, with kernel /
    plain / bound times.  The ring chunks of the main path sit at offsets
    of c x C elements in the bucket's delta, so half of them are not
    16-byte aligned: the combine is also timed on such a view."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sync_update as _su
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(2468)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    def bitwise(name, label, got, want, main):
        err = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(got, want) if y is not None)
        same = all(bool(torch.equal(x, y)) for x, y in zip(got, want)
                   if y is not None)
        check(same, f"{name} {label}: not bitwise ({err})")
        return check_row(name, label, err, max(float(y.float().abs().max())
                                               for y in want
                                               if y is not None), main,
                         bitwise=True)

    summary = {}
    n = VIT_PARAMS
    anchor = rnd(n, std=0.02)
    codes = torch.round(rnd(n) * 40).clamp_(-127, 127)  # a W = 4 code mean
    qmean = ref.true_div(codes, 4.0)
    scale = (rnd(n).abs_() + 0.1) * 3e-3
    delta = rnd(n, std=1e-3)
    mu0 = rnd(n, std=1e-4)
    for quantize, momentum in ((True, 0.0), (True, 0.9), (False, 0.9)):
        step = qmean if quantize else delta
        kw = dict(scale=scale if quantize else None,
                  mu=mu0 if momentum else None, momentum=momentum)
        label = (f"[{n}] quantize {'on' if quantize else 'off'} "
                 f"momentum {momentum}")
        want = ref.sync_apply_update(step, anchor, **kw)
        got = _su.sync_apply_update(step, anchor, **kw)
        torch.cuda.synchronize()
        row = bitwise("sync_apply_update", label, got, want, True)
        del want, got
        words = 3 + quantize + 2 * (momentum > 0)
        timed_row(row, timer,
                  lambda: _su.sync_apply_update(step, anchor, **kw),
                  lambda: ref.sync_apply_update(step, anchor, **kw), None,
                  4.0 * n * words,
                  n * (1.0 + 2 * quantize + 4 * (momentum > 0)))
        if quantize and not momentum:
            summary["sync_apply_update"] = row
        emit("kernel_check", **row)
    del anchor, codes, qmean, scale, delta, mu0

    c = VIT_PARAMS // W
    buf = rnd(2 * c + 2, std=1e-3)
    x, x_off = buf[:c], buf[c + 2 + 1:][:c - 1]
    acc = rnd(c, std=1e-3)
    s = acc.abs().max()
    want = ref.ring_quantize_codes(acc, s)
    got = _su.ring_quantize(acc, s)
    torch.cuda.synchronize()
    row = bitwise("ring_quantize", f"[{c}]", (got,), (want,), True)
    timed_row(row, timer, lambda: _su.ring_quantize(acc, s),
              lambda: ref.ring_quantize_codes(acc, s), None, 5.0 * c + 4,
              4.0 * c)
    summary["ring_quantize"] = row
    emit("kernel_check", **row)
    q = got
    for k in (1, 2, 3):
        want = ref.ring_combine(q, s, x, k)
        got = _su.ring_combine(q, s, x, k)
        got_off = _su.ring_combine(q[:c - 1], s, x_off, k)
        want_off = ref.ring_combine(q[:c - 1], s, x_off, k)
        torch.cuda.synchronize()
        row = bitwise("ring_combine", f"[{c}] k {k}", got + got_off,
                      want + want_off, True)
        if k == 1:
            timed_row(row, timer, lambda: _su.ring_combine(q, s, x, k),
                      lambda: ref.ring_combine(q, s, x, k), None,
                      9.0 * c + 8, 6.0 * c)
            row["ms_unaligned_x"] = timer(
                lambda: _su.ring_combine(q[:c - 1], s, x_off, k))
            summary["ring_combine"] = row
        emit("kernel_check", **row)
        del want, got, got_off, want_off
    del buf, acc, q
    torch.cuda.empty_cache()
    return summary


def phase_sync_bf16(torch) -> list:
    """The bf16 instances of `sync_flat_update` and `sync_apply_update` at
    the sync harness's bf16 bucket (120 elements, W = 2: multihost's demo
    params over 4 chunks) and at a bucket of VIT_PARAMS elements (W = 2),
    each held bitwise against its plain version: quantized, and with outer
    momentum (the flat sync unquantized against its ops in lane order).
    The quantized rows are timed beside their plain versions and their
    bound (bytes / 3.35 TB/s).  Returns the rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sync_update as _su
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(1357)
    bf = torch.bfloat16

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    rows = []
    for n in (120, VIT_PARAMS):
        w = 2
        anchor = rnd(n, std=0.02).to(bf)
        p = (anchor.float()[None] + rnd(w, n, std=1e-3)).to(bf)
        scale = (rnd(n).abs_() + 0.1) * 3e-3
        mu0 = rnd(n, std=1e-4)
        qmean = ref.true_div(torch.round(rnd(n) * 40).clamp_(-127, 127), 2.0)
        for quantize, momentum in ((True, 0.0), (False, 0.9)):
            kw = dict(scale=scale if quantize else None,
                      mu=mu0 if momentum else None, momentum=momentum)
            label = (f"bf16 [{w},{n}] quantize {'on' if quantize else 'off'}"
                     f" momentum {momentum}")
            plain = (ref.sync_flat_update if quantize
                     else ref.sync_flat_update_lane_order)
            want = plain(p, anchor, **kw)
            got = _su.sync_flat_update(
                p.clone(), anchor.clone(), scale=kw["scale"],
                mu=None if kw["mu"] is None else mu0.clone(),
                momentum=momentum)
            torch.cuda.synchronize()
            same = all(y is None or (x.dtype == y.dtype and torch.equal(x, y))
                       for x, y in zip(got, want))
            check(same, f"sync_flat_update {label}: not bitwise its plain "
                  "version")
            row = dict(kernel="sync_flat_update", shape=label,
                       bitwise=same, max_abs_err=0.0)
            if quantize:
                pk, ak = p.clone(), anchor.clone()
                timed_row(row, timer,
                          lambda: _su.sync_flat_update(pk, ak, scale=scale),
                          lambda: ref.sync_flat_update(p, anchor, scale=scale),
                          None, n * (4.0 * w + 8), n * (w * 5.0 + 6))
                del pk, ak
            emit("kernel_check", **row)
            rows.append(row)
            del want, got
            step = qmean if quantize else rnd(n, std=1e-3)
            label = (f"bf16 [{n}] quantize {'on' if quantize else 'off'} "
                     f"momentum {momentum}")
            want = ref.sync_apply_update(step, anchor, **kw)
            got = _su.sync_apply_update(step, anchor, **kw)
            torch.cuda.synchronize()
            same = all(y is None or (x.dtype == y.dtype and torch.equal(x, y))
                       for x, y in zip(got, want))
            check(same, f"sync_apply_update {label}: not bitwise its plain "
                  "version")
            row = dict(kernel="sync_apply_update", shape=label, bitwise=same,
                       max_abs_err=0.0)
            if quantize:
                timed_row(row, timer,
                          lambda: _su.sync_apply_update(step, anchor,
                                                        scale=scale),
                          lambda: ref.sync_apply_update(step, anchor,
                                                        scale=scale),
                          None, 12.0 * n, 3.0 * n)
            emit("kernel_check", **row)
            rows.append(row)
            del want, got
        del anchor, p, scale, mu0, qmean
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------ backward kernels --------

def dscale_tol(torch, x, dy, eps: float = 1e-6) -> float:
    """The absolute bound dscale is held to: 2 n 2^-24 of the largest
    column sum of |dy x r| over the n rows, the worst case of two n-term
    fp32 sums in different orders (the kernel's block partials against
    torch's sum)."""
    d = x.shape[-1]
    x2, g2 = x.reshape(-1, d).double(), dy.reshape(-1, d).double()
    r = torch.rsqrt(torch.mean(x2 * x2, -1, keepdim=True) + eps)
    return 2 * x2.shape[0] * 2.0 ** -24 * float((g2 * x2 * r).abs().sum(0)
                                                  .max())


def swiglu_bwd_row(torch, timer, rnd, n, d, f, main=True) -> dict:
    """swiglu_bwd at x [n, d], wg / wi [d, f] from the pair the forward
    under autograd keeps (`swiglu_fwd`, its out bitwise `swiglu`'s): held
    against the plain backward on the same pair, and end to end against
    the plain forward and backward; repeated (bitwise); timed whole beside
    the plain version, the library's grad (autograd through the composed
    call, which keeps g and u from its forward) and the forward with and
    without the pair; and each of its three launches (the gate, dW, dX)
    by its own device time in a profile of whole calls."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import swiglu as _sw
    F = torch.nn.functional
    x, dh = rnd(n, d), rnd(n, f)
    wg, wi = rnd(d, f, std=d ** -0.5), rnd(d, f, std=d ** -0.5)
    out, p, q = _sw.swiglu_fwd(x, wg, wi)
    same_out = bool(torch.equal(out, _sw.swiglu(x, wg, wi)))
    got = _sw.swiglu_bwd(x, wg, wi, p, q, dh)
    got2 = _sw.swiglu_bwd(x, wg, wi, p, q, dh)
    want = ref.swiglu_bwd(x, wg, wi, p, q, dh)
    _, pp, qp = ref.swiglu_fwd(x, wg, wi)
    plain_all = ref.swiglu_bwd(x, wg, wi, pp, qp, dh)
    torch.cuda.synchronize()
    label = f"[{n},{d}]x[{d},{f}]"
    check(same_out, f"swiglu_fwd {label}: out differs from swiglu's bits")
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, got2))
    check(same, f"swiglu_bwd {label}: a second run differs")

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)
    errs = [rel(a, b) for a, b in zip(got, want)]
    errs_all = [rel(a, b) for a, b in zip(got, plain_all)]
    pair_errs = [rel(p, pp), rel(q, qp)]
    for e in errs_all + pair_errs:
        check(e <= TOL["swiglu_bwd"], f"swiglu_bwd {label}: end to end "
              f"{errs_all}, pair {pair_errs} > {TOL['swiglu_bwd']}")
    worst = max(range(3), key=lambda i: errs[i])
    row = check_row("swiglu_bwd", label,
                    float((got[worst] - want[worst]).abs().max()),
                    float(want[worst].abs().max()), main, bitwise_repeat=same,
                    out_bitwise_forward=same_out, rel_errs_dx_dwg_dwi=errs,
                    rel_errs_end_to_end=errs_all, rel_errs_pair=pair_errs)
    del got, got2, want, pp, qp, plain_all
    xr, gr, ir = (t.clone().requires_grad_(True) for t in (x, wg, wi))
    lib_out = F.silu(xr @ gr) * (xr @ ir)
    ops = 8.0 * n * d * f + 2.0 * n * f
    timed_row(row, timer, lambda: _sw.swiglu_bwd(x, wg, wi, p, q, dh),
              lambda: ref.swiglu_bwd(x, wg, wi, p, q, dh),
              lambda: torch.autograd.grad(lib_out, (xr, gr, ir), dh,
                                          retain_graph=True),
              4.0 * (2 * n * d + 4 * d * f + 3 * n * f), ops)
    tensor_core_bound(row)
    # each launch's mean device time over 5 whole calls back to back (the
    # profiler's kernel rows; no L2 flush between calls): the gate (dg = dh
    # p, du = dh q), dW (x^T [dg | du]) and dX, half the products each
    calls = 5
    prof = profile_device_ms(torch, lambda: [
        _sw.swiglu_bwd(x, wg, wi, p, q, dh) for _ in range(calls)], top=40,
        count=("gate_kernel", "swiglu_dw_kernel", "swiglu_dx_kernel"))
    for key, name in (("gate_ms", "gate_kernel"), ("dw_ms", "swiglu_dw_kernel"),
                      ("dx_ms", "swiglu_dx_kernel")):
        check(prof["calls"][name] == calls,
              f"swiglu_bwd {label}: {prof['calls'][name]} {name} launches "
              f"in {calls} calls")
        row[key] = sum(t["ms"] for t in prof["top"] if name in t["name"]) / calls
    row["dw_bound_ms"] = row["dx_bound_ms"] = row["bound_ms"] / 2
    row["forward_ms"] = timer(lambda: _sw.swiglu(x, wg, wi))
    row["forward_pair_ms"] = timer(lambda: _sw.swiglu_fwd(x, wg, wi))
    emit("kernel_check", **row)
    del x, dh, wg, wi, xr, gr, ir, lib_out, out, p, q
    return row


def phase_backward_kernels(torch):
    """rms_norm_bwd and swiglu_bwd against their plain versions at gemma3-4b's
    training rows (one lane: 1 x 1024 tokens), rms_norm_bwd also at phi3's
    d = 5120 and qwen's 8192 (its staged path), each twice on the same
    inputs (bitwise), with kernel / plain / library / bound times, and
    rms_norm_bwd's launches a call (one) with their device time and path
    from a profile of whole calls (`launch_ms`, `path`).  The library: autograd.grad
    through `F.rms_norm` and through the composed `F.silu(x@wg) * (x@wi)`
    (graphs built once, outside the timing).  swiglu_bwd runs from the pair
    its forward keeps, also at 2 x 1024 rows; its bound is its four
    products' 8 N D F operations in 3xTF32 on the tensor cores (the fp32
    bound beside it), its gate, dW and dX launches' device times beside it.
    Returns (the main path's rows by kernel, every rms_norm_bwd row by
    (kernel, shape))."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as _rn
    F = torch.nn.functional
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(1357)

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * std

    summary, rows = {}, {}
    # mamba2's gated rows at a training lane's 4 x 1024 tokens and
    # zamba2's (4096, staged) at its 1 x 1024
    for n, d, main in ((BWD_ROWS, 2560, True), (BWD_ROWS, PHI3_D, False),
                       (BWD_ROWS, QWEN_D, False),
                       (M2_B * LM_SEQ, 1536, False), (Z2_B * LM_SEQ, 4096,
                                                      False),
                       (BWD_ROWS, KIMI_D, False)):
        x, sc, dy = rnd(n, d), rnd(d), rnd(n, d)
        dx, ds = _rn.rms_norm_bwd(x, sc, dy)
        dx2, ds2 = _rn.rms_norm_bwd(x, sc, dy)
        wdx, wds = ref.rms_norm_bwd(x, sc, dy)
        torch.cuda.synchronize()
        same = bool(torch.equal(dx, dx2) and torch.equal(ds, ds2))
        label = f"[{n},{d}]"
        check(same, f"rms_norm_bwd {label}: a second run differs")
        ds_err, ds_tol = float((ds - wds).abs().max()), dscale_tol(torch, x,
                                                                    dy)
        check(ds_err <= ds_tol, f"rms_norm_bwd {label}: dscale err {ds_err} "
              f"> {ds_tol}")
        row = check_row("rms_norm_bwd", label, float((dx - wdx).abs().max()),
                        float(wdx.abs().max()), main, bitwise_repeat=same,
                        dscale_max_abs_err=ds_err, dscale_tol=ds_tol)
        row["max_abs_err"] = max(row["max_abs_err"], ds_err)
        xr, sr = x.clone().requires_grad_(True), sc.clone().requires_grad_(True)
        lib_out = F.rms_norm(xr, (d,), sr, 1e-6)
        timed_row(row, timer, lambda: _rn.rms_norm_bwd(x, sc, dy),
                  lambda: ref.rms_norm_bwd(x, sc, dy),
                  lambda: torch.autograd.grad(lib_out, (xr, sr), dy,
                                              retain_graph=True),
                  4.0 * (3 * n * d + 2 * d), 10.0 * n * d)
        # each launch's mean device time over 5 whole calls back to back
        # (no L2 flush between calls): one launch a call
        calls = 5
        prof = profile_device_ms(torch, lambda: [
            _rn.rms_norm_bwd(x, sc, dy) for _ in range(calls)],
            count=("rmsnorm_bwd",))
        check(prof["calls"]["rmsnorm_bwd"] == calls,
              f"rms_norm_bwd {label}: {prof['calls']['rmsnorm_bwd']} "
              f"launches in {calls} calls")
        row["launch_ms"] = {t["name"]: t["ms"] / t["calls"]
                            for t in prof["top"] if "rmsnorm_bwd" in t["name"]}
        row["path"] = rms_norm_path(row["launch_ms"], "rmsnorm_bwd_kernel")
        rows["rms_norm_bwd", label] = row
        if main:
            summary["rms_norm_bwd"] = row
        emit("kernel_check", **row)
        del x, sc, dy, dx, ds, dx2, ds2, wdx, wds, xr, sr, lib_out

    summary["swiglu_bwd"] = swiglu_bwd_row(torch, timer, rnd, BWD_ROWS, 2560,
                                           10240)
    summary["swiglu_bwd"]["rows_2x"] = {
        k: v for k, v in swiglu_bwd_row(torch, timer, rnd, 2 * BWD_ROWS, 2560,
                                        10240, main=False).items()
        if k in ("shape", "ms", "plain_ms", "library_ms", "bound_ms",
                 "bound_fp32_ms", "gate_ms", "dw_ms", "dx_ms",
                 "max_abs_err")}
    # kimi-k2's shared expert at a training lane's rows
    row = swiglu_bwd_row(torch, timer, rnd, BWD_ROWS, KIMI_D, KIMI_F,
                         main=False)
    rows["swiglu_bwd", row["shape"]] = row
    torch.cuda.empty_cache()
    return summary, rows


# ----------------------------------------------------------- serving -------

def prompts_for(cfg, np):
    rng = np.random.default_rng(7)
    return [rng.integers(0, cfg.vocab, n, dtype=np.int32) for n in PROMPT_LENS]


def phase_service(torch, np, rows):
    """The serving main path, then (same weights) the one-shot generate
    path.  Returns (the service's counts, generate's counts)."""
    from repro_torch.configs import registry as R
    from repro_torch.kernels import ops
    from repro_torch.launch import weights as W
    from repro_torch.launch.serve import run_service

    cfg = R.get_config(ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    weights = W.ServingWeights.from_seed(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = prompts_for(cfg, np)
    max_len = max(PROMPT_LENS) + MAX_NEW

    # the main path: counts at 0 just before, read just after
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs, audit = run_service(cfg, weights, prompts, slots=SLOTS,
                              max_new=MAX_NEW, max_len=max_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = audit["decode_steps"]

    check(all(r.done and len(r.out) == MAX_NEW for r in reqs),
          "not every request finished with its tokens")
    want = {k: 0 for k in counts}
    want.update(rms_norm=(2 * cfg.n_layers + 1) * steps,
                swiglu=cfg.n_layers * steps,
                flash_decode=cfg.n_layers * steps)
    check(counts == want, f"launch counts {counts} != expected {want}")
    per_step = {k: v / steps for k, v in counts.items()}

    # each request served alone in 1 slot must emit the same tokens
    for r, p in zip(reqs, prompts):
        solo, _ = run_service(cfg, weights, [p], slots=1, max_new=MAX_NEW,
                              max_len=max_len)
        check(solo[0].out == r.out,
              f"request {r.rid}: batched {r.out} != solo {solo[0].out}")

    device_ms = device_step_ms(torch, cfg, weights, SLOTS, max_len,
                               [max_len // 2, max_len - 1])

    # bytes one decode step must read: every weight once + the whole cache
    w_bytes = sum(b.numel() * b.element_size() for b in weights.bufs.values())
    kv_bytes = 2 * cfg.n_layers * SLOTS * max_len * cfg.n_kv_heads * cfg.hd * 4
    floor_ms = (w_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3
    # the card's own copy rate: read + write of a 4 GiB buffer
    src = torch.empty(1 << 30, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    dst.copy_(src)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        dst.copy_(src)
    torch.cuda.synchronize()
    copy_rate = 5 * 2 * src.numel() * 4 / (time.perf_counter() - t0)
    del src, dst
    tokens = audit["tokens_emitted"]
    emit("service", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         params=sum(b.numel() for b in weights.bufs.values()),
         weight_init_s=init_s, slots=SLOTS, requests=len(reqs),
         prompt_lens=list(PROMPT_LENS), max_new=MAX_NEW, decode_steps=steps,
         tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
         ms_per_step=wall / steps * 1e3, device_ms_per_step=device_ms,
         device_busy_share=device_ms / (wall / steps * 1e3),
         step_bytes=w_bytes + kv_bytes,
         floor_ms_datasheet=floor_ms,
         floor_ms_measured_copy_rate=(w_bytes + kv_bytes) / copy_rate * 1e3,
         copy_rate_bytes_per_s=copy_rate, launches=counts,
         launches_per_step=per_step, solo_match=True,
         peak_mem_gb=peak_gb)
    phase_long_step(torch, cfg, weights, w_bytes)
    gen = phase_generate(torch, np, cfg, weights, rows)
    del weights, reqs
    torch.cuda.empty_cache()
    return counts, gen


def long_step_bytes(cfg, slots, max_len, positions) -> tuple[float, float]:
    """(bytes of the keys and values a decode step's masks allow, bytes of
    the whole cache) for slots at `positions` of a max_len-row cache: a
    local layer's row reads min(pos + 1, window) keys, a global one pos + 1."""
    row = cfg.n_kv_heads * cfg.hd * 4 * 2          # one key's K and V rows
    need = sum(min(p + 1, w) if w else p + 1
               for i in range(cfg.n_layers)
               for w in (cfg.layer_window(i),) for p in positions)
    return float(need * row), float(cfg.n_layers * slots * max_len * row)


def phase_long_step(torch, cfg, weights, w_bytes):
    """Device ms of one full-width decode step at LONG_SLOTS slots of a
    LONG_LEN-row cache (positions LONG_POS), beside its bytes floor
    (weights + the keys the masks allow) and the whole cache's bytes, with
    the launches of one step."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    ms = device_step_ms(torch, cfg, weights, LONG_SLOTS, LONG_LEN, LONG_POS,
                        count=True)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    want = dict(rms_norm=2 * cfg.n_layers + 1, swiglu=cfg.n_layers,
                flash_decode=cfg.n_layers)
    check(counts == want, f"long step launches {counts} != {want}")
    kv_need, kv_all = long_step_bytes(cfg, LONG_SLOTS, LONG_LEN, LONG_POS)
    floor = (w_bytes + kv_need) / PEAK_BYTES_PER_S * 1e3
    emit("service", measurement="decode_step_long", arch=cfg.name,
         layers=cfg.n_layers, slots=LONG_SLOTS, max_len=LONG_LEN,
         positions=LONG_POS, device_ms_per_step=ms,
         weight_bytes=w_bytes, kv_bytes_needed=kv_need,
         kv_bytes_whole_cache=kv_all,
         floor_ms_datasheet=floor, floor_share=floor / ms,
         floor_ms_whole_cache=(w_bytes + kv_all) / PEAK_BYTES_PER_S * 1e3,
         launches_per_step=counts)
    torch.cuda.empty_cache()


def device_step_ms(torch, cfg, weights, slots, max_len, positions,
                   reps: int = 10, count: bool = False) -> float:
    """Device time of one full-width decode step of `slots` slots at
    `positions` of a max_len-row cache, without the host's launch gaps: the
    step is captured once in a CUDA graph and the graph replayed back to
    back between two events.  Measurement only — the port itself launches
    eagerly.  With `count`, the kernels' launch counters are set to 0 just
    before the captured step, so they hold one step's launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import api
    mod = api.get_module(cfg)
    cache = mod.init_cache(cfg, slots, max_len, device="cuda")
    tok = torch.zeros(slots, dtype=torch.long, device="cuda")
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    tree = weights.as_tree()
    with torch.no_grad():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                mod.decode_step(cfg, tree, tok, cache, pos)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if count:
            ops.reset_launch_counts()
        with torch.cuda.graph(graph):
            mod.decode_step(cfg, tree, tok, cache, pos)
        graph.replay()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(reps):
            graph.replay()
        ev[1].record()
        torch.cuda.synchronize()
    del graph, cache
    return ev[0].elapsed_time(ev[1]) / reps


def logits_compare(tol):
    """A card-vs-CPU logits comparison: `compare(card, cpu)` keeps the
    largest difference and counts the rows whose greedy token the CPU's
    top-2 margin decides (> 2 tol) and those the card's argmax agrees on."""
    state = dict(worst=0.0, agree=0, decided=0)

    def compare(lc, lh):
        lc = lc.cpu()
        state["worst"] = max(state["worst"], float((lc - lh).abs().max()))
        top2 = lh.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * tol
        state["decided"] += int(sure.sum())
        state["agree"] += int(((lc.argmax(-1) == lh.argmax(-1)) & sure).sum())
    return compare, state


def cpu_weights(W, cfg, card):
    """`card`'s ServingWeights copied to the CPU once: the buckets' host
    copies are the CPU weights' buckets (the constructor, given a tree,
    would concatenate them into a second copy; qwen's 1-layer weights are
    16 GB)."""
    return W.ServingWeights.from_buckets(
        cfg, card.spec, {b: v.cpu() for b, v in card.bufs.items()},
        step=card.step)


def phase_card_vs_cpu(torch, np, arch=ARCH, n_layers=2):
    """`arch`'s widths at `n_layers` layers: same weights on the card
    (kernels) and on the CPU (plain versions; a QKV-bias model's biases
    random), teacher-forced decode steps.  A VLM first prefills a random
    image prefix and one token on both sides (its logits held the same
    way), then decodes after it with `prefix_len`."""
    from repro_torch.configs import registry as R
    from repro_torch.launch import weights as W
    from repro_torch.models import api

    cfg = dataclasses.replace(R.get_config(arch), n_layers=n_layers)
    mod = api.get_module(cfg)
    card = W.ServingWeights.from_seed(cfg, 3, device="cuda")
    random_biases(torch, cfg, card.as_tree(), 4)
    cpu = cpu_weights(W, cfg, card)
    prefix = cfg.n_img_tokens if cfg.family == "vlm" else 0
    b, max_len, n_steps = SLOTS, prefix + 16, 6
    caches = {dev: mod.init_cache(cfg, b, max_len, device=dev)
              for dev in ("cuda", "cpu")}
    rng = np.random.default_rng(11)
    # fp32 sums over D (2048 to 8192) and F (10240 to 49152) in another
    # order on each side: ~1e-6 relative per product, through 2 layers and
    # the unembedding (100,352 to 262,144 ways)
    tol = SERVE_TOL
    compare, res = logits_compare(tol)

    start = 0
    with torch.no_grad():
        if prefix:
            pre = torch.from_numpy((0.02 * rng.standard_normal(
                (b, prefix, cfg.d_model))).astype(np.float32))
            tok = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1)))
            lc, _ = mod.prefill(cfg, card.as_tree(), tok.cuda(),
                                caches["cuda"], prefix_embeds=pre.cuda())
            lh, _ = mod.prefill(cfg, cpu.as_tree(), tok, caches["cpu"],
                                prefix_embeds=pre)
            compare(lc, lh)
            start = prefix + 1
        for i in range(n_steps):
            tok = torch.from_numpy(rng.integers(0, cfg.vocab, b))
            pos = torch.tensor([start + i, start + i + 3], dtype=torch.int32)
            lc, _ = mod.decode_step(cfg, card.as_tree(), tok.cuda(),
                                    caches["cuda"], pos.cuda(),
                                    prefix_len=prefix)
            lh, _ = mod.decode_step(cfg, cpu.as_tree(), tok, caches["cpu"],
                                    pos, prefix_len=prefix)
            compare(lc, lh)
    check(res["worst"] <= tol, f"{cfg.name} card vs CPU logits differ by "
          f"{res['worst']} > {tol}")
    check(res["agree"] == res["decided"], f"{cfg.name} greedy tokens differ: "
          f"{res['agree']}/{res['decided']}")
    emit("card_vs_cpu", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab, qkv_bias=cfg.qkv_bias,
         prefix_len=prefix, steps=n_steps, batch=b,
         max_abs_logit_err=res["worst"], tol=tol,
         greedy_agree=res["agree"], greedy_decided=res["decided"])
    del card, cpu, caches
    torch.cuda.empty_cache()


def phase_hot_swap(torch, np):
    """Smoke config on the card: an in-process publish mid-sequence; the
    post-swap tokens equal a server restarted on the new weights."""
    from repro_torch.configs import registry as R
    from repro_torch.launch import weights as W
    from repro_torch.launch.batching import ContinuousBatcher, Request

    cfg = R.get_smoke_config(ARCH)
    w0 = W.ServingWeights.from_seed(cfg, 0, device="cuda")
    w1 = W.ServingWeights.from_seed(cfg, 7, device="cuda").as_tree()
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, 5,
                                               dtype=np.int32)
    sub = W.WeightSubscriber()
    batcher = ContinuousBatcher(cfg, w0, slots=2, max_len=48, subscriber=sub)
    req = Request(rid=0, prompt=prompt, max_new=8)
    batcher.submit(req)
    while len(req.out) < 3:
        batcher.step()
    sub.publish(1, w1)
    batcher.run()
    check(req.done and len(req.out) == 8 and batcher.swaps == 1,
          "hot swap did not complete")
    check(req.epochs == [0] * 3 + [1] * 5, f"epochs {req.epochs}")
    restart = ContinuousBatcher(cfg, W.ServingWeights(cfg, w1, device="cuda"),
                                slots=2, max_len=48)
    rref = Request(rid=0, prompt=np.concatenate(
        [prompt, np.asarray(req.out[:3], np.int32)]), max_new=5)
    restart.submit(rref)
    restart.run()
    check(rref.out == req.out[3:],
          f"post-swap {req.out[3:]} != restart {rref.out}")
    emit("hot_swap", arch=cfg.name, tokens=req.out, epochs=req.epochs,
         restart_tokens=rref.out, match=True)


def ssm_uses(cfg) -> int:
    """Uses of zamba2's shared attention block (one a group); 0 for mamba2."""
    return cfg.n_layers // cfg.shared_attn_period if cfg.family == "hybrid" \
        else 0


def norms_per_pass(cfg) -> int:
    """rms_norm launches of one pass through an RMSNorm model (a decode
    step, a prefill or a training forward): two a layer (an SSM layer's
    norm and its gated norm), two a use of zamba2's shared block, and the
    final norm."""
    return 2 * cfg.n_layers + 2 * ssm_uses(cfg) + 1


def decode_launches(cfg) -> dict:
    """Kernel launches of one decode step of `cfg`: flash_decode once a
    layer, and an RMSNorm model's rms_norm twice a layer and once for the
    final norm, a SwiGLU model's swiglu once a layer (an MoE model's only
    for its shared expert: the routed experts are batched products); an
    SSM's rms_norm `norms_per_pass`, zamba2's flash_decode once a use of
    its shared block."""
    if cfg.family in ("ssm", "hybrid"):
        out = dict(rms_norm=norms_per_pass(cfg))
        if ssm_uses(cfg):
            out["flash_decode"] = ssm_uses(cfg)
        return out
    n_l = cfg.n_layers
    out = dict(flash_decode=n_l)
    if cfg.norm == "rmsnorm":
        out["rms_norm"] = 2 * n_l + 1
    if cfg.act == "swiglu" and (cfg.n_shared_experts or not cfg.n_experts):
        out["swiglu"] = n_l
    return out


def generate_launches(cfg, new: int) -> dict:
    """Kernel launches of one-shot `generate` of `new` tokens: one prefill
    (the full-sequence attention, and the norms and MLPs of every row),
    then a decode step for each new token."""
    out = {k: v * new for k, v in decode_launches(cfg).items()}
    attn = ssm_uses(cfg) if cfg.family in ("ssm", "hybrid") else cfg.n_layers
    if attn:
        out["flash_attention_fwd"] = attn
    for k in ("rms_norm", "swiglu"):
        if k in out:
            out[k] += out[k] // new
    return out


def random_biases(torch, cfg, tree, seed: int) -> None:
    """A QKV-bias model's bq, bk and bv drawn 0.1 · normal in place (the
    init leaves them at zero, which would test nothing)."""
    if not cfg.qkv_bias:
        return
    g = torch.Generator(device=tree["layers"]["attn"]["bq"].device)
    g.manual_seed(seed)
    for name in ("bq", "bk", "bv"):
        tree["layers"]["attn"][name].normal_(0.0, 0.1, generator=g)


def phase_service_starcoder2(torch, np):
    """starcoder2-3b at full width and all 30 layers through
    `service_path`: flash_decode once a layer (g = 12, the G = 16
    instance), no rms_norm or swiglu (LayerNorm and GELU)."""
    from repro_torch.configs import registry as R
    return service_path(torch, np, "service_starcoder2",
                        R.get_config(LM_ARCH), LM_PARAMS[30])


def phase_service_phi3(torch, np):
    """phi3-medium-14b at full width and all 40 layers (58.6 GB of fp32
    weights, its untied head among them) through `service_path`: per
    decode step 81 rms_norm (d = 5120: the staged rows), 40 swiglu and 40
    flash_decode (G = 4)."""
    from repro_torch.configs import registry as R
    return service_path(torch, np, "service_phi3", R.get_config(PHI3_ARCH),
                        PHI3_PARAMS[40])


def phase_service_qwen(torch, np):
    """qwen1.5-110b at full width cut to QWEN_SERVE_LAYERS layers (all 80
    are 444.8 GB of fp32 weights: they do not fit the card), with nonzero
    random QKV biases, through `service_path`: d = 8192 rows staged, G =
    8."""
    from repro_torch.configs import registry as R
    cfg = dataclasses.replace(R.get_config(QWEN_ARCH),
                              n_layers=QWEN_SERVE_LAYERS)
    return service_path(
        torch, np, "service_qwen", cfg, QWEN_PARAMS[QWEN_SERVE_LAYERS],
        depth=f"{QWEN_SERVE_LAYERS} of 80 layers: the full depth's "
        f"{4 * QWEN_PARAMS[80] / 1e9:.1f} GB of fp32 weights exceed the "
        "card's 80 GB")


def service_path(torch, np, phase, cfg, n_params, depth=None,
                 gen=(GEN_B, GEN_PLEN), then=None):
    """`cfg` at full width (random weights from seed 0 on the card; a QKV
    bias model's biases random too) through the continuous-batching loop:
    2 slots, the 4 requests of PROMPT_LENS, MAX_NEW new tokens each, with
    the launch counts at 0 just before and read just after; then one-shot
    `generate` of `gen` = (prompts, prompt tokens), its tokens equal to the
    `--slots 2` service's; then the device time of one decode step (a CUDA
    graph) beside its bytes floor, its launches (`decode_launches`) and
    its kernels by name.  `then(weights)`, when given, runs after the
    line, on the same weights.  Returns (the service's counts, generate's
    counts)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import weights as W
    from repro_torch.launch.serve import generate, run_service
    from repro_torch.models import api

    n_l = cfg.n_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    weights = W.ServingWeights.from_seed(cfg, 0, device="cuda")
    random_biases(torch, cfg, weights.as_tree(), 1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    got_params = sum(b.numel() for b in weights.bufs.values())
    check(got_params == n_params, f"{phase}: {got_params} params")
    prompts = prompts_for(cfg, np)
    max_len = max(PROMPT_LENS) + MAX_NEW

    ops.reset_launch_counts()             # the path: counts at 0 ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs, audit = run_service(cfg, weights, prompts, slots=SLOTS,
                              max_new=MAX_NEW, max_len=max_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()          # ... read just after
    steps = audit["decode_steps"]
    check(all(r.done and len(r.out) == MAX_NEW for r in reqs),
          f"{phase}: not every request finished with its tokens")
    want = {k: 0 for k in counts}
    want.update({k: v * steps for k, v in decode_launches(cfg).items()})
    check(counts == want, f"{phase}: launches {counts} != {want}")

    rng = np.random.default_rng(13)
    gen_b, gen_plen = gen
    gp = rng.integers(0, cfg.vocab, (gen_b, gen_plen), dtype=np.int32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toks = generate(cfg, weights.as_tree(), gp, gen_len=GEN_NEW)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_counts = ops.launch_counts()
    want = {k: 0 for k in gen_counts}
    want.update(generate_launches(cfg, GEN_NEW))
    check(gen_counts == want, f"{phase} generate: launches {gen_counts} != "
          f"{want}")
    got = toks[:, gen_plen:].cpu().tolist()
    check(tuple(toks.shape) == (gen_b, gen_plen + GEN_NEW),
          f"{phase} generate: tokens of shape {tuple(toks.shape)}")
    sreqs, _ = run_service(cfg, weights, list(gp), slots=SLOTS,
                           max_new=GEN_NEW, max_len=gen_plen + GEN_NEW)
    for r in sreqs:
        check(r.out == got[r.rid], f"{phase} generate row {r.rid}: "
              f"{got[r.rid]} != the --slots {SLOTS} service's {r.out}")

    ops.reset_launch_counts()
    device_ms = device_step_ms(torch, cfg, weights, SLOTS, max_len,
                               [max_len // 2, max_len - 1], count=True)
    step_counts = {k: v for k, v in ops.launch_counts().items() if v}
    check(step_counts == decode_launches(cfg),
          f"{phase}: decode step launches {step_counts}")
    # one eager decode step's kernels by name (torch.profiler)
    mod = api.get_module(cfg)
    cache = mod.init_cache(cfg, SLOTS, max_len, device="cuda")
    tok = torch.zeros(SLOTS, dtype=torch.long, device="cuda")
    pos = torch.tensor([max_len // 2, max_len - 1], dtype=torch.int32,
                       device="cuda")
    with torch.no_grad():
        mod.decode_step(cfg, weights.as_tree(), tok, cache, pos)
        prof = profile_device_ms(torch, lambda: mod.decode_step(
            cfg, weights.as_tree(), tok, cache, pos), top=16)
    del cache
    # bytes one decode step must read: every weight once (an untied
    # model's input embedding only at the slots' rows: its head is the
    # unembedding) + the whole cache
    w_bytes = sum(b.numel() * b.element_size() for b in weights.bufs.values())
    step_w_bytes = w_bytes
    if not cfg.tie_embeddings:
        step_w_bytes -= 4 * (cfg.vocab - SLOTS) * cfg.d_model
    kv_bytes = 2 * n_l * SLOTS * max_len * cfg.n_kv_heads * cfg.hd * 4
    kv_bytes += ssm_state_bytes(cfg, SLOTS)
    floor_ms = (step_w_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3
    tokens = audit["tokens_emitted"]
    extra = {} if depth is None else {"depth": depth}
    if cfg.n_experts:
        # every expert runs on every decode step (a capacity of at least 8
        # rows an expert): the floor above counts every expert's weights
        extra.update(experts=cfg.n_experts, top_k=cfg.top_k,
                     shared_experts=cfg.n_shared_experts,
                     capacity_factor=cfg.capacity_factor,
                     decode_capacity=moe_capacity(cfg, SLOTS))
    emit(phase, arch=cfg.name, layers=n_l,
         d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
         head_dim=cfg.hd, qkv_bias=cfg.qkv_bias,
         tied_embeddings=cfg.tie_embeddings, params=got_params,
         weight_bytes=w_bytes, step_weight_bytes=step_w_bytes,
         weight_init_s=init_s, slots=SLOTS,
         requests=len(reqs), prompt_lens=list(PROMPT_LENS), max_new=MAX_NEW,
         decode_steps=steps, tokens=tokens, wall_s=wall,
         tokens_per_s=tokens / wall, ms_per_step=wall / steps * 1e3,
         device_ms_per_step=device_ms,
         device_busy_share=device_ms / (wall / steps * 1e3),
         step_bytes=step_w_bytes + kv_bytes, floor_ms_datasheet=floor_ms,
         floor_share=floor_ms / device_ms, launches=counts,
         launches_per_step=step_counts, profiled_step=prof,
         generate_prompts=gen_b, generate_prompt_len=gen_plen,
         generate_wall_s=gen_wall,
         generate_tokens_per_s=gen_b * GEN_NEW / gen_wall,
         generate_launches=gen_counts, generate_equals_slots_service=True,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **extra)
    del reqs, sreqs, toks
    if then is not None:
        then(weights)
    del weights
    torch.cuda.empty_cache()
    return counts, gen_counts


def ssm_state_bytes(cfg, slots: int) -> int:
    """Bytes a decode step moves in an SSM's state: every layer's conv rows
    and SSM state read once and written once (0 for other families)."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    d_inner = cfg.ssm_expand * cfg.d_model
    conv_dim, heads = d_inner + 2 * cfg.ssm_state, d_inner // cfg.ssm_headdim
    per_lane = ((cfg.ssm_conv - 1) * conv_dim
                + heads * cfg.ssm_headdim * cfg.ssm_state)
    return 2 * 4 * cfg.n_layers * slots * per_lane


def ckpt_path(name: str) -> str:
    """A fresh checkpoint directory under CKPT_ROOT."""
    path = os.path.join(CKPT_ROOT, name)
    shutil.rmtree(path, ignore_errors=True)
    return path


def tensor_bytes(torch, tree) -> int:
    from repro_torch import tree as T
    return sum(x.numel() * x.element_size() for x in T.leaves(tree)
               if isinstance(x, torch.Tensor))


def phase_ckpt_resume(torch, np):
    """ViT-B/16 at full width (slice 2's recipe, W = 4): 2 QSR rounds in
    the tree layout, saved (`RoundEngine.save`, fsyncs included), restored
    into a flat engine (the cross-layout route), 1 more round; its state
    bitwise equal to the same 3 rounds without the checkpoint (the tree
    state converted to the flat layout in memory).  Save and restore
    rates in GB/s of the state's bytes; the restore reads a file the save
    just wrote (the page cache may hold it)."""
    from repro_torch import tree as T
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import flat, schedules
    from repro_torch.optim.lr import make_lr_fn

    cfg, run, _, _, tree_eng = train_setup(torch)
    lr_fn = make_lr_fn(run)
    state, t = tree_eng.init_state(), 0
    for _ in range(2):
        h = schedules.get_h(run, t, lr_fn)
        state, _ = tree_eng.run_round(state, t, h, lr_fn)
        t += h
    path = ckpt_path("vit")
    nbytes = tensor_bytes(torch, state)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree_eng.save(path, state, step=t)
        save_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(os.path.join(path, "state.msgpack"))
        check(ckpt_io.read_meta(path)[1]["layout"] == "tree",
              "ckpt_resume: the checkpoint is not in the tree layout")
        # without the checkpoint: the live state converted in memory
        _, _, _, _, eng_a = train_setup(torch, layout="flat")
        st_a = flat.to_flat_state(eng_a._ensure_spec(
            T.map(lambda x: x[0], state["params"])), state)
        eng_a.h_trace = list(tree_eng.h_trace)
        del state
        _, _, _, _, eng_b = train_setup(torch, layout="flat")
        like = eng_b.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_b, step = eng_b.restore(path, like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del like
    finally:
        shutil.rmtree(path, ignore_errors=True)
    check(step == t and eng_b.h_trace == tree_eng.h_trace,
          f"ckpt_resume: restored at {step}, trace {eng_b.h_trace}")
    check(states_equal(torch, st_a, st_b),
          "ckpt_resume: the restored state is not bitwise the saved one")
    h = schedules.get_h(run, t, lr_fn)
    st_a, m_a = eng_a.run_round(st_a, t, h, lr_fn)
    st_b, m_b = eng_b.run_round(st_b, t, h, lr_fn)
    check(states_equal(torch, st_a, st_b)
          and all(bool(torch.equal(m_a[k], m_b[k])) for k in m_a),
          "ckpt_resume: the resumed round is not bitwise the uninterrupted")
    emit("ckpt_resume", arch=cfg.name, workers=W, params=VIT_PARAMS,
         rounds=[list(r) for r in eng_b.h_trace], saved_at=t,
         state_bytes=nbytes, file_bytes=file_bytes, save_s=save_s,
         save_gb_per_s=nbytes / save_s / 1e9, restore_s=restore_s,
         restore_gb_per_s=nbytes / restore_s / 1e9,
         layouts="tree -> flat", resumed_bitwise=True,
         loss_round3=float(m_b["loss"]))
    del st_a, st_b, eng_a, eng_b, tree_eng
    torch.cuda.empty_cache()


def phase_train_to_serve(torch, np):
    """The train-to-serve contract at starcoder2-3b's full width, 1 layer.
    A server (2 slots, weights from seed 5) decodes a request until it has
    3 tokens; then `train()` (W = 2 x 1 x 256, 4 steps, the LM recipe)
    runs with `async_observer`: its observer thread `fanout`s the
    checkpoint writer and, as `eval_fn`, `publish_weights` of the
    consensus into the server's watch directory, after every round.  The
    server goes on: it polls the directory, swaps the newest weights in
    mid-sequence, and its post-swap tokens equal a server restarted from
    `load_weights` of that directory.  The written checkpoint restores
    bitwise to the run's final state.  Publish and load rates in GB/s of
    the weights."""
    from repro_torch import tree as T
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.kernels import ops
    from repro_torch.launch import weights as W_
    from repro_torch.launch.batching import ContinuousBatcher, Request
    from repro_torch.launch.train import train

    cfg, run, eng = lm_engine(n_layers=T2S_LAYERS, workers=T2S_W,
                              b_loc=T2S_B, seq=T2S_SEQ, total_steps=T2S_STEPS)
    watch, ckpt = ckpt_path("watch"), ckpt_path("train")
    publish_s, published = [], []

    def publish(t, state):                # on the observer's thread
        t0 = time.perf_counter()
        W_.publish_weights(watch, T.map(lambda x: x[0], state["params"]),
                           step=t)
        publish_s.append(time.perf_counter() - t0)
        published.append(t)

    try:
        like = W_.params_like(cfg)
        sub = W_.WeightSubscriber(watch_dir=watch, like=like)
        server = ContinuousBatcher(
            cfg, W_.ServingWeights.from_seed(cfg, 5, device="cuda"),
            slots=SLOTS, max_len=48, subscriber=sub)
        prompt = np.random.default_rng(21).integers(0, cfg.vocab, 8,
                                                    dtype=np.int32)
        req = Request(rid=0, prompt=prompt, max_new=12)
        server.submit(req)
        while len(req.out) < 3:
            server.step()
        check(server.swaps == 0, "train_to_serve: swapped before training")

        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = train(cfg, run, workers=T2S_W, b_loc=T2S_B,
                            seq=T2S_SEQ, data="host", eng=eng,
                            ckpt_dir=ckpt, async_observer=True,
                            eval_fn=publish, log_every=0)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        check(hist[-1][0] == T2S_STEPS and published[-1] == T2S_STEPS,
              f"train_to_serve: rounds {hist}, published {published}")

        server.run()
        check(req.done and server.swaps == 1,
              f"train_to_serve: {server.swaps} swaps")
        ep = server.weights.epochs[-1]
        check(ep.step == T2S_STEPS and ep.source == f"watch:{watch}"
              and req.epochs == [0] * 3 + [1] * (len(req.out) - 3),
              f"train_to_serve: swap {ep}, epochs {req.epochs}")
        t0 = time.perf_counter()
        params, step, extra = W_.load_weights(watch, like)
        load_s = time.perf_counter() - t0
        check(step == T2S_STEPS and extra["kind"] == W_.WEIGHTS_KIND,
              f"train_to_serve: published step {step}, extra {extra}")
        restart = ContinuousBatcher(
            cfg, W_.ServingWeights(cfg, params, step=step, device="cuda"),
            slots=SLOTS, max_len=48)
        rref = Request(rid=0, prompt=np.concatenate(
            [prompt, np.asarray(req.out[:3], np.int32)]),
            max_new=len(req.out) - 3)
        restart.submit(rref)
        restart.run()
        check(rref.out == req.out[3:],
              f"train_to_serve: post-swap {req.out[3:]} != restart "
              f"{rref.out}")
        back, ck_step = eng.restore(ckpt, state)
        check(ck_step == T2S_STEPS and states_equal(torch, back, state),
              "train_to_serve: the observer's checkpoint does not restore "
              "to the final state")
        w_bytes = tensor_bytes(torch, params)
        ck_bytes = os.path.getsize(os.path.join(ckpt, "state.msgpack"))
    finally:
        shutil.rmtree(watch, ignore_errors=True)
        shutil.rmtree(ckpt, ignore_errors=True)
    emit("train_to_serve", arch=cfg.name, layers=cfg.n_layers,
         params=LM_PARAMS[T2S_LAYERS], workers=T2S_W, b_loc=T2S_B, seq=T2S_SEQ,
         steps=T2S_STEPS, rounds=[list(r) for r in eng.h_trace],
         train_wall_s=train_wall, launches=counts, published_steps=published,
         weight_bytes=w_bytes, publish_s=publish_s,
         publish_gb_per_s=[w_bytes / x / 1e9 for x in publish_s],
         load_s=load_s, load_gb_per_s=w_bytes / load_s / 1e9,
         checkpoint_file_bytes=ck_bytes, tokens=req.out, epochs=req.epochs,
         restart_tokens=rref.out, post_swap_equals_restart=True,
         checkpoint_restores_final_state=True)
    del state, back, params, server, restart, eng
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------- training -------

def train_setup(torch, *, layout="tree", n_layers=None, workers=None,
                b_loc=None, device="cuda", sync="blocking", overlap_depth=0,
                adaptive_batch=False, shards=0, **run_overrides):
    """(cfg, run config, stream, batch_fn, engine) of the ViT-B/16 recipe
    (W workers x B_LOC images unless given)."""
    from repro_torch.configs import registry as R
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.engine import RoundEngine
    from repro_torch.data.synthetic import VisionStream, vision_batch_fn

    cfg = R.get_config(TRAIN_ARCH)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    run = RunConfig(**{**TRAIN_RUN, **run_overrides})
    workers, b_loc = workers or W, b_loc or B_LOC
    stream = VisionStream(n_classes=cfg.n_classes, image=IMAGE, seed=42)
    batch_fn = vision_batch_fn(stream, workers, b_loc)
    eng = RoundEngine(cfg, run, workers=workers, b_loc=b_loc, seq=1,
                      data="host", layout=layout, batch_fn=batch_fn,
                      sync=sync, overlap_depth=overlap_depth,
                      adaptive_batch=adaptive_batch, shards=shards,
                      device=device)
    return cfg, run, stream, batch_fn, eng


def step_flops(cfg, images: int, tokens: int) -> float:
    """Matmul + attention FLOPs of one local step (forward + backward = 3x
    the forward) over `images` images, from the shapes."""
    d, f, pd = cfg.d_model, cfg.d_ff, 16 * 16 * 3
    per_image = (2 * tokens * pd * d
                 + cfg.n_layers * (2 * tokens * d * 4 * d      # q, k, v, o
                                   + 2 * tokens * d * 2 * f    # wi, wo
                                   + 4 * tokens * tokens * d)  # QK^T, PV
                 + 2 * d * cfg.n_classes)
    return 3.0 * per_image * images


def lanes_equal(torch, state, anchor=None) -> bool:
    """Every worker lane of every params leaf bitwise equal (to the
    anchor, when given)."""
    from repro_torch import tree as T
    if anchor is None:
        return all(bool(torch.equal(x, x[:1].expand_as(x)))
                   for x in T.leaves(state["params"]))
    return all(bool(torch.equal(state["params"][b], anchor[b][None]
                                .expand_as(state["params"][b])))
               for b in anchor)


def phase_train(torch, np):
    """The training main path: ViT-B/16 at full width, Local AdamW under
    QSR through `train()`, W = 4 x 32 images of 224^2, 10 rounds."""
    from repro_torch import tree as T
    from repro_torch.core import local_update as LU
    from repro_torch.core.sync import make_sync
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models import vit

    cfg, run, stream, batch_fn, eng = train_setup(torch)
    check_s = [0.0]

    def eval_fn(t, state):                # after each round's sync
        t0 = time.perf_counter()
        check(lanes_equal(torch, state), f"lanes differ after the sync at {t}")
        check_s[0] += time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()             # the main path: counts at 0 ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = train(cfg, run, workers=W, b_loc=B_LOC, seq=1, data="host",
                        eng=eng, eval_fn=eval_fn, log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - check_s[0]
    counts = ops.launch_counts()          # ... read just after
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps = run.total_steps
    rounds = [dict(t_end=t, h=h, lr=lr, loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]),
                   divergence=float(m["divergence"]))
              for (t, h, _, lr), m in zip(hist, eng.round_metrics)]
    check([(t - h, h) for t, h, _, _ in hist] == QSR_TRACE,
          f"H trace {[(t - h, h) for t, h, _, _ in hist]} != {QSR_TRACE}")
    check(eng.h_trace == QSR_TRACE, f"engine trace {eng.h_trace}")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
              for r in rounds), "a non-finite loss or grad norm")
    check(all(r["divergence"] > 0 for r in rounds),
          "zero worker divergence before a sync")
    attn = cfg.n_layers * W * steps       # one call per layer per worker
    want = {k: 0 for k in counts}
    want.update(flash_attention_fwd=attn, flash_attention_bwd=attn,
                adamw_update=16 * steps)  # one per leaf per step (tree)
    check(counts == want, f"launch counts {counts} != expected {want}")
    for r in rounds:
        emit("train_round", **r)

    # held-out accuracy of the final params, as the example computes it
    final = eng.params_single(state)
    with torch.no_grad():
        accs = []
        for i in range(8):
            xs, ys = stream.batch(50_000 + i, 0, 64, noisy=False)
            accs.append(float(vit.accuracy(cfg, final, {
                "images": xs.cuda(), "labels": ys.cuda()})))

    # device time of one local step (CUDA events, data already on the card)
    # and of one sync, on the final state
    step_fn = LU.make_local_step(cfg, run, with_metrics=True)
    batch = T.map(lambda x: x.cuda(), batch_fn(0))
    state, _ = step_fn(state, batch, 1e-5)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for _ in range(3):
        state, _ = step_fn(state, batch, 1e-5)
    ev[1].record()
    sync = make_sync(run)
    with torch.no_grad():
        ev[2].record()
        for _ in range(3):
            state = sync(state)
        ev[3].record()
    torch.cuda.synchronize()
    device_ms = ev[0].elapsed_time(ev[1]) / 3
    sync_ms = ev[2].elapsed_time(ev[3]) / 3

    images = W * B_LOC
    flops = step_flops(cfg, images, (IMAGE // 16) ** 2)
    wall_ms = wall / steps * 1e3
    data_ms = eng.data_seconds / steps * 1e3
    emit("train", arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         params=VIT_PARAMS, workers=W, b_loc=B_LOC, image=IMAGE,
         steps=steps, rounds=len(rounds), h_trace=eng.h_trace,
         wall_s=wall, wall_ms_per_step=wall_ms, data_ms_per_step=data_ms,
         device_ms_per_step=device_ms,
         device_busy_share=device_ms / wall_ms,
         images_per_s=images * steps / wall, sync_ms=sync_ms,
         flop_per_step=flops,
         flop_floor_ms_per_step=flops / PEAK_FP32_FLOP_PER_S * 1e3,
         achieved_tflop_s=flops / device_ms / 1e9,
         launches=counts,
         launches_per_step={k: v / steps for k, v in counts.items()},
         peak_mem_gb=peak_gb, heldout_acc=float(np.mean(accs)),
         final_loss=rounds[-1]["loss"], lanes_equal_after_sync=True)
    del state, final, eng
    torch.cuda.empty_cache()
    return counts


def phase_train_flat_quantized(torch, np):
    """The same model and data at full width, layout flat with the int8
    sync, 2 rounds of H = 2: one adamw_update per step and one
    sync_flat_update per round, all lanes equal to the anchor after it.
    Returns the counts and the final state (the overlap phase's bitwise
    reference)."""
    from repro_torch import tree as T
    from repro_torch.core import sync as S

    def eval_fn(t, state):
        check(lanes_equal(torch, state, state["anchor"]),
              f"flat lanes differ from the anchor after the sync at {t}")

    eng, state, hist, counts, wall = run_variant(
        torch, np, "train_flat_quantized", sync="blocking", eval_fn=eval_fn)
    expect_counts("train_flat_quantized", eng.cfg, counts, sync_flat_update=2)
    sync = S.make_sync(eng.run_cfg, spec=eng.spec)
    scratch = T.map(torch.clone, state)     # the fused sync works in place
    with torch.no_grad():
        ms = sync_ms(torch, lambda: sync(scratch))
        # where one blocking int8 sync's device time goes: the per-tensor
        # scales (core/sync.py flat_delta_scales: the [W, N] delta, abs,
        # amax over the lanes, segment_max per leaf, spread) and the kernel
        profile = profile_device_ms(torch, lambda: sync(scratch), top=16,
                                    by_op=True)
    emit("train_flat_quantized", arch=eng.cfg.name, layout="flat",
         buckets=list(eng.spec.sizes.items()), sync_quantize=True,
         rounds=[dict(t_end=t, h=h, loss=loss,
                      divergence=float(m["divergence"]))
                 for (t, h, loss, _), m in zip(hist, eng.round_metrics)],
         wall_s=wall, launches=counts, lanes_equal_anchor=True,
         sync_wall_ms=ms[0], sync_device_ms=ms[1], sync_profile=profile)
    del eng, scratch
    torch.cuda.empty_cache()
    return counts, state


def sync_ms(torch, fn, reps: int = 3) -> tuple[float, float]:
    """(host wall ms, device ms from CUDA events) of one call of `fn`,
    averaged over `reps` back-to-back calls after a warm-up call, with the
    device synchronised before and after."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) / reps * 1e3,
            ev[0].elapsed_time(ev[1]) / reps)


def run_variant(torch, np, phase, *, sync, depth=0, mask=None, eval_fn=None,
                **run_overrides):
    """2 rounds of H = 2 of the full-width recipe on the flat layout with
    the int8 sync, through `train()`; launch counts at 0 just before, read
    just after.  Returns (engine, flushed state, history, counts, wall s)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train

    cfg, run, _, _, eng = train_setup(
        torch, layout="flat", schedule="constant", total_steps=4,
        sync_quantize=True, sync=sync, overlap_depth=depth, **run_overrides)
    if mask is not None:
        eng.membership_epoch(mask)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = train(cfg, run, workers=W, b_loc=B_LOC, seq=1, data="host",
                        layout="flat", sync=sync, overlap_depth=depth,
                        eng=eng, eval_fn=eval_fn, log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check([(t - h, h) for t, h, _, _ in hist] == [(0, 2), (2, 2)],
          f"{phase}: rounds {hist}")
    check(all(np.isfinite(loss) for _, _, loss, _ in hist),
          f"{phase}: a non-finite loss")
    check(eng._pending is None, f"{phase}: a sync still pending after train()")
    return eng, state, hist, counts, wall


def expect_counts(phase, cfg, counts, **sync_launches):
    """4 local steps of W workers: 4 AdamW launches (one flat bucket) and
    one attention forward and backward per layer per worker per step."""
    want = {k: 0 for k in counts}
    want.update(flash_attention_fwd=cfg.n_layers * W * 4,
                flash_attention_bwd=cfg.n_layers * W * 4, adamw_update=4,
                **sync_launches)
    check(counts == want, f"{phase}: launch counts {counts} != {want}")


def states_equal(torch, a, b) -> bool:
    from repro_torch import tree as T
    la, ta = T.flatten(a)
    lb, tb = T.flatten(b)
    return ta == tb and all(bool(torch.equal(x, y)) for x, y in zip(la, lb))


def phase_train_overlap(torch, np, blocking_state):
    """sync="overlap" on the full-width flat quantized run.  Depth 0: the
    final state bitwise the blocking phase's (same seed and data), with one
    sync_apply_update per sync and no fused sync.  Depth 1 with outer
    momentum 0.9: finite, nothing pending after `train()`; then on 2 more
    rounds driven through the engine, `synced_view` twice and `flush` agree
    bitwise and leave the state untouched.  Returns the depth-0 counts and
    the two runs' seconds a round, tagged as table4's `overlap` rows
    (`blocking_d0`, `overlap_d1`): the frontier `train_adaptive` reads."""
    from repro_torch import tree as T
    from repro_torch.core import sync as S
    from repro_torch.kernels import ops

    eng, state, hist, counts, wall = run_variant(torch, np, "train_overlap",
                                                 sync="overlap", depth=0)
    expect_counts("train_overlap d0", eng.cfg, counts, sync_apply_update=2)
    check(states_equal(torch, state, blocking_state),
          "overlap at depth 0 is not bitwise the blocking flat run")
    begin = S.make_sync_begin(eng.run_cfg, eng.spec)
    apply_ = S.make_sync_apply(eng.run_cfg, eng.spec)
    with torch.no_grad():
        pending = begin(state)
        begin_ms = sync_ms(torch, lambda: begin(state))
        apply_ms = sync_ms(torch, lambda: apply_(state, pending))
    del state, pending, eng

    eng1, state1, hist1, counts1, wall1 = run_variant(
        torch, np, "train_overlap", sync="overlap", depth=1,
        outer_momentum=0.9)
    expect_counts("train_overlap d1", eng1.cfg, counts1, sync_apply_update=2)
    st = state1
    for t in (4, 6):
        st, _ = eng1.run_round(st, t, 2, lambda i: 1e-4)
    before = [x.clone() for x in T.leaves(st)]
    ops.reset_launch_counts()
    v1, v2 = eng1.synced_view(st), eng1.synced_view(st)
    check(all(bool(torch.equal(a, b)) for a, b in zip(T.leaves(st), before)),
          "synced_view changed the training state")
    fl = eng1.flush(st)
    check(states_equal(torch, v1, v2) and states_equal(torch, v1, fl),
          "synced_view twice and flush disagree")
    check(ops.launch_counts()["sync_apply_update"] == 3,
          f"views + flush launches {ops.launch_counts()}")
    check(all(bool(torch.isfinite(x).all()) for x in T.leaves(fl["params"])),
          "overlap depth 1: non-finite params")
    emit("train_overlap", arch=eng1.cfg.name, layout="flat",
         sync_quantize=True,
         depth0=dict(rounds=[(t, h, loss) for t, h, loss, _ in hist],
                     wall_s=wall, launches=counts,
                     bitwise_blocking=True, begin_wall_ms=begin_ms[0],
                     begin_device_ms=begin_ms[1], apply_wall_ms=apply_ms[0],
                     apply_device_ms=apply_ms[1]),
         depth1_momentum09=dict(rounds=[(t, h, loss)
                                        for t, h, loss, _ in hist1],
                                wall_s=wall1, launches=counts1,
                                synced_view_pure=True,
                                flush_equals_views=True))
    del eng1, state1, st, before, v1, v2, fl
    torch.cuda.empty_cache()
    return counts, {"blocking_d0": wall / len(hist),
                    "overlap_d1": wall1 / len(hist1)}


def phase_train_partial(torch, np):
    """sync="partial" with the mask [1, 1, 0, 1]: the mean over lanes 0, 1
    and 3, every lane (lane 2 too) equal to the anchor after each sync, one
    sync_apply_update per sync."""
    from repro_torch.core import sync as S

    def eval_fn(t, state):
        check(lanes_equal(torch, state, state["anchor"]),
              f"partial: a lane differs from the anchor after the sync at {t}")

    mask = [1.0, 1.0, 0.0, 1.0]
    eng, state, hist, counts, wall = run_variant(
        torch, np, "train_partial", sync="partial", mask=mask,
        eval_fn=eval_fn)
    expect_counts("train_partial", eng.cfg, counts, sync_apply_update=2)
    sync = S.make_sync_partial(eng.run_cfg, eng.spec)
    m = torch.tensor(mask, device="cuda")
    with torch.no_grad():
        ms = sync_ms(torch, lambda: sync(state, m))
    emit("train_partial", arch=eng.cfg.name, membership=mask,
         epochs=[dataclasses.asdict(e) for e in eng.epochs],
         rounds=[(t, h, loss) for t, h, loss, _ in hist], wall_s=wall,
         launches=counts, lanes_equal_anchor=True, sync_wall_ms=ms[0],
         sync_device_ms=ms[1])
    del eng, state
    torch.cuda.empty_cache()
    return counts


def phase_train_ring(torch, np):
    """sync_wire="ring-int8", blocking: per sync exactly 16 ring_quantize +
    12 ring_combine + 1 sync_apply_update launches; the first sync's codes
    and scales on the card equal `ring_codes_host` on the CPU for the same
    delta, bitwise; its dequantized mean within `ring_tolerance(4, amax)`
    of the exact mean."""
    from repro_torch.core import sync as S

    real, seen = S.ring_codes_host, []

    def record(d, w=None):
        out = real(d, w)
        if not seen:
            seen.append((d.cpu(), out[0].cpu(), out[1].cpu()))
        return out

    S.ring_codes_host = record
    try:
        eng, state, hist, counts, wall = run_variant(
            torch, np, "train_ring", sync="blocking",
            sync_wire="ring-int8")
    finally:
        S.ring_codes_host = real
    expect_counts("train_ring", eng.cfg, counts, ring_quantize=2 * 16,
                  ring_combine=2 * 12, sync_apply_update=2)
    d, q, s = seen[0]
    qc, sc = S.ring_codes_host(d)
    check(bool(torch.equal(q, qc)) and bool(torch.equal(s, sc)),
          "ring codes on the card differ from the CPU's")
    n = d.shape[1]
    mean = q.reshape(-1)[:n].float() * s[:, None].expand(q.shape).reshape(
        -1)[:n] / 127.0
    err = float((mean - d.mean(0)).abs().max())
    amax = float(d.abs().max())
    tol = S.ring_tolerance(W, amax)
    check(err <= tol, f"ring mean off the exact mean by {err} > {tol}")
    sync = S.make_sync(eng.run_cfg, spec=eng.spec)
    with torch.no_grad():
        ms = sync_ms(torch, lambda: sync(state))
    emit("train_ring", arch=eng.cfg.name, wire="ring-int8",
         rounds=[(t, h, loss) for t, h, loss, _ in hist], wall_s=wall,
         launches=counts, launches_per_sync={k: v / 2 for k, v in
                                             counts.items() if k in
                                             SYNC_KERNELS},
         codes_card_equal_cpu=True, chunk=q.shape[1], mean_err=err,
         delta_amax=amax, ring_tolerance=tol, sync_wall_ms=ms[0],
         sync_device_ms=ms[1])
    del eng, state, seen, d, q, s, qc, sc, mean
    torch.cuda.empty_cache()
    return counts


def phase_train_card_vs_cpu(torch, np):
    """ViT-B widths at 2 layers, W = 2, 2 images of 224^2 each, one round of
    H = 2: the same weights and batches on the card (kernels) and on the
    CPU (plain versions)."""
    from repro_torch import tree as T
    from repro_torch.core import local_update as LU
    from repro_torch.core.sync import make_sync
    from repro_torch.models import api, param as pm

    cfg, run, _, batch_fn, _ = train_setup(torch, n_layers=2, workers=2,
                                           b_loc=2, schedule="constant",
                                           total_steps=2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    card_p = pm.init_params(api.get_module(cfg).param_defs(cfg), gen,
                            device="cuda")
    host_p = T.map(lambda x: x.cpu(), card_p)
    states = {"cuda": LU.init_state(cfg, run, card_p, 2),
              "cpu": LU.init_state(cfg, run, host_p, 2)}
    step_fn = LU.make_local_step(cfg, run, with_metrics=True)
    sync = make_sync(run)
    losses = {"cuda": [], "cpu": []}
    for t in range(2):
        batch = batch_fn(t)
        for dev in ("cuda", "cpu"):
            b = T.map(lambda x: x.to(dev), batch)
            states[dev], (loss, _) = step_fn(states[dev], b, 6e-3)
            losses[dev].append(float(loss))
    with torch.no_grad():
        for dev in states:
            states[dev] = sync(states[dev])
    # losses: fp32 sums in another order, ~1e-6 relative; 1e-4 stated.
    # params after 2 AdamW steps: m / sqrt(v) flips where a gradient element
    # sits at the sum-order noise, so a few elements in 1e4 may move by up to
    # 2 lr per step differently: at most 1 in 2,000 beyond 1e-5, none beyond
    # 4 lr.
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    check(loss_err <= 1e-4, f"card vs CPU loss rel err {loss_err}")
    worst, n_off, n_all = 0.0, 0, 0
    for a, b in zip(T.leaves(states["cuda"]["params"]),
                    T.leaves(states["cpu"]["params"])):
        d = (a.cpu() - b).abs()
        off = int((d > 1e-5 * (1 + b.abs())).sum())
        check(off <= max(1, b.numel() // 2000),
              f"card vs CPU: {off} of {b.numel()} elements beyond 1e-5")
        worst = max(worst, float(d.max()))
        n_off, n_all = n_off + off, n_all + b.numel()
    check(worst <= 4 * 6e-3, f"card vs CPU params differ by {worst}")
    emit("train_card_vs_cpu", layers=cfg.n_layers, d_model=cfg.d_model,
         workers=2, b_loc=2, image=IMAGE, steps=2, losses_card=losses["cuda"],
         losses_cpu=losses["cpu"], max_loss_rel_err=loss_err,
         max_param_abs_err=worst, params_beyond_1e5=n_off, params=n_all)
    del states, card_p
    torch.cuda.empty_cache()


def phase_train_card_vs_cpu_overlap(torch, np):
    """sync="overlap" at depth 1 (int8 sync, outer momentum 0.9), ViT-B
    widths at 2 layers, W = 2, 2 images of 224^2 each, 2 rounds of H = 2 and
    the flush: the card (kernels, AdamW in place) against the CPU (plain
    versions) from the same weights.  Had the boundary params not been
    cloned before the stale step, the card's correction would collapse
    every lane onto the consensus and lose that step.  Same rules as
    `train_card_vs_cpu` on losses and the largest difference; the int8
    sync turns AdamW's sum-order noise into whole code levels where a
    delta sits near a rounding boundary, so the count is held at 1 in 100
    elements beyond 1e-5 (not 1 in 2,000) and the relative L2 within 1e-3.
    A lost stale step moves nearly every element."""
    from repro_torch import tree as T
    kw = dict(n_layers=2, workers=2, b_loc=2, layout="flat",
              schedule="constant", total_steps=4, sync_quantize=True,
              outer_momentum=0.9, sync="overlap", overlap_depth=1)
    cfg, _, _, _, eng_c = train_setup(torch, **kw)
    _, _, _, _, eng_h = train_setup(torch, device="cpu", **kw)
    card = eng_c.init_state()
    states = {"cuda": card,
              "cpu": T.map(lambda x: x.to("cpu", copy=True), card)}
    lr = 6e-3
    losses = {"cuda": [], "cpu": []}
    for dev, eng in (("cuda", eng_c), ("cpu", eng_h)):
        st = states[dev]
        for t in (0, 2):
            st, m = eng.run_round(st, t, 2, lambda i: lr)
            losses[dev].append(float(m["loss"]))
        states[dev] = eng.flush(st)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    a = states["cuda"]["params"]["float32"].cpu()
    b = states["cpu"]["params"]["float32"]
    d = (a - b).abs()
    off = int((d > 1e-5 * (1 + b.abs())).sum())
    worst, rel_l2 = float(d.max()), float(d.norm() / b.norm())
    emit("train_card_vs_cpu_overlap", layers=cfg.n_layers,
         d_model=cfg.d_model, workers=2, b_loc=2, image=IMAGE, depth=1,
         outer_momentum=0.9, losses_card=losses["cuda"],
         losses_cpu=losses["cpu"], max_loss_rel_err=loss_err,
         max_param_abs_err=worst, param_rel_l2=rel_l2,
         params_beyond_1e5=off, params=b.numel())
    check(loss_err <= 1e-4, f"overlap card vs CPU loss rel err {loss_err}")
    check(off <= b.numel() // 100,
          f"overlap card vs CPU: {off} of {b.numel()} elements beyond 1e-5")
    check(rel_l2 <= 1e-3, f"overlap card vs CPU params rel L2 {rel_l2}")
    check(worst <= 4 * lr, f"overlap card vs CPU params differ by {worst}")
    del states, card, eng_c, eng_h
    torch.cuda.empty_cache()


# ------------------------------------------------------- adaptive -------

# the adaptive recipe: TRAIN_RUN's 24 steps under the closed-loop controller
# (core/controller.py), on the flat layout with the int8 sync and the
# overlap sync; the card-vs-CPU gate's frontier (deeper overlap faster)
ADAPTIVE_RUN = dict(schedule="adaptive", layout="flat", sync="overlap",
                    sync_quantize=True, adaptive_batch=True)
ADAPTIVE_FRONTIER = {0: 1.0, 1: 0.6, 2: 0.5}


class StubEngine:
    """What the adaptive controller reads and sets on an engine, without
    one: the replayed controller's knobs."""

    def __init__(self, b_loc: int, sync_mode: str):
        self.b_loc, self.sync_mode = b_loc, sync_mode
        self.adaptive_batch = True
        self.batch_lanes, self.overlap_depth = b_loc, 0

    def batch_epoch(self, lanes):
        self.batch_lanes = lanes

    def set_overlap_depth(self, depth):
        self.overlap_depth = depth


@contextlib.contextmanager
def recorded_rounds(eng):
    """Inside: each round's (t, h, overlap depth, batch lanes, whether a
    pending sync is applied in it) as the engine starts it."""
    seen = []
    run_round = eng.run_round

    def recording(state, t, h, lr_fn):
        seen.append((t, h, eng.overlap_depth, eng.batch_lanes,
                     eng._pending is not None))
        return run_round(state, t, h, lr_fn)
    eng.run_round = recording
    try:
        yield seen
    finally:
        del eng.run_round


def phase_train_adaptive(torch, np, walls):
    """`--schedule adaptive` at full width: ViT-B/16, W = 4 x 32 images of
    224^2, TRAIN_RUN's 24 steps through `train()` on the flat layout with
    the int8 sync and sync="overlap", the controller choosing H, the
    effective batch and the overlap depth at every round boundary; its
    frontier a path to a table4-form JSON of `train_overlap`'s measured
    seconds a round at depths 0 and 1 (`walls`), its trace written into a
    temporary directory.

    Gates: the engine's H trace is the trace file's and sums to 24; every
    BatchEpoch lands on a round boundary with the lanes of that round's
    row, the lanes divide 32, never shrink and start at 16; the engine ran
    each round at the row's depth and lanes; nothing pending after
    `train()` and every lane equal; the launch counts exact (attention
    forward and backward a layer, worker and step, one adamw_update a step:
    one flat bucket; one sync_apply_update for each pending sync applied,
    the flush's included); a fresh controller with a stub engine, fed the
    card run's measured metrics round by round, rebuilds the trace byte
    for byte; the file parses as
    controller_trace/v1.  Returns the counts."""
    import tempfile

    from repro_torch import tree as T
    from repro_torch.core import local_update as LU
    from repro_torch.core.controller import (TRACE_SCHEMA,
                                             AdaptiveController,
                                             load_frontier)
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.optim.lr import make_lr_fn

    t_phase = time.perf_counter()
    phase = "train_adaptive"
    cfg, run, _, _, eng = train_setup(torch, **ADAPTIVE_RUN)
    with tempfile.TemporaryDirectory() as tmp:
        front_path = os.path.join(tmp, "table4_overlap.json")
        with open(front_path, "w") as fh:
            json.dump({"overlap": {tag: {"s_per_round": sec}
                                   for tag, sec in walls.items()}}, fh)
        trace_path = os.path.join(tmp, "controller_trace.json")
        frontier = load_frontier(front_path)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with recorded_rounds(eng) as seen:
            ops.reset_launch_counts()         # the path: counts at 0 ...
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, hist = train(cfg, run, workers=W, b_loc=B_LOC, seq=1,
                                data="host", layout="flat", sync="overlap",
                                eng=eng, frontier=front_path,
                                controller_trace=trace_path, log_every=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()      # ... read just after
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(trace_path) as fh:
            rec = json.load(fh)
    rows = rec["rounds"]
    check(rec["schema"] == TRACE_SCHEMA, f"{phase}: schema {rec['schema']}")
    trace = [(r["t"], r["h"]) for r in rows]
    check(eng.h_trace == trace == [(t - h, h) for t, h, _, _ in hist],
          f"{phase}: H trace {eng.h_trace} != the controller's {trace}")
    check(sum(h for _, h in trace) == run.total_steps == 24,
          f"{phase}: the rounds cover {sum(h for _, h in trace)} steps")
    lanes = [r["batch_lanes"] for r in rows]
    check(lanes[0] == B_LOC // 2 and lanes == sorted(lanes)
          and all(B_LOC % x == 0 for x in lanes),
          f"{phase}: batch lanes {lanes}")
    epochs = [dataclasses.asdict(e) for e in eng.batch_epochs]
    check(bool(epochs) and all(
        e["b_loc"] == B_LOC and 0 <= e["round_index"] < len(rows)
        and rows[e["round_index"]]["batch_lanes"] == e["lanes"]
        for e in epochs), f"{phase}: batch epochs {epochs}")
    check([(t, h, d, n) for t, h, d, n, _ in seen] == [
        (r["t"], r["h"], r["overlap_depth"], r["batch_lanes"])
        for r in rows], f"{phase}: the engine's rounds {seen} are not the "
          "trace's")
    check(eng._pending is None, f"{phase}: a sync pending after train()")
    check(lanes_equal(torch, state), f"{phase}: lanes differ after the flush")
    applied = sum(p for *_, p in seen) + 1          # the flush's too
    attn = cfg.n_layers * W * run.total_steps
    want = {k: 0 for k in counts}
    want.update(flash_attention_fwd=attn, flash_attention_bwd=attn,
                adamw_update=run.total_steps, sync_apply_update=applied)
    check(counts == want, f"{phase}: launch counts {counts} != {want}")
    # the decisions replayed: a fresh controller fed the card's telemetry
    ctrl = AdaptiveController(run, make_lr_fn(run),
                              engine=StubEngine(B_LOC, "overlap"),
                              frontier=frontier)
    for r in rows:
        check(ctrl.begin_round(r["t"]) == r["h"],
              f"{phase}: the replayed controller's H at {r['t']}")
        ctrl.end_round(r["t"], r["h"], r["measured"])
    replay = json.loads(json.dumps(ctrl.trace_record()))
    check(json.dumps(replay, sort_keys=True) == json.dumps(rec,
                                                           sort_keys=True),
          f"{phase}: the replayed trace differs from the card run's")
    for r in rows:
        emit("train_adaptive_round", t=r["t"], h=r["h"],
             h_prior=r["h_prior"], h_correction=r["h_correction"],
             lanes=r["batch_lanes"], depth=r["overlap_depth"],
             reasons=r["reasons"], loss=r["measured"]["loss"],
             divergence=r["measured"]["divergence"], seconds=0.0)

    # one local step's device time on the final state, at the final lanes
    data_s = eng.data_seconds
    step_fn = LU.make_local_step(cfg, run, with_metrics=True, spec=eng.spec)
    batch = eng._batch(0)
    state, _ = step_fn(state, batch, 1e-5)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(3):
        state, _ = step_fn(state, batch, 1e-5)
    ev[1].record()
    torch.cuda.synchronize()
    device_ms = ev[0].elapsed_time(ev[1]) / 3
    steps = run.total_steps
    wall_ms = wall / steps * 1e3
    emit(phase, arch=cfg.name, layers=cfg.n_layers, params=VIT_PARAMS,
         workers=W, b_loc=B_LOC, image=IMAGE, steps=steps, layout="flat",
         sync="overlap", sync_quantize=True, frontier_s_per_round=walls,
         frontier=rec["frontier"], rounds=len(rows), h_trace=trace,
         h_prior=[r["h_prior"] for r in rows],
         h_correction=[r["h_correction"] for r in rows], lanes=lanes,
         depths=[r["overlap_depth"] for r in rows],
         batch_epochs=epochs, summary=rec["summary"], wall_s=wall,
         wall_ms_per_step=wall_ms, data_ms_per_step=data_s / steps * 1e3,
         device_ms_per_step=device_ms, device_busy_share=device_ms / wall_ms,
         images_per_s_effective=sum(W * r["batch_lanes"] * r["h"]
                                    for r in rows) / wall,
         images_per_s_drawn=W * B_LOC * steps / wall,
         host_reads_per_round=4, launches=counts, pending_applied=applied,
         peak_mem_gb=peak_gb, replay_bitwise=True,
         lanes_equal_after_flush=True,
         seconds=time.perf_counter() - t_phase)
    del state, batch, eng, step_fn
    torch.cuda.empty_cache()
    return counts


def phase_train_adaptive_card_vs_cpu(torch, np):
    """The adaptive recipe at ViT-B widths cut to 2 layers, W = 2 x 4
    images of 224^2, 12 steps (both knobs move: the depth to 1 and back,
    the lanes 2 -> 4), with ADAPTIVE_FRONTIER: the card runs `train()` (its
    controller deciding on the card's telemetry, its weights drawn on the
    card from the engine's seed), the CPU engine (plain versions) replays
    the card's (h, lanes, depth) sequence from the same weights on the
    same batches.  `train_card_vs_cpu_overlap`'s bounds: per-round losses
    within 1e-4 relative, the final params' relative L2 within 1e-3; the
    batch epochs equal."""
    from repro_torch import tree as T
    from repro_torch.launch.train import train
    from repro_torch.models import api, param as pm
    from repro_torch.optim.lr import make_lr_fn

    t_phase = time.perf_counter()
    phase = "train_adaptive_card_vs_cpu"
    kw = dict(ADAPTIVE_RUN, n_layers=2, workers=2, b_loc=4, total_steps=12)
    cfg, run, _, _, eng_c = train_setup(torch, **kw)
    _, _, _, _, eng_h = train_setup(torch, device="cpu", **kw)
    # the weights train() draws on the card (engine seed, card generator)
    host_p = T.map(lambda x: x.cpu(), pm.init_params(
        api.get_module(cfg).param_defs(cfg),
        torch.Generator(device="cuda").manual_seed(eng_c.seed),
        device="cuda"))
    with recorded_rounds(eng_c) as seen:
        t0 = time.perf_counter()
        card, hist = train(cfg, run, workers=2, b_loc=4, seq=1, data="host",
                           layout="flat", sync="overlap", eng=eng_c,
                           frontier=ADAPTIVE_FRONTIER, log_every=0)
        card_s = time.perf_counter() - t0
    lr_fn = make_lr_fn(run)
    t0 = time.perf_counter()
    host = eng_h.init_state(host_p)
    for t, h, depth, lanes, _ in seen:
        if eng_h.batch_lanes != lanes:
            eng_h.batch_epoch(lanes)
        if eng_h.overlap_depth != depth:
            eng_h.set_overlap_depth(depth)
        host, _ = eng_h.run_round(host, t, h, lr_fn)
    host = eng_h.flush(host)
    cpu_s = time.perf_counter() - t0
    check(eng_h.h_trace == eng_c.h_trace and eng_h.batch_epochs
          == eng_c.batch_epochs, f"{phase}: the replay's rounds or epochs")
    losses = {dev: [float(m["loss"]) for m in e.round_metrics]
              for dev, e in (("cuda", eng_c), ("cpu", eng_h))}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
    a = card["params"]["float32"].cpu()
    b = host["params"]["float32"]
    d = (a - b).abs()
    off = int((d > 1e-5 * (1 + b.abs())).sum())
    worst, rel_l2 = float(d.max()), float(d.norm() / b.norm())
    emit(phase, layers=cfg.n_layers, d_model=cfg.d_model, workers=2,
         b_loc=4, image=IMAGE, steps=run.total_steps,
         frontier=ADAPTIVE_FRONTIER, h_trace=eng_c.h_trace,
         lanes=[r[3] for r in seen], depths=[r[2] for r in seen],
         batch_epochs=[dataclasses.asdict(e) for e in eng_c.batch_epochs],
         losses_card=losses["cuda"], losses_cpu=losses["cpu"],
         max_loss_rel_err=loss_err, param_rel_l2=rel_l2,
         max_param_abs_err=worst, params_beyond_1e5=off, params=b.numel(),
         card_s=card_s, cpu_s=cpu_s, seconds=time.perf_counter() - t_phase)
    check(loss_err <= 1e-4, f"{phase}: loss rel err {loss_err}")
    check(rel_l2 <= 1e-3, f"{phase}: params rel L2 {rel_l2}")
    del card, host, eng_c, eng_h
    torch.cuda.empty_cache()


def phase_train_microbatch(torch, np, lm_row):
    """`RunConfig.microbatch` 2 and 4 on `train_lm`'s path: starcoder2-3b
    at full width cut to 2 layers, W = 4 x 4 x 1024, one QSR round of H = 2
    through `train()` each, attention launched mb times a layer, worker
    and step at q[4/mb,1024,24,128]; each row's peak memory below
    `train_lm`'s (microbatch 1, the same recipe over 8 steps) and the
    device time of one step beside it.  Then the gate: one step from the
    same params (seed 3) on the same batch at microbatch 1, 2 and 4 with
    the kernels, and at 2 and 4 with the plain versions
    (`plain_versions_on_card`): every run's loss and grad norm within 1e-4
    relative of microbatch 1's, and each gradient leaf (AdamW's first
    moment after the step, over every lane) within 1e-4 relative L2, the
    LM gates' first-step rule.  Returns the runs' summed counts."""
    from repro_torch import tree as T
    from repro_torch.core import local_update as LU
    from repro_torch.data.synthetic import TokenStream, make_train_batch
    from repro_torch.models import api, param as pm

    t_phase = time.perf_counter()
    phase = "train_microbatch"
    total, rows = None, {}
    for mb in (2, 4):
        cfg, run, eng = lm_engine(n_layers=LM_LAYERS, workers=LM_W,
                                  b_loc=LM_B, seq=LM_SEQ, total_steps=2,
                                  microbatch=mb)
        state, rounds, counts, wall, peak_gb = run_lm(
            torch, np, phase, cfg, run, eng, [(0, 2)])
        attn = mb * cfg.n_layers * LM_W * 2
        want = {k: 0 for k in counts}
        want.update(flash_attention_fwd=attn, flash_attention_bwd=attn,
                    adamw_update=LM_LEAVES * 2)
        check(counts == want, f"{phase} {mb}: launch counts {counts} != "
              f"{want}")
        total = counts if total is None else {k: total[k] + counts[k]
                                              for k in counts}
        step_fn = LU.make_local_step(cfg, run, with_metrics=True)
        batch = eng._batch(0)
        state, _ = step_fn(state, batch, 1e-6)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(2):
            state, _ = step_fn(state, batch, 1e-6)
        ev[1].record()
        torch.cuda.synchronize()
        rows[mb] = dict(wall_s=wall, device_ms_per_step=ev[0].elapsed_time(
            ev[1]) / 2, peak_mem_gb=peak_gb, launches=counts,
            attention_shape=LM_MB_ATTN[mb], rounds=rounds)
        del state, batch, eng, step_fn
        torch.cuda.empty_cache()
    for mb, row in rows.items():
        check(row["peak_mem_gb"] < lm_row["peak_mem_gb"],
              f"{phase} {mb}: peak {row['peak_mem_gb']} GB not below "
              f"microbatch 1's {lm_row['peak_mem_gb']} GB")

    gc.collect()
    cfg, run = lm_setup(LM_LAYERS)
    p = pm.init_params(api.get_module(cfg).param_defs(cfg),
                       torch.Generator(device="cuda").manual_seed(3),
                       device="cuda")
    batch = T.map(lambda x: x.cuda(), make_train_batch(
        cfg, TokenStream(vocab=cfg.vocab, seed=0), 0, LM_W, LM_B, LM_SEQ))

    def first_step(mb, plain=False):
        """(loss, grad norm, AdamW's first moments by leaf) of one step
        from p at microbatch mb."""
        r = dataclasses.replace(run, microbatch=mb)
        st = LU.init_state(cfg, r, p, LM_W)
        with (plain_versions_on_card() if plain
              else contextlib.nullcontext()):
            st, (loss, gn) = LU.make_local_step(cfg, r, with_metrics=True)(
                st, batch, r.peak_lr)
        out = float(loss), float(gn), T.leaves(st["opt"]["m"])
        del st
        return out

    loss1, gn1, m1 = first_step(1)
    gate, fails = {}, []
    for mb, plain in ((2, False), (4, False), (2, True), (4, True)):
        loss, gn, m = first_step(mb, plain)
        errs = [float((a - b).norm() / b.norm().clamp_min(1e-30))
                for a, b in zip(m, m1)]
        del m
        torch.cuda.empty_cache()
        key = f"mb{mb}_{'plain' if plain else 'kernels'}"
        gate[key] = dict(loss=loss, grad_norm=gn,
                         loss_rel_err=abs(loss - loss1) / abs(loss1),
                         grad_norm_rel_err=abs(gn - gn1) / abs(gn1),
                         grad_rel_l2_by_leaf=errs)
        for name in ("loss_rel_err", "grad_norm_rel_err"):
            if gate[key][name] > 1e-4:
                fails.append(f"{key} {name} {gate[key][name]}")
        if max(errs) > 1e-4:
            fails.append(f"{key} gradient rel L2 {max(errs)}")
    emit(phase, arch=cfg.name, layers=cfg.n_layers, workers=LM_W,
         b_loc=LM_B, seq=LM_SEQ, steps=2,
         microbatch={str(mb): row for mb, row in rows.items()},
         microbatch1=dict(device_ms_per_step=lm_row["device_ms_per_step"],
                          peak_mem_gb=lm_row["peak_mem_gb"],
                          attention_shape=LM_TRAIN_ATTN),
         gate_mb1=dict(loss=loss1, grad_norm=gn1), gate=gate,
         failures=fails, seconds=time.perf_counter() - t_phase)
    check(not fails, f"{phase}: " + "; ".join(fails))
    del p, batch, m1
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------- LM -------

def lm_forward_flops(cfg, seqs: int, seq: int,
                     unembed_rows: int | None = None) -> float:
    """Matmul + attention FLOPs of the LM's forward over `seqs` sequences
    of `seq` tokens: every product of the layers, QK^T and PV over the
    (query, key) pairs each layer's causal window allows, and the tied
    unembedding of `unembed_rows` positions (all of them by default)."""
    d, hd = cfg.d_model, cfg.hd
    mlp = (3 if cfg.act == "swiglu" else 2) * d * cfg.d_ff
    per_layer = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + mlp
    pairs = sum(min(i + 1, w) if w else i + 1
                for layer in range(cfg.n_layers)
                for w in (cfg.layer_window(layer),) for i in range(seq))
    rows = seqs * seq if unembed_rows is None else unembed_rows
    return (seqs * (2.0 * seq * cfg.n_layers * per_layer
                    + pairs * cfg.n_heads * 4.0 * hd)
            + 2.0 * rows * d * cfg.vocab)


def whisper_forward_flops(cfg, seqs: int, seq: int) -> float:
    """Matmul + attention FLOPs of whisper's forward over `seqs` sequences
    of `seq` tokens: the encoder over enc_seq frames (bidirectional), the
    decoder's causal self-attention, its cross-attention (the keys and
    values projected from the memory) and the tied unembedding."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.enc_seq
    enc = cfg.n_enc_layers * (2.0 * e * (4 * d * d + 2 * d * f)
                              + 4.0 * e * e * d)
    dec = cfg.n_layers * (2.0 * seq * (4 * d * d + 2 * d * d + 2 * d * f)
                          + 2.0 * e * 2 * d * d
                          + 4.0 * d * (seq * (seq + 1) / 2 + seq * e))
    return seqs * (enc + dec + 2.0 * seq * d * cfg.vocab)


def lm_step_flops(cfg, seqs: int, seq: int) -> float:
    """One local step of the LM: forward + backward = 3x the forward."""
    return 3.0 * lm_forward_flops(cfg, seqs, seq)


def profile_device_ms(torch, fn, top: int = 12, by_op: bool = False,
                      count=()) -> dict:
    """Device time by kernel name over one call of `fn`, from
    torch.profiler's CUDA activity: the sum over every kernel and the `top`
    names by time, and the launches of the kernels whose names hold each
    string in `count`.  With `by_op` also the device time of the kernels each
    aten op launched itself (not through a nested op), and the device span
    from the first kernel's start to the last one's end (kernels and the
    gaps between), over a second call after one profiled as warm-up: a
    profile that starts with the call can miss its first kernels (also
    the call `count` reads).  The host waits PROFILE_MARGIN_S after the
    capture window opens and before it closes: with no wait the profiler
    lost some or all kernel records of the profiled call now and then,
    those whose device time, mapped onto the host's clock, falls outside
    the window (`tools/profile_window.py` counts them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    warm = by_op or bool(count)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)
                 if warm else None) as prof:
        for _ in range(2 if warm else 1):
            time.sleep(PROFILE_MARGIN_S)
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
            if warm:
                prof.step()
    averages = prof.key_averages()
    # with a schedule the step's own range shows as a device row: skip it
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in averages
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not e.key.startswith("ProfilerStep")),
                  key=lambda r: -r[1])
    out = {"kernel_ms": sum(r[1] for r in rows),
           "top": [dict(name=n[:100], ms=ms, calls=c)
                   for n, ms, c in rows[:top]],
           "calls": {m: sum(c for n, _, c in rows if m in n) for m in count}}
    if by_op:
        spans = [e.time_range for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        out["span_ms"] = (max(s.end for s in spans)
                          - min(s.start for s in spans)) / 1e3
        out["ops"] = {e.key: dict(ms=e.self_device_time_total / 1e3,
                                  calls=e.count)
                      for e in averages
                      if e.device_type == DeviceType.CPU
                      and e.self_device_time_total > 0}
    return out


def lm_setup(n_layers, arch=LM_ARCH, cut=None, **run_overrides):
    """(cfg, run config) of the LM recipe: `arch` (starcoder2-3b by
    default) at full width cut to `n_layers` decoder layers (None: the
    full depth) and by `cut`'s other fields (kimi-k2's experts)."""
    from repro_torch.configs import registry as R
    from repro_torch.configs.base import RunConfig
    cfg = R.get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    cfg = dataclasses.replace(cfg, **(cut or {}))
    return cfg, RunConfig(**{**LM_RUN, **run_overrides})


def lm_engine(*, n_layers, workers, b_loc, seq, arch=LM_ARCH, data="host",
              cut=None, **run_overrides):
    """(cfg, run config, engine on the card) of the LM recipe, the engine
    drawing from its built-in token stream on the host (`data="host"`)
    or on the card (`data="device"`)."""
    from repro_torch.core.engine import RoundEngine
    cfg, run = lm_setup(n_layers, arch, cut, **run_overrides)
    eng = RoundEngine(cfg, run, workers=workers, b_loc=b_loc, seq=seq,
                      data=data)
    return cfg, run, eng


def run_lm(torch, np, phase, cfg, run, eng, trace, n_params=None):
    """`train()` on the engine with the launch counts at 0 just before and
    read just after, every lane equal after every sync.  Returns (state,
    rounds, counts, wall s, peak GB); the wall holds the state's init on
    the card too (~0.05 s)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models import api, param as pm
    n_params = LM_PARAMS[cfg.n_layers] if n_params is None else n_params
    check(pm.count_params(api.get_module(cfg).param_defs(cfg))
          == n_params, f"{phase}: parameter count")
    check_s = [0.0]

    def eval_fn(t, state):              # after each round's sync
        t0 = time.perf_counter()
        check(lanes_equal(torch, state),
              f"{phase}: lanes differ after the sync at {t}")
        check_s[0] += time.perf_counter() - t0

    # whatever a previous phase left in reference cycles waits for the
    # garbage collector (engines and finished runs no longer make any:
    # `tools/grad_checks.py remat_cycle`): collect it, so this peak is
    # this path's
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()             # the path: counts at 0 ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = train(cfg, run, workers=eng.workers, b_loc=eng.b_loc,
                        seq=eng.seq, data=eng.data, eng=eng, eval_fn=eval_fn,
                        log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - check_s[0]
    counts = ops.launch_counts()          # ... read just after
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rounds = [dict(t_end=t, h=h, lr=lr, loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]),
                   divergence=float(m["divergence"]))
              for (t, h, _, lr), m in zip(hist, eng.round_metrics)]
    check(eng.h_trace == trace, f"{phase}: H trace {eng.h_trace} != {trace}")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
              for r in rounds), f"{phase}: a non-finite loss or grad norm")
    return state, rounds, counts, wall, peak_gb


def phase_train_lm(torch, np):
    """The LM training main path: starcoder2-3b at full width (2 layers),
    Local AdamW under QSR through `train()`, W = 4 x 4 sequences of 1024
    tokens from the built-in token stream, 8 steps.  Then the device time
    of one local step (CUDA events, the batch already on the card) and its
    kernels by name (torch.profiler)."""
    return train_lm_path(torch, np, "train_lm", LM_ARCH, LM_W, LM_B, LM_SEQ,
                         LM_PARAMS[2], lm_launches())


def lm_launches() -> dict:
    """starcoder2-3b's kernel launches in LM_STEPS steps at 2 layers and W
    = LM_W: attention forward and backward once a layer and worker, AdamW
    once a leaf."""
    attn = LM_LAYERS * LM_W * LM_STEPS
    return dict(flash_attention_fwd=attn, flash_attention_bwd=attn,
                adamw_update=LM_LEAVES * LM_STEPS)


def phase_train_gemma3(torch, np):
    """gemma3-4b training on the card: full width cut to 2 layers
    (859,845,120 parameters, 11 leaves), Local AdamW under QSR through
    `train()` with the LM recipe, W = 4 x 1 sequence of 1024 tokens, 8
    steps, tree layout, blocking sync, through `train_rms_swiglu`: every
    norm and MLP runs through the `_RmsNorm` / `_SwiGLU` autograd
    Functions.  Then the device time of one local step and its kernels, as
    `train_lm`."""
    return train_rms_swiglu(torch, np, "train_gemma3", G3_ARCH, G3_W,
                            G3_PARAMS, G3_LEAVES)


def phase_train_phi3(torch, np):
    """phi3-medium-14b training on the card: full width cut to 2 layers
    (1,709,204,480 parameters, 12 leaves with the untied head), the LM
    recipe, W = 2 x 1 sequence of 1024 tokens, 8 steps, as `train_gemma3`:
    every norm through `_RmsNorm` at d = 5120, and in a profiled step 10
    launches each of the staged forward and backward instances."""
    return train_rms_swiglu(torch, np, "train_phi3", PHI3_ARCH, PHI3_W,
                            PHI3_PARAMS[2], PHI3_LEAVES, staged=True)


def phase_train_paligemma(torch, np):
    """paligemma-3b training on the card: full width cut to 2 layers
    (746,989,568 parameters), the LM recipe, W = 4 x 1 x (256 stub image
    tokens + 1024 text tokens: the engine's vlm batches), 8 steps: every
    attention forward and backward with prefix_len 256."""
    return train_rms_swiglu(torch, np, "train_paligemma", VLM_ARCH, VLM_W,
                            VLM_PARAMS[2], VLM_LEAVES)


def train_rms_swiglu(torch, np, phase, arch, w, n_params, leaves,
                     staged=False):
    """An RMSNorm + SwiGLU model at 2 layers through `train_lm_path`, W = w
    x 1 x LM_SEQ, with its exact launches: per step and worker 5 rms_norm
    and rms_norm_bwd (two a layer, the final norm), one swiglu,
    swiglu_bwd and attention forward and backward a layer; and in a
    profiled step one swiglu forward tile and one dW and dX launch a layer
    and lane (`staged`: every norm on the staged instances, forward and
    backward)."""
    per_w = w * LM_STEPS
    norms, layers = 5 * per_w, 2 * per_w
    mlps = 2 * w
    calls = {"swiglu_tile_kernel": mlps, "swiglu_kernel": 0,
             "swiglu_dw_kernel": mlps, "swiglu_dx_kernel": mlps}
    if staged:
        calls.update({"rmsnorm_kernel<-2>": 5 * w,
                      "rmsnorm_bwd_kernel<-2>": 5 * w})
    return train_lm_path(
        torch, np, phase, arch, w, 1, LM_SEQ, n_params,
        dict(rms_norm=norms, rms_norm_bwd=norms, swiglu=layers,
             swiglu_bwd=layers, flash_attention_fwd=layers,
             flash_attention_bwd=layers, adamw_update=leaves * LM_STEPS),
        kernel_calls=calls)[0]


def train_lm_path(torch, np, phase, arch, w, b, seq, n_params, launches,
                  kernel_calls=None, n_layers=2, data="host", depth=None,
                  cut=None, **run_overrides):
    """`arch` at full width cut to `n_layers` layers (None: full depth)
    through `train()` (W = w x b sequences of `seq` tokens, LM_STEPS steps
    of the LM recipe, batches drawn on the host or on the card by `data`),
    its launch counts exactly `launches` (every other kernel 0), then one
    local step's device time and profile, in which the device kernels whose
    names hold each key of `kernel_calls` ran exactly its value times
    (gemma3: one swiglu forward tile a layer and lane, which keeps the
    pair, and its dW and dX launches: the backward recomputes no forward
    product), and the time to have one step's batch on the card.  Returns
    (the counts, the phase's line)."""
    t_phase = time.perf_counter()
    cfg, run, eng = lm_engine(n_layers=n_layers, workers=w, b_loc=b,
                              seq=seq, arch=arch, data=data, cut=cut,
                              **run_overrides)
    state, rounds, counts, wall, peak_gb = run_lm(
        torch, np, phase, cfg, run, eng, LM_TRACE, n_params)
    data_s = eng.data_seconds
    want = {k: 0 for k in counts}
    want.update(launches)
    check(counts == want, f"{phase}: launch counts {counts} != {want}")
    for r in rounds:
        emit(f"{phase}_round", **r)

    from repro_torch.core import local_update as LU
    step_fn = LU.make_local_step(cfg, run, with_metrics=True)
    # one step's batch on the card: drawn on the host and copied, or drawn
    # on the card (host clock, synchronised)
    batch_ms = []
    for step in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = eng._batch(step)
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    state, _ = step_fn(state, batch, 1e-6)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(2):
        state, _ = step_fn(state, batch, 1e-6)
    ev[1].record()
    torch.cuda.synchronize()
    device_ms = ev[0].elapsed_time(ev[1]) / 2
    prof = profile_device_ms(torch, lambda: step_fn(state, batch, 1e-6),
                             count=tuple(kernel_calls or ()))
    if kernel_calls:
        check(prof["calls"] == kernel_calls, f"{phase}: kernel calls in a "
              f"profiled step {prof['calls']} != {kernel_calls}")

    tokens = w * b * seq
    prefix = cfg.n_img_tokens if cfg.family == "vlm" else 0
    if cfg.family == "audio":
        flops = 3.0 * whisper_forward_flops(cfg, w * b, seq)
    elif cfg.family in ("ssm", "hybrid"):
        flops = 3.0 * ssm_forward_flops(cfg, w * b, seq)
    elif cfg.n_experts:
        flops = 3.0 * moe_forward_flops(cfg, w * b, seq)
    else:
        flops = 3.0 * lm_forward_flops(cfg, w * b, prefix + seq,
                                       unembed_rows=tokens)
    wall_ms = wall / LM_STEPS * 1e3
    row = dict(
        arch=cfg.name, layers=cfg.n_layers, enc_layers=cfg.n_enc_layers,
        d_model=cfg.d_model, params=n_params, workers=w, b_loc=b, seq=seq,
        prefix_len=prefix, steps=LM_STEPS, data=data, remat=run.remat,
        rounds=len(rounds),
        h_trace=eng.h_trace, layout="tree", sync="blocking", wall_s=wall,
        wall_ms_per_step=wall_ms, data_ms_per_step=data_s / LM_STEPS * 1e3,
        batch_on_card_ms=sorted(batch_ms)[1], device_ms_per_step=device_ms,
        device_busy_share=device_ms / wall_ms,
        tokens_per_s=tokens * LM_STEPS / wall, flop_per_step=flops,
        flop_floor_ms_per_step=flops / PEAK_FP32_FLOP_PER_S * 1e3,
        achieved_tflop_s=flops / device_ms / 1e9,
        profiled_step=prof, launches=counts,
        launches_per_step={k: v / LM_STEPS for k, v in counts.items()},
        peak_mem_gb=peak_gb, state_gb_p_m_v_grad=16.0 * n_params * w / 1e9,
        final_loss=rounds[-1]["loss"], lanes_equal_after_sync=True,
        seconds=time.perf_counter() - t_phase)
    if depth is not None:
        row["depth"] = depth
    emit(phase, **row)
    del state, batch, eng
    torch.cuda.empty_cache()
    return counts, row


def phase_train_lm_full_depth(torch, np):
    """starcoder2-3b at all 30 layers: W = 1, 1 sequence of 1024 tokens,
    remat on, 2 steps (one QSR round).  With remat every layer's forward
    runs again in the backward: 2 L attention forwards a step.  Peak memory
    beside what the state holds: params, AdamW's m and v, and the
    gradient."""
    cfg, run, eng = lm_engine(n_layers=30, workers=1, b_loc=1, seq=LM_SEQ,
                              total_steps=2, remat=True)
    state, rounds, counts, wall, peak_gb = run_lm(
        torch, np, "train_lm_full_depth", cfg, run, eng, [(0, 2)])
    steps = 2
    want = {k: 0 for k in counts}
    want.update(flash_attention_fwd=2 * cfg.n_layers * steps,
                flash_attention_bwd=cfg.n_layers * steps,
                adamw_update=LM_LEAVES * steps)
    check(counts == want,
          f"train_lm_full_depth: launch counts {counts} != {want}")
    n = LM_PARAMS[cfg.n_layers]
    flops = lm_step_flops(cfg, 1, LM_SEQ)
    emit("train_lm_full_depth", arch=cfg.name, layers=cfg.n_layers,
         params=n, workers=1, b_loc=1, seq=LM_SEQ, steps=steps, remat=True,
         rounds=rounds, wall_s=wall,
         wall_ms_per_step=wall / steps * 1e3,
         tokens_per_s=LM_SEQ * steps / wall, flop_per_step_no_remat=flops,
         flop_floor_ms_per_step_no_remat=flops / PEAK_FP32_FLOP_PER_S * 1e3,
         launches=counts, peak_mem_gb=peak_gb,
         state_gb_p_m_v_grad=4 * 4 * n / 1e9, lanes_equal_after_sync=True)
    del state, eng
    torch.cuda.empty_cache()


def host_available_gb() -> float:
    """The machine's available host memory (MemAvailable), GB."""
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def watch_host_memory() -> dict:
    """The machine's lowest available host memory over the run, sampled
    every 2 s on a daemon thread: {"gb", "after": the phase of the last
    line printed before it}."""
    import threading
    low = {"gb": host_available_gb(), "after": _LAST_PHASE[0]}

    def sample():
        while True:
            time.sleep(2)
            gb = host_available_gb()
            if gb < low["gb"]:
                low.update(gb=gb, after=_LAST_PHASE[0])

    threading.Thread(target=sample, daemon=True).start()
    return low


@contextlib.contextmanager
def plain_versions_on_card():
    """ops' rms_norm, swiglu and attention (the seam of the full-sequence
    and the decode kernels) take their plain versions on the card
    (autograd of `kernels/ref.py`, cuBLAS for the products) while inside:
    the sum order of the card without the port's kernels, as a
    yardstick."""
    from repro_torch.kernels import ops, ref
    saved = ops.rms_norm, ops.swiglu, ops.flash_attention
    ops.rms_norm, ops.swiglu = ref.rms_norm, ref.swiglu
    ops.flash_attention = ref.attention
    try:
        yield
    finally:
        ops.rms_norm, ops.swiglu, ops.flash_attention = saved


# the training card-vs-CPU phases by arch
TRAIN_CARD_VS_CPU = {LM_ARCH: "train_lm_card_vs_cpu",
                     G3_ARCH: "train_gemma3_card_vs_cpu",
                     PHI3_ARCH: "train_phi3_card_vs_cpu",
                     VLM_ARCH: "train_paligemma_card_vs_cpu",
                     WH_ARCH: "train_whisper_card_vs_cpu",
                     M2_ARCH: "train_mamba2_card_vs_cpu",
                     Z2_ARCH: "train_zamba2_card_vs_cpu"}
# their depth (2 layers unless named) and sequence (128 unless named)
TRAIN_GATE_LAYERS = {Z2_ARCH: Z2_TRAIN_LAYERS}
TRAIN_GATE_SEQ = dict(SSM_GATE_SEQ)


def phase_train_lm_card_vs_cpu(torch, np, arch, gate):
    """`arch` (starcoder2-3b, or an RMSNorm + SwiGLU model through the
    rms_norm / swiglu backward kernels: gemma3-4b, phi3-medium-14b,
    paligemma-3b with its image prefix; or whisper-base, its decoder cut to
    2 layers, its 6 encoder layers over the batches' 1500 stub frames; or
    an SSM through the rms_norm backward kernel: mamba2-130m, zamba2-1.2b
    at TRAIN_GATE_LAYERS with its shared attention block) at full width
    cut to 2 layers (or TRAIN_GATE_LAYERS), W = 2, 1 sequence of 128 tokens
    each (or TRAIN_GATE_SEQ: the SSMs' whole 256-token SSD chunks), one
    round of H = 2 at the recipe's peak lr: the same weights and batches on the card (kernels) and on the
    CPU (plain versions).  Loss and grad norm within 1e-4 relative (an
    SSM's at the second step within twice the plain card's distance, or
    1e-4: see below);
    params: at most 1 element in 2,000 of each leaf beyond 1e-5 (AdamW's
    first steps flip where a gradient sits at the sum-order noise), none
    beyond 4 lr.

    gemma3-4b's second step runs at a grad norm of ~650 (the first AdamW
    step moves every weight by ~lr), which turns sum-order noise into more
    flips: its attention's wq and wk leave the 1-in-2,000 rule on the card
    even with no kernel of the port (PERF.md §6).  So for the models that
    train through the backward kernels the card also runs the round with
    the plain versions (`plain_versions_on_card`) and each leaf's elements
    beyond 1e-5 are held to at most 1.5 times that run's count against the
    CPU (or 1 in 2,000): the kernels may move the trajectory no further
    than the card's own sum order does.  whisper's round is held the same
    way: its attention kernels run at shapes no other gate has (the cross
    backward at Sq 128 against Sk 1500, the encoder's with dS in key
    chunks).

    mamba2's and zamba2's gates run the plain versions on the card too.
    Their first step agrees (the same params on both sides: zamba2's
    gradient leaves ~3e-4 relative apart with or without the port's
    kernels); the first AdamW step then moves each element whose gradient
    sits at that noise by +-lr on either side, and zamba2's second grad
    norm parts from the CPU's by ~1.5% on the card's plain run alone (55%
    of its elements then lie beyond 1e-5 after the round, mamba2's 0.5%,
    with or without the kernels).  So for them: the second step's loss and
    grad norm within twice the plain card's distance (or 1e-4); lane 0's
    first-step gradient, leaf by leaf at the same params, within 1e-4 (rel
    L2) or twice the plain card's; and the elements beyond 1e-5 after the
    round, over all leaves, at most twice the plain card's count (leaf by
    leaf the counts of the small leaves, 96 elements of A_log, are too few
    to compare).

    The CPU holds 16 bytes a parameter a worker (gemma3-4b: 27.5 GB at W =
    2); W drops to 1 where the host's available memory is under twice
    that.

    `gate` (from `gate_setup`, its CPU side submitted to a background
    thread by `start_gate_cpu_sides` at the start of the run) brings the
    params, the batches and the CPU side's future."""
    from repro_torch.kernels import ops

    phase = TRAIN_CARD_VS_CPU[arch]
    gc.collect()                          # earlier phases' cycles (run_lm)
    cfg, run, w, seq = gate["cfg"], gate["run"], gate["w"], gate["seq"]
    state_gb, host_gb = gate["state_gb"], gate["host_gb"]
    backward_kernels = cfg.norm == "rmsnorm"
    yardstick = backward_kernels or cfg.family == "audio"
    lr = run.peak_lr
    rollout = lambda dev: gate_rollout(torch, gate, dev)  # noqa: E731
    first_grads = lambda dev: gate_first_grads(torch, gate, dev)  # noqa: E731
    ssm = cfg.family in ("ssm", "hybrid")

    ops.reset_launch_counts()             # the kernels' round alone counts
    card, losses_card, gns_card, card_s = rollout("cuda")
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    t_wait = time.perf_counter()
    cpu_side = gate["cpu"].result()
    cpu_wait_s = time.perf_counter() - t_wait
    host, losses_cpu, gns_cpu, cpu_s = cpu_side["rollout"]
    grad_errs = None
    if ssm:
        # the first step's gradients at the same params, leaf by leaf: the
        # kernels' distance from the CPU against the plain card's
        want_g = cpu_side["first_grads"]
        got_g = first_grads("cuda")
        with plain_versions_on_card():
            plain_g = first_grads("cuda")
        grad_errs = {way: [float((a - b).norm() / b.norm().clamp_min(1e-30))
                           for a, b in zip(gs, want_g)]
                     for way, gs in (("kernels", got_g), ("plain", plain_g))}
        del want_g, got_g, plain_g

    def beyond(a, b):
        """(elements of a more than 1e-5 (1 + |b|) from b, the largest
        |a - b|), over chunks of 2^20 elements: whole, a leaf of 1.3 G
        elements made six full-size temporaries on the host."""
        a, b = a.reshape(-1), b.reshape(-1)
        off, big, step = 0, 0.0, 1 << 20
        for i in range(0, a.numel(), step):
            bi = b[i:i + step]
            d = (a[i:i + step] - bi).abs()
            off += int((d > 1e-5 * (1 + bi.abs())).sum())
            big = max(big, float(d.max()))
        return off, big

    def rel(xs, ys):
        return [abs(a - b) / abs(b) for a, b in zip(xs, ys)]
    plain_off, plain_metrics = None, None
    limits = dict(loss=[1e-4] * 2, grad_norm=[1e-4] * 2)
    if yardstick:
        with plain_versions_on_card():
            plain, plain_losses, plain_gns, _ = rollout("cuda")
        plain_off = [beyond(a, b)[0] for a, b in zip(plain, host)]
        plain_metrics = dict(loss=rel(plain_losses, losses_cpu),
                             grad_norm=rel(plain_gns, gns_cpu))
        del plain
        if cfg.family in ("ssm", "hybrid"):
            # an SSM's second step follows the first AdamW step, which
            # moves every element whose gradient sits at the sum-order
            # noise by +-lr on either side; its loss and grad norm are held
            # to twice the plain card's distance from the CPU (zamba2's
            # grad norm there parts by ~1.5% without any port kernel)
            for k in limits:
                limits[k][1] = max(1e-4, 2 * plain_metrics[k][1])
    # every comparison is made and the line printed before a failure stops
    # the run
    fails = []
    errs = dict(loss=rel(losses_card, losses_cpu),
                grad_norm=rel(gns_card, gns_cpu))
    for k in errs:
        for step, (e, lim) in enumerate(zip(errs[k], limits[k])):
            if e > lim:
                fails.append(f"{k} rel err {e} > {lim} at step {step}")
    loss_err, gn_err = max(errs["loss"]), max(errs["grad_norm"])
    if backward_kernels:
        mlps = 0 if cfg.family in ("ssm", "hybrid") else cfg.n_layers
        check(counts.get("rms_norm_bwd", 0) == 2 * norms_per_pass(cfg) * w
              and counts.get("swiglu_bwd", 0) == 2 * mlps * w,
              f"{phase}: backward kernel launches {counts}")
    if ssm:
        for i, (e, ep) in enumerate(zip(grad_errs["kernels"],
                                        grad_errs["plain"])):
            if e > max(1e-4, 2 * ep):
                fails.append(f"first-step gradient of leaf {i}: rel L2 err "
                             f"{e} > max(1e-4, 2 x the plain card's {ep})")
    worst, n_off, n_all, offs = 0.0, 0, 0, []
    for i, (a, b) in enumerate(zip(card, host)):
        off, big = beyond(a, b)
        limit = max(1, b.numel() // 2000)
        if plain_off is not None:
            limit = max(limit, int(1.5 * plain_off[i]))
        if off > limit and not ssm:
            fails.append(f"{off} of {b.numel()} elements of leaf {i} beyond "
                         f"1e-5 (limit {limit})")
        worst = max(worst, big)
        n_off, n_all = n_off + off, n_all + b.numel()
        offs.append(off)
    if ssm and n_off > 2 * sum(plain_off):
        fails.append(f"{n_off} elements beyond 1e-5 > twice the plain "
                     f"card's {sum(plain_off)}")
    if worst > 4 * lr:
        fails.append(f"params differ by {worst}")
    emit(phase, arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, workers=w, b_loc=1, seq=seq, steps=2,
         host_available_gb=host_gb, cpu_state_gb=state_gb / 2 * w,
         card_launches=counts, losses_card=losses_card,
         losses_cpu=losses_cpu, grad_norms_card=gns_card,
         grad_norms_cpu=gns_cpu, max_loss_rel_err=loss_err,
         max_grad_norm_rel_err=gn_err, rel_errs_by_step=errs,
         limits_by_step=limits, plain_card_rel_errs_by_step=plain_metrics,
         max_param_abs_err=worst,
         params_beyond_1e5=n_off, params=n_all, beyond_1e5_by_leaf=offs,
         plain_card_beyond_1e5_by_leaf=plain_off,
         first_grad_rel_errs_by_leaf=grad_errs, card_s=card_s,
         cpu_s=cpu_s, cpu_wait_s=cpu_wait_s, failures=fails)
    check(not fails, f"{phase}: " + "; ".join(fails))
    del card, host, cpu_side
    gate.clear()
    torch.cuda.empty_cache()


def gate_setup(torch, arch) -> dict:
    """The inputs of `arch`'s training card-vs-CPU gate: the config at
    TRAIN_GATE_LAYERS, W (2, or 1 where the host's available memory is
    under twice the CPU state), the params drawn on the card from seed 3
    and kept on the host, and the two steps' batches."""
    from repro_torch import tree as T
    from repro_torch.data.synthetic import TokenStream, make_train_batch
    from repro_torch.models import api, param as pm

    seq = TRAIN_GATE_SEQ.get(arch, 128)
    cfg, run = lm_setup(TRAIN_GATE_LAYERS.get(arch, 2), arch)
    defs = api.get_module(cfg).param_defs(cfg)
    state_gb = 16.0 * pm.count_params(defs) * 2 / 1e9
    host_gb = host_available_gb()
    w = 2 if not host_gb < 2 * state_gb else 1
    gen = torch.Generator(device="cuda").manual_seed(3)
    host_p = T.map(lambda x: x.cpu(), pm.init_params(defs, gen,
                                                     device="cuda"))
    torch.cuda.empty_cache()
    stream = TokenStream(vocab=cfg.vocab, seed=0)
    batches = [make_train_batch(cfg, stream, t, w, 1, seq) for t in range(2)]
    return dict(arch=arch, cfg=cfg, run=run, w=w, seq=seq,
                state_gb=state_gb, host_gb=host_gb, host_p=host_p,
                batches=batches)


def gate_rollout(torch, gate, dev):
    """The gate's round from its params on `dev`: (params on the host,
    losses, grad norms, seconds)."""
    from repro_torch import tree as T
    from repro_torch.core import local_update as LU
    from repro_torch.core.sync import make_sync

    cfg, run, w = gate["cfg"], gate["run"], gate["w"]
    step_fn = LU.make_local_step(cfg, run, with_metrics=True)
    sync = make_sync(run)
    t0 = time.perf_counter()
    st = LU.init_state(cfg, run, T.map(lambda x: x.to(dev), gate["host_p"]),
                       w)
    losses, gns = [], []
    for batch in gate["batches"]:
        st, (loss, gn) = step_fn(st, T.map(lambda x: x.to(dev), batch),
                                 run.peak_lr)
        losses.append(float(loss))
        gns.append(float(gn))
    with torch.no_grad():
        st = sync(st)
    out = T.leaves(T.map(lambda x: x.cpu(), st["params"]))
    del st
    if dev != "cpu":
        torch.cuda.empty_cache()
    return out, losses, gns, time.perf_counter() - t0


def gate_first_grads(torch, gate, dev):
    """Lane 0's gradient at the gate's params on its first batch, by
    leaf."""
    from repro_torch import tree as T
    from repro_torch.models import api

    cfg = gate["cfg"]
    leaves, treedef = T.flatten(gate["host_p"])
    alias = [x.to(dev).requires_grad_(True) for x in leaves]
    b = {k: v[0].to(dev) for k, v in gate["batches"][0].items()}
    loss = api.get_module(cfg).loss_fn(cfg, T.unflatten(treedef, alias), b,
                                       remat=False)
    return [g.cpu() for g in torch.autograd.grad(loss, alias)]


def gate_cpu_side(torch, gate) -> dict:
    """The CPU side of a training gate: the round (and an SSM's first-step
    gradients) on the CPU's plain versions."""
    out = {"rollout": gate_rollout(torch, gate, "cpu")}
    if gate["cfg"].family in ("ssm", "hybrid"):
        out["first_grads"] = gate_first_grads(torch, gate, "cpu")
    return out


def start_gate_cpu_sides(torch) -> dict:
    """Every training card-vs-CPU gate's inputs, set up now (their params
    drawn on the card, which is empty at the start of the run), and their
    CPU sides submitted in order to one background thread: the CPU
    computes them beside the card's phases, and each gate then waits only
    for what is left of its own.  Torch's CPU ops release the GIL, so the
    thread runs beside the main thread's host work (both share the host's
    cores)."""
    import concurrent.futures
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    gates = {}
    for arch in TRAIN_CARD_VS_CPU:
        gate = gate_setup(torch, arch)
        gate["cpu"] = pool.submit(gate_cpu_side, torch, gate)
        gates[arch] = gate
    pool.shutdown(wait=False)
    return gates


def phase_generate(torch, np, cfg, weights, rows):
    """gemma3-4b at full width: one-shot `generate` of GEN_B prompts x
    GEN_PLEN tokens, GEN_NEW new, greedy, with the launch counts at 0 just
    before and read just after (one prefill, then one decode step per new
    token); its tokens equal the `--slots 2` service's for the same prompts
    (which feeds each prompt through decode steps), and its prefill's
    last-position logits equal those of the prompt fed through
    `decode_step` within PREFILL_TOL.  Then a prefill of PREFILL_B x
    PREFILL_LEN tokens: device ms (CUDA events), its launches, and its
    kernels by name (torch.profiler), beside the kernels' isolated times
    from this run's kernel rows.  Returns the generate path's counts."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate, run_service
    from repro_torch.models import api

    mod = api.get_module(cfg)
    tree = weights.as_tree()
    n_l = cfg.n_layers
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, cfg.vocab, (GEN_B, GEN_PLEN), dtype=np.int32)
    ops.reset_launch_counts()             # the path: counts at 0 ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(cfg, tree, prompts, gen_len=GEN_NEW)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    counts = ops.launch_counts()          # ... read just after
    want = {k: 0 for k in counts}
    want.update(rms_norm=(2 * n_l + 1) * (GEN_NEW + 1),
                swiglu=n_l * (GEN_NEW + 1), flash_attention_fwd=n_l,
                flash_decode=n_l * GEN_NEW)
    check(counts == want, f"generate: launch counts {counts} != {want}")
    check(tuple(toks.shape) == (GEN_B, GEN_PLEN + GEN_NEW)
          and bool(torch.equal(toks[:, :GEN_PLEN].cpu(),
                               torch.from_numpy(prompts))),
          f"generate: tokens of shape {tuple(toks.shape)}")
    got = toks[:, GEN_PLEN:].cpu().tolist()
    reqs, _ = run_service(cfg, weights, list(prompts), slots=SLOTS,
                          max_new=GEN_NEW, max_len=GEN_PLEN + GEN_NEW)
    for r in reqs:
        check(r.out == got[r.rid], f"generate row {r.rid}: {got[r.rid]} != "
              f"the --slots {SLOTS} service's {r.out}")

    with torch.no_grad():
        pt = torch.from_numpy(prompts).cuda()
        lp, _ = mod.prefill(cfg, tree, pt, mod.init_cache(
            cfg, GEN_B, GEN_PLEN, device="cuda"))
        cache = mod.init_cache(cfg, GEN_B, GEN_PLEN, device="cuda")
        for i in range(GEN_PLEN):
            ld, cache = mod.decode_step(cfg, tree, pt[:, i], cache, i)
    err, scale = float((lp - ld).abs().max()), float(ld.abs().max())
    tol = PREFILL_TOL * max(scale, 1.0)
    check(err <= tol, f"prefill vs decode logits differ by {err} > {tol}")
    check(bool(torch.equal(lp.argmax(-1), ld.argmax(-1))),
          "prefill vs decode: another greedy token")
    del cache, lp, ld

    # a prefill of PREFILL_B x PREFILL_LEN tokens
    pt = torch.from_numpy(rng.integers(0, cfg.vocab, (PREFILL_B, PREFILL_LEN),
                                       dtype=np.int32)).cuda()
    cache = mod.init_cache(cfg, PREFILL_B, PREFILL_LEN, device="cuda")
    with torch.no_grad():
        mod.prefill(cfg, tree, pt, cache)      # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        mod.prefill(cfg, tree, pt, cache)
        ev[1].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        pre_counts = {k: v for k, v in ops.launch_counts().items() if v}
        prof = profile_device_ms(torch,
                                 lambda: mod.prefill(cfg, tree, pt, cache))
    device_ms = ev[0].elapsed_time(ev[1])
    want = dict(rms_norm=2 * n_l + 1, swiglu=n_l, flash_attention_fwd=n_l)
    check(pre_counts == want, f"prefill launches {pre_counts} != {want}")
    n_global = sum(cfg.layer_window(i) == 0 for i in range(n_l))
    rows_ms = dict(
        swiglu=n_l * rows["swiglu", f"[{PREFILL_B * PREFILL_LEN},"
                          f"{cfg.d_model}]x[{cfg.d_model},{cfg.d_ff}]"]["ms"],
        flash_attention_fwd=(
            (n_l - n_global) * rows["flash_attention_fwd",
                                    PREFILL_ATTN[0]]["ms"]
            + n_global * rows["flash_attention_fwd", PREFILL_ATTN[1]]["ms"]),
        rms_norm=2 * n_l * rows["rms_norm", f"[{PREFILL_B * PREFILL_LEN},"
                                f"{cfg.d_model}]"]["ms"])
    emit("generate", arch=cfg.name, layers=n_l, prompts=GEN_B,
         prompt_len=GEN_PLEN, new_tokens=GEN_NEW, wall_s=gen_wall,
         tokens_per_s=GEN_B * GEN_NEW / gen_wall, launches=counts,
         equals_slots_service=True, prefill_vs_decode_max_abs_err=err,
         prefill_vs_decode_tol=tol)
    emit("prefill", arch=cfg.name, layers=n_l, batch=PREFILL_B,
         prompt_len=PREFILL_LEN, global_layers=n_global, wall_ms=wall_ms,
         device_ms=device_ms, tokens_per_s=PREFILL_B * PREFILL_LEN / wall_ms
         * 1e3, launches=pre_counts, profiled=prof,
         kernel_rows_ms_x_launches=rows_ms,
         flop=lm_forward_flops(cfg, PREFILL_B, PREFILL_LEN,
                               unembed_rows=PREFILL_B))
    del cache, pt
    torch.cuda.empty_cache()
    return counts


def phase_generate_paligemma(torch, np, rows):
    """paligemma-3b at full width and all 18 layers (random weights from
    seed 0 on the card): one-shot `generate` of GEN_B prompts x GEN_PLEN
    tokens after the 256-token stub image prefix (`serve.image_prefix`,
    the CLI's), GEN_NEW new, greedy, with the launch counts at 0 just
    before and read just after: the prefill runs `flash_attention` with
    prefix_len 256 over 256 + 32 rows, each decode step `flash_decode` at G
    = 8, D = 256 with prefix_len 256.  Its prefill's last-position logits
    equal those of the prefix and first token prefilled and the rest of the
    prompt fed through `decode_step`, within PREFILL_TOL; the prefix moves
    the logits (a text-only prefill differs).  Then a prefill of PREFILL_B
    x (256 + PREFILL_LEN) rows: device ms, launches, kernels by name.
    Returns the generate path's counts."""
    from repro_torch.configs import registry as R
    from repro_torch.kernels import ops
    from repro_torch.launch import weights as W
    from repro_torch.launch.serve import generate, image_prefix
    from repro_torch.models import api

    cfg = R.get_config(VLM_ARCH)
    n_l, p = cfg.n_layers, cfg.n_img_tokens
    check(p == VLM_PREFIX, f"paligemma: {p} image tokens")
    mod = api.get_module(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    weights = W.ServingWeights.from_seed(cfg, 0, device="cuda")
    n_params = sum(b.numel() for b in weights.bufs.values())
    check(n_params == VLM_PARAMS[18], f"paligemma has {n_params} params")
    tree = weights.as_tree()
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, cfg.vocab, (GEN_B, GEN_PLEN), dtype=np.int32)
    extra = image_prefix(cfg, GEN_B, "cuda")
    ops.reset_launch_counts()             # the path: counts at 0 ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(cfg, tree, prompts, gen_len=GEN_NEW, extra=extra)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    counts = ops.launch_counts()          # ... read just after
    want = {k: 0 for k in counts}
    want.update(generate_launches(cfg, GEN_NEW))
    check(counts == want, f"paligemma generate: launches {counts} != {want}")
    check(tuple(toks.shape) == (GEN_B, GEN_PLEN + GEN_NEW)
          and bool(torch.equal(toks[:, :GEN_PLEN].cpu(),
                               torch.from_numpy(prompts))),
          f"paligemma generate: tokens of shape {tuple(toks.shape)}")

    pre = extra["prefix_embeds"]
    with torch.no_grad():
        pt = torch.from_numpy(prompts).cuda()
        lp, _ = mod.prefill(cfg, tree, pt, mod.init_cache(
            cfg, GEN_B, p + GEN_PLEN, device="cuda"), prefix_embeds=pre)
        cache = mod.init_cache(cfg, GEN_B, p + GEN_PLEN, device="cuda")
        _, cache = mod.prefill(cfg, tree, pt[:, :1], cache,
                               prefix_embeds=pre)
        for i in range(1, GEN_PLEN):
            ld, cache = mod.decode_step(cfg, tree, pt[:, i], cache, p + i,
                                        prefix_len=p)
        lt, _ = mod.prefill(cfg, tree, pt, mod.init_cache(
            cfg, GEN_B, GEN_PLEN, device="cuda"))
    err, scale = float((lp - ld).abs().max()), float(ld.abs().max())
    tol = PREFILL_TOL * max(scale, 1.0)
    check(err <= tol, f"paligemma prefill vs decode logits differ by {err} "
          f"> {tol}")
    check(bool(torch.equal(lp.argmax(-1), ld.argmax(-1))),
          "paligemma prefill vs decode: another greedy token")
    text_only = float((lp - lt).abs().max())
    check(text_only > tol, "paligemma: the image prefix does not move the "
          f"logits ({text_only})")
    del cache, lp, ld, lt

    # a prefill of PREFILL_B x (prefix + PREFILL_LEN) rows
    pt = torch.from_numpy(rng.integers(0, cfg.vocab, (PREFILL_B, PREFILL_LEN),
                                       dtype=np.int32)).cuda()
    pre = image_prefix(cfg, PREFILL_B, "cuda")["prefix_embeds"]
    cache = mod.init_cache(cfg, PREFILL_B, p + PREFILL_LEN, device="cuda")
    with torch.no_grad():
        mod.prefill(cfg, tree, pt, cache, prefix_embeds=pre)   # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        mod.prefill(cfg, tree, pt, cache, prefix_embeds=pre)
        ev[1].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        pre_counts = {k: v for k, v in ops.launch_counts().items() if v}
        prof = profile_device_ms(torch, lambda: mod.prefill(
            cfg, tree, pt, cache, prefix_embeds=pre))
    device_ms = ev[0].elapsed_time(ev[1])
    want = dict(rms_norm=2 * n_l + 1, swiglu=n_l, flash_attention_fwd=n_l)
    check(pre_counts == want, f"paligemma prefill launches {pre_counts} != "
          f"{want}")
    rows_ms = dict(flash_attention_fwd=n_l * rows[
        "flash_attention_fwd", VLM_ATTN[1]]["ms"])
    emit("generate_paligemma", arch=cfg.name, layers=n_l, params=n_params,
         prefix_len=p, prompts=GEN_B, prompt_len=GEN_PLEN,
         new_tokens=GEN_NEW, wall_s=gen_wall,
         tokens_per_s=GEN_B * GEN_NEW / gen_wall, launches=counts,
         prefill_vs_decode_max_abs_err=err, prefill_vs_decode_tol=tol,
         text_only_max_abs_diff=text_only,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("prefill_paligemma", arch=cfg.name, layers=n_l, batch=PREFILL_B,
         prefix_len=p, prompt_len=PREFILL_LEN, wall_ms=wall_ms,
         device_ms=device_ms,
         rows_per_s=PREFILL_B * (p + PREFILL_LEN) / wall_ms * 1e3,
         launches=pre_counts, profiled=prof,
         kernel_rows_ms_x_launches=rows_ms,
         flop=lm_forward_flops(cfg, PREFILL_B, p + PREFILL_LEN,
                               unembed_rows=PREFILL_B))
    del cache, pt, pre, weights, tree, toks, extra
    torch.cuda.empty_cache()
    return counts


def step_times(torch, fn, reps: int = 5) -> dict:
    """One call of `fn` (a decode step or a prefill, eager) on the card:
    `ms`, CUDA events around `reps` calls back to back (the host's launch
    gaps included), and `kernel_ms`, the sum of the device kernels of one
    profiled call (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    prof = profile_device_ms(torch, fn, top=6)
    return dict(ms=ev[0].elapsed_time(ev[1]) / reps,
                kernel_ms=prof["kernel_ms"], top=prof["top"])


def phase_generate_whisper(torch, np):
    """whisper-base at full width and depth (random weights from seed 0 on
    the card): one-shot `generate` of WH_B prompts x WH_PLEN tokens after
    the CLI's stub frames (`serve.audio_frames`), WH_NEW new, greedy, with
    the launch counts at 0 just before and read just after: the prefill
    runs one `flash_attention` forward an encoder layer and two a decoder
    layer (self, cross), each decode step one `flash_decode` (G = 1, D =
    64) and one cross forward (a single query row onto 1500 frames) a
    decoder layer.  Its prefill's last-position logits equal those of the
    frames and first token prefilled and the rest fed through
    `decode_step` (PREFILL_TOL), and other frames move them.  The device
    time of a prefill and of a decode step.  Card against CPU on the same
    weights and frames: prefill and 8 teacher-forced decode steps, logits
    within SERVE_TOL and the greedy tokens the CPU's margin
    decides equal.  Returns the generate path's counts."""
    from repro_torch.configs import registry as R
    from repro_torch.kernels import ops
    from repro_torch.launch import weights as W
    from repro_torch.launch.serve import audio_frames, generate
    from repro_torch.models import api

    t_phase = time.perf_counter()
    cfg = R.get_config(WH_ARCH)
    n_e, n_l = cfg.n_enc_layers, cfg.n_layers
    mod = api.get_module(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    weights = W.ServingWeights.from_seed(cfg, 0, device="cuda")
    n_params = sum(b.numel() for b in weights.bufs.values())
    check(n_params == WH_PARAMS, f"whisper has {n_params} params")
    tree = weights.as_tree()
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, cfg.vocab, (WH_B, WH_PLEN), dtype=np.int32)
    fr = audio_frames(cfg, WH_B, "cuda")["frames"]
    ops.reset_launch_counts()             # the path: counts at 0 ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(cfg, tree, prompts, gen_len=WH_NEW, extra={"frames": fr})
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    counts = ops.launch_counts()          # ... read just after
    want = {k: 0 for k in counts}
    want.update(flash_attention_fwd=n_e + 2 * n_l + n_l * WH_NEW,
                flash_decode=n_l * WH_NEW)
    check(counts == want, f"whisper generate: launches {counts} != {want}")
    check(tuple(toks.shape) == (WH_B, WH_PLEN + WH_NEW)
          and bool(torch.equal(toks[:, :WH_PLEN].cpu(),
                               torch.from_numpy(prompts)))
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          f"whisper generate: tokens of shape {tuple(toks.shape)}")

    pt = torch.from_numpy(prompts).cuda()
    with torch.no_grad():
        lp, _ = mod.prefill(cfg, tree, pt, mod.init_cache(
            cfg, WH_B, WH_PLEN, device="cuda"), frames=fr)
        cache = mod.init_cache(cfg, WH_B, WH_PLEN, device="cuda")
        _, cache = mod.prefill(cfg, tree, pt[:, :1], cache, frames=fr)
        for i in range(1, WH_PLEN):
            ld, cache = mod.decode_step(cfg, tree, pt[:, i], cache, i)
        lz, _ = mod.prefill(cfg, tree, pt, mod.init_cache(
            cfg, WH_B, WH_PLEN, device="cuda"), frames=torch.zeros_like(fr))
    err, scale = float((lp - ld).abs().max()), float(ld.abs().max())
    tol = PREFILL_TOL * max(scale, 1.0)
    check(err <= tol, f"whisper prefill vs decode logits differ by {err} > "
          f"{tol}")
    check(bool(torch.equal(lp.argmax(-1), ld.argmax(-1))),
          "whisper prefill vs decode: another greedy token")
    moved = float((lp - lz).abs().max())
    check(moved > tol, f"whisper: the frames do not move the logits ({moved})")
    del cache, lp, ld, lz

    # device times: a prefill of the prompt after the frames, and a decode
    # step at the first new token's position
    cache = mod.init_cache(cfg, WH_B, WH_PLEN + WH_NEW, device="cuda")
    with torch.no_grad():
        ops.reset_launch_counts()
        pre = step_times(torch, lambda: mod.prefill(cfg, tree, pt, cache,
                                                    frames=fr))
        pre_counts = {k: v for k, v in ops.launch_counts().items() if v}
        ops.reset_launch_counts()
        dec = step_times(torch, lambda: mod.decode_step(
            cfg, tree, pt[:, -1], cache, WH_PLEN))
        dec_counts = {k: v for k, v in ops.launch_counts().items() if v}
    calls = 1 + 5 + 1                     # warm-up, timed, profiled
    check(pre_counts == {"flash_attention_fwd": (n_e + 2 * n_l) * calls},
          f"whisper prefill launches {pre_counts}")
    check(dec_counts == {"flash_attention_fwd": n_l * calls,
                         "flash_decode": n_l * calls},
          f"whisper decode step launches {dec_counts}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del cache

    # card against CPU: the same weights and frames, teacher-forced
    host = cpu_weights(W, cfg, weights)
    compare, res = logits_compare(SERVE_TOL)
    n_steps, max_len = 8, WH_PLEN + 8
    caches = {dev: mod.init_cache(cfg, WH_B, max_len, device=dev)
              for dev in ("cuda", "cpu")}
    t0 = time.perf_counter()
    with torch.no_grad():
        lc, _ = mod.prefill(cfg, tree, pt, caches["cuda"], frames=fr)
        lh, _ = mod.prefill(cfg, host.as_tree(), pt.cpu(), caches["cpu"],
                            frames=fr.cpu())
        compare(lc, lh)
        for i in range(n_steps):
            tok = torch.from_numpy(rng.integers(0, cfg.vocab, WH_B))
            lc, _ = mod.decode_step(cfg, tree, tok.cuda(), caches["cuda"],
                                    WH_PLEN + i)
            lh, _ = mod.decode_step(cfg, host.as_tree(), tok, caches["cpu"],
                                    WH_PLEN + i)
            compare(lc, lh)
    cpu_s = time.perf_counter() - t0
    check(res["worst"] <= SERVE_TOL, f"whisper card vs CPU logits differ by "
          f"{res['worst']} > {SERVE_TOL}")
    check(res["agree"] == res["decided"], f"whisper greedy tokens differ: "
          f"{res['agree']}/{res['decided']}")
    emit("generate_whisper", arch=cfg.name, enc_layers=n_e, layers=n_l,
         params=n_params, enc_seq=cfg.enc_seq, prompts=WH_B,
         prompt_len=WH_PLEN, new_tokens=WH_NEW, wall_s=gen_wall,
         tokens_per_s=WH_B * WH_NEW / gen_wall, launches=counts,
         launches_per_decode_step={k: v // calls for k, v in
                                   dec_counts.items()},
         prefill_ms=pre["ms"], prefill_kernel_ms=pre["kernel_ms"],
         prefill_top=pre["top"], decode_step_ms=dec["ms"],
         decode_step_kernel_ms=dec["kernel_ms"], decode_step_top=dec["top"],
         prefill_vs_decode_max_abs_err=err, prefill_vs_decode_tol=tol,
         zero_frames_max_abs_diff=moved, card_vs_cpu_max_abs_logit_err=
         res["worst"], card_vs_cpu_tol=SERVE_TOL, greedy_agree=res["agree"],
         greedy_decided=res["decided"], card_vs_cpu_steps=n_steps,
         card_vs_cpu_s=cpu_s, peak_mem_gb=peak_gb,
         seconds=time.perf_counter() - t_phase)
    del weights, tree, host, caches, toks, fr, pt
    torch.cuda.empty_cache()
    return counts


def phase_generate_ring(torch, np):
    """gemma3-4b at full width cut to RING_LAYERS layers (five local, one
    global), one-shot `generate` at
    `--window` RING_WINDOW: every local layer keeps its 1024-key window, so
    the KV cache is a ring of 1024 rows, and RING_B prompts x RING_PLEN
    tokens with RING_NEW new ones run 40 decode steps past its wrap, every
    decode attention through `flash_decode` with ring positions.  Launch
    counts exact; the device time of a ring decode step before and after
    the wrap.  Card against CPU at 2 layers: a RING_CPU_PROMPT-token
    prefill, then teacher-forced ring decode steps to position RING_PLEN +
    RING_NEW - 1, logits within SERVE_TOL and the greedy
    tokens the CPU's margin decides equal.  Returns the generate path's
    counts."""
    from repro_torch.configs import registry as R
    from repro_torch.kernels import ops
    from repro_torch.launch import weights as W
    from repro_torch.launch.serve import generate
    from repro_torch.models import api

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(R.get_config(ARCH), n_layers=RING_LAYERS)
    mod = api.get_module(cfg)
    max_len = RING_PLEN + RING_NEW
    ring_len = mod.cache_spec(cfg, RING_B, max_len, RING_WINDOW)["k"][2]
    check(ring_len == RING_ROWS < max_len, f"ring cache of {ring_len} rows")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    weights = W.ServingWeights.from_seed(cfg, 0, device="cuda")
    tree = weights.as_tree()
    rng = np.random.default_rng(13)
    prompts = rng.integers(0, cfg.vocab, (RING_B, RING_PLEN), dtype=np.int32)
    ops.reset_launch_counts()             # the path: counts at 0 ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(cfg, tree, prompts, gen_len=RING_NEW,
                    window_override=RING_WINDOW)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    counts = ops.launch_counts()          # ... read just after
    want = {k: 0 for k in counts}
    want.update(generate_launches(cfg, RING_NEW))
    check(counts == want, f"ring generate: launches {counts} != {want}")
    check(tuple(toks.shape) == (RING_B, max_len)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          f"ring generate: tokens of shape {tuple(toks.shape)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # a ring decode step before the wrap and after it
    cache = mod.init_cache(cfg, RING_B, max_len, device="cuda",
                           window_override=RING_WINDOW)
    tok = toks[:, -1].contiguous()
    times = {}
    with torch.no_grad():
        for where, pos in (("before_wrap", ring_len - 24),
                           ("after_wrap", max_len - 1)):
            times[where] = step_times(torch, lambda: mod.decode_step(
                cfg, tree, tok, cache, pos, ring=True))
    del cache, weights, tree

    # card against CPU at 2 layers
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    card = W.ServingWeights.from_seed(cfg2, 3, device="cuda")
    host = cpu_weights(W, cfg2, card)
    caches = {dev: mod.init_cache(cfg2, RING_B, max_len, device=dev,
                                  window_override=RING_WINDOW)
              for dev in ("cuda", "cpu")}
    check(caches["cpu"]["k"].shape[2] == RING_ROWS, "2-layer ring cache")
    compare, res = logits_compare(SERVE_TOL)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (RING_B, RING_CPU_PROMPT)))
    t0 = time.perf_counter()
    with torch.no_grad():
        lc, _ = mod.prefill(cfg2, card.as_tree(), prompt.cuda(),
                            caches["cuda"])
        lh, _ = mod.prefill(cfg2, host.as_tree(), prompt, caches["cpu"])
        compare(lc, lh)
        for pos in range(RING_CPU_PROMPT, max_len):
            t = torch.from_numpy(rng.integers(0, cfg.vocab, RING_B))
            lc, _ = mod.decode_step(cfg2, card.as_tree(), t.cuda(),
                                    caches["cuda"], pos, ring=True)
            lh, _ = mod.decode_step(cfg2, host.as_tree(), t, caches["cpu"],
                                    pos, ring=True)
            compare(lc, lh)
    cpu_s = time.perf_counter() - t0
    check(res["worst"] <= SERVE_TOL, f"ring card vs CPU logits differ by "
          f"{res['worst']} > {SERVE_TOL}")
    check(res["agree"] == res["decided"], f"ring greedy tokens differ: "
          f"{res['agree']}/{res['decided']}")
    emit("generate_ring", arch=cfg.name, layers=cfg.n_layers,
         depth=f"{RING_LAYERS} of 34 layers: the 1000 host-bound decode "
         "steps took 63-67 s at full depth",
         window_override=RING_WINDOW, ring_rows=ring_len, prompts=RING_B,
         prompt_len=RING_PLEN, new_tokens=RING_NEW,
         steps_past_wrap=max_len - ring_len, wall_s=gen_wall,
         ms_per_token_step=gen_wall / RING_NEW * 1e3,
         tokens_per_s=RING_B * RING_NEW / gen_wall, launches=counts,
         decode_step=times, peak_mem_gb=peak_gb,
         card_vs_cpu_layers=2, card_vs_cpu_prompt=RING_CPU_PROMPT,
         card_vs_cpu_steps_after_wrap=max_len - ring_len,
         card_vs_cpu_max_abs_logit_err=res["worst"],
         card_vs_cpu_tol=SERVE_TOL,
         greedy_agree=res["agree"], greedy_decided=res["decided"],
         card_vs_cpu_s=cpu_s, seconds=time.perf_counter() - t_phase)
    del card, host, caches, toks
    torch.cuda.empty_cache()
    return counts


def phase_train_whisper(torch, np, data):
    """whisper-base at full width cut to 3 + 3 layers (48,592,384
    parameters, 31 leaves) through `train_lm_path`: W = 4 x 8 sequences of
    64 tokens (the training CLI's defaults) with the LM recipe, 8 steps,
    each lane's batch carrying frames [8, 1500, 512], drawn on the host
    (`data="host"`) or on the card (`data="device"`).  Per step and worker
    9 attention forwards and backwards (3 encoder, 3 decoder self, 3
    cross: the cross backward at Sq = 64 against Sk = 1500, the encoder's
    with dS in key chunks), AdamW once a leaf.  Returns (counts, line)."""
    n = WH_TRAIN_LAYERS
    attn = 3 * n * WH_W * LM_STEPS
    return train_lm_path(
        torch, np, f"train_whisper_{data}", WH_ARCH, WH_W, WH_BLOC, WH_SEQ,
        WH_TRAIN_PARAMS, dict(flash_attention_fwd=attn,
                              flash_attention_bwd=attn,
                              adamw_update=WH_LEAVES * LM_STEPS),
        n_layers=n, cut=dict(n_enc_layers=n), data=data)


def phase_train_lm_device(torch, np, host_row):
    """`data="device"` on the LM path: starcoder2-3b at 2 layers, W = 4 x 4
    x 1024, the `train_lm` recipe with its batches drawn on the card
    (`device_batch_fn`), its data and wall ms a step beside `train_lm`'s
    host data.  Two engines with one seed draw bitwise-equal batches;
    every token is in the vocab and the labels are the tokens shifted by
    one."""
    from repro_torch.core.engine import RoundEngine
    counts, row = train_lm_path(torch, np, "train_lm_device", LM_ARCH, LM_W,
                                LM_B, LM_SEQ, LM_PARAMS[2], lm_launches(),
                                data="device")
    cfg, run = lm_setup(LM_LAYERS)
    engines = [RoundEngine(cfg, run, workers=LM_W, b_loc=LM_B, seq=LM_SEQ,
                           data="device") for _ in range(2)]
    a, b = (eng._batch(5) for eng in engines)
    check(all(bool(torch.equal(a[k], b[k])) for k in a),
          "device data: two engines with one seed draw different batches")
    check(a["tokens"].shape == (LM_W, LM_B, LM_SEQ)
          and a["tokens"].device.type == "cuda"
          and int(a["tokens"].min()) >= 0
          and int(a["labels"].max()) < cfg.vocab
          and bool(torch.equal(a["tokens"][..., 1:], a["labels"][..., :-1])),
          "device data: tokens out of range or labels not shifted")
    other = engines[0]._batch(6)
    check(not bool(torch.equal(other["tokens"], a["tokens"])),
          "device data: another step draws the same batch")
    emit("train_lm_device_vs_host", arch=cfg.name, layers=cfg.n_layers,
         workers=LM_W, b_loc=LM_B, seq=LM_SEQ,
         **{k: {"host": host_row[k], "device": row[k]}
            for k in ("data_ms_per_step", "batch_on_card_ms",
                      "wall_ms_per_step", "device_ms_per_step")},
         bitwise_equal_engines=True, tokens_in_vocab=True,
         labels_shifted=True)
    del engines, a, b, other
    return counts


# ------------------------------------------------------ the SSM families ---

def ssm_forward_flops(cfg, seqs: int, seq: int,
                      unembed_rows: int | None = None) -> float:
    """Matmul + SSD FLOPs of a mamba2 / zamba2 forward over `seqs`
    sequences of `seq` tokens: each mamba layer's projections, its
    depthwise conv and the chunked SSD as computed (every chunk's whole
    masked Q x Q tile a head, the chunk states and their read-out), each
    use of zamba2's shared block (its projections, its MLP and the causal
    attention pairs), and the tied unembedding of `unembed_rows`
    positions (all of them by default)."""
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    n, p = cfg.ssm_state, cfg.ssm_headdim
    h, conv_dim = d_inner // p, d_inner + 2 * n
    q = min(cfg.ssm_chunk, seq)
    per_token = (2 * d * (d_inner + conv_dim + h) + 2 * d_inner * d
                 + 2 * cfg.ssm_conv * conv_dim
                 + 2 * q * n + h * (2 * q * p + 4 * q + 4 * p * n))
    total = float(seqs) * seq * cfg.n_layers * per_token
    if ssm_uses(cfg):
        hd, f, hq = cfg.hd, cfg.d_ff, cfg.n_heads
        shared = 2 * (2 * d * d + 4 * d * hq * hd + 2 * d * f + d * d)
        total += ssm_uses(cfg) * seqs * (
            seq * shared + seq * (seq + 1) / 2 * hq * 4.0 * hd)
    rows = seqs * seq if unembed_rows is None else unembed_rows
    return total + 2.0 * rows * d * cfg.vocab


def phase_service_mamba2(torch, np, rows):
    """mamba2-130m at full width and all 24 layers (random weights from
    seed 0 on the card) through `service_path`: the `--slots 2` service,
    one-shot `generate` with the same tokens, a decode step's device time
    (a CUDA graph: the state's addresses stay fixed) beside its bytes floor
    (the weights, and the conv and SSM state read and written), 49
    rms_norm a step and no attention; then `ssm_prefill_and_gate` (prefill
    against decode, a timed 4 x 1024 prefill, the card against the CPU at
    2 layers).  Returns (the service's counts, generate's counts)."""
    from repro_torch.configs import registry as R
    cfg = R.get_config(M2_ARCH)
    serve, gen = service_path(torch, np, "service_mamba2", cfg,
                              M2_PARAMS[24])
    ssm_prefill_and_gate(torch, np, "prefill_mamba2", cfg, rows, 2)
    return serve, gen


def phase_serve_zamba2(torch, np, rows):
    """zamba2-1.2b at full width and all 38 layers (6 groups of 6 mamba
    layers, 6 uses of the shared block, a tail of 2; random weights from
    seed 0 on the card): `serve --slots` refuses the family (its decode
    step takes one position for the batch) before it builds weights; one-
    shot `generate` of GEN_B prompts x GEN_PLEN tokens, GEN_NEW new, and at
    `--window` Z2_RING_WINDOW (a 64-row KV ring, 80 decode steps past its
    wrap), each with exact launches (89 rms_norm and 6 flash_decode a
    step); a decode step's time on the flat cache and after the ring's
    wrap (events around eager steps, and its kernels' sum from a profile:
    the scalar position is read on the host, so a step is not captured in
    a CUDA graph); then `ssm_prefill_and_gate` (the card against the CPU
    at 8 layers, flat and through a ring).  Returns generate's counts (the
    flat and the ring runs')."""
    from repro_torch.configs import registry as R
    from repro_torch.errors import ConfigError
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as S
    from repro_torch.launch import weights as W
    from repro_torch.launch.batching import ContinuousBatcher
    from repro_torch.models import api

    t_phase = time.perf_counter()
    cfg = R.get_config(Z2_ARCH)
    mod = api.get_module(cfg)
    try:
        S.main(["--arch", Z2_ARCH, "--slots", "2"])
        refused = None
    except SystemExit as e:
        refused = str(e)
    check(refused is not None and "per-slot positions" in refused,
          f"serve --slots {Z2_ARCH}: not refused ({refused})")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    weights = W.ServingWeights.from_seed(cfg, 0, device="cuda")
    tree = weights.as_tree()
    got_params = sum(b.numel() for b in weights.bufs.values())
    check(got_params == Z2_PARAMS[38], f"zamba2: {got_params} params")
    try:
        ContinuousBatcher(cfg, weights, slots=SLOTS, max_len=64)
        check(False, "ContinuousBatcher took the hybrid family")
    except ConfigError as e:
        check("per-slot positions" in str(e), f"batcher refusal: {e}")

    rng = np.random.default_rng(13)
    gp = rng.integers(0, cfg.vocab, (GEN_B, GEN_PLEN), dtype=np.int32)
    ops.reset_launch_counts()             # the path: counts at 0 ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = S.generate(cfg, tree, gp, gen_len=GEN_NEW)
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    counts = ops.launch_counts()          # ... read just after
    want = {k: 0 for k in counts}
    want.update(generate_launches(cfg, GEN_NEW))
    check(counts == want, f"zamba2 generate: launches {counts} != {want}")
    check(tuple(toks.shape) == (GEN_B, GEN_PLEN + GEN_NEW)
          and bool(torch.equal(toks[:, :GEN_PLEN].cpu(),
                               torch.from_numpy(gp)))
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          f"zamba2 generate: tokens of shape {tuple(toks.shape)}")

    # --window: a ring of Z2_RING_WINDOW rows, run past its wrap
    max_len = Z2_RING_PLEN + Z2_RING_NEW
    ring_len = mod.cache_spec(cfg, Z2_RING_B, max_len,
                              Z2_RING_WINDOW)["attn_k"][2]
    check(ring_len == Z2_RING_WINDOW < max_len, f"ring of {ring_len} rows")
    rp = rng.integers(0, cfg.vocab, (Z2_RING_B, Z2_RING_PLEN), dtype=np.int32)
    ops.reset_launch_counts()             # the path: counts at 0 ...
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ring = S.generate(cfg, tree, rp, gen_len=Z2_RING_NEW,
                      window_override=Z2_RING_WINDOW)
    torch.cuda.synchronize()
    ring_wall = time.perf_counter() - t0
    ring_counts = ops.launch_counts()     # ... read just after
    want = {k: 0 for k in ring_counts}
    want.update(generate_launches(cfg, Z2_RING_NEW))
    check(ring_counts == want, f"zamba2 ring generate: launches "
          f"{ring_counts} != {want}")
    check(tuple(ring.shape) == (Z2_RING_B, max_len)
          and int(ring.min()) >= 0 and int(ring.max()) < cfg.vocab,
          f"zamba2 ring generate: tokens of shape {tuple(ring.shape)}")
    # before the wrap the ring holds what a flat cache holds (the tokens
    # may still part where a top-2 margin sits at the sum-order noise: the
    # two caches' decode launches split their keys differently)
    upto = ring_len + 1
    flat = S.generate(cfg, tree, rp, gen_len=upto - Z2_RING_PLEN)
    same_before_wrap = int((ring[:, :upto] == flat[:, :upto]).all(-1).sum())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # a decode step: the flat cache at its last position, the ring after
    # its wrap
    times = {}
    tok = toks[:, -1].contiguous()
    with torch.no_grad():
        cache = mod.init_cache(cfg, GEN_B, GEN_PLEN + GEN_NEW, device="cuda")
        times["flat"] = step_times(torch, lambda: mod.decode_step(
            cfg, tree, tok, cache, GEN_PLEN + GEN_NEW - 1))
        ops.reset_launch_counts()
        mod.decode_step(cfg, tree, tok, cache, GEN_PLEN + GEN_NEW - 1)
        step_counts = {k: v for k, v in ops.launch_counts().items() if v}
        del cache
        cache = mod.init_cache(cfg, Z2_RING_B, max_len, device="cuda",
                               window_override=Z2_RING_WINDOW)
        rtok = ring[:, -1].contiguous()
        times["ring_after_wrap"] = step_times(torch, lambda: mod.decode_step(
            cfg, tree, rtok, cache, max_len - 1, ring=True))
        del cache
    check(step_counts == decode_launches(cfg),
          f"zamba2 decode step launches {step_counts}")
    w_bytes = sum(b.numel() * b.element_size() for b in weights.bufs.values())
    pos = GEN_PLEN + GEN_NEW - 1
    kv_need = 2 * ssm_uses(cfg) * GEN_B * (pos + 1) * cfg.n_kv_heads \
        * cfg.hd * 4
    floor_ms = (w_bytes + ssm_state_bytes(cfg, GEN_B) + kv_need) \
        / PEAK_BYTES_PER_S * 1e3
    emit("generate_zamba2", arch=cfg.name, layers=cfg.n_layers,
         groups=ssm_uses(cfg), period=cfg.shared_attn_period,
         tail=cfg.n_layers - ssm_uses(cfg) * cfg.shared_attn_period,
         d_model=cfg.d_model, params=got_params, slots_refused=refused,
         prompts=GEN_B, prompt_len=GEN_PLEN, new_tokens=GEN_NEW,
         wall_s=gen_wall, tokens_per_s=GEN_B * GEN_NEW / gen_wall,
         launches=counts, launches_per_step=step_counts,
         ring_window=Z2_RING_WINDOW, ring_rows=ring_len,
         ring_prompts=Z2_RING_B, ring_prompt_len=Z2_RING_PLEN,
         ring_new_tokens=Z2_RING_NEW, ring_steps_past_wrap=max_len - ring_len,
         ring_wall_s=ring_wall,
         ring_ms_per_token_step=ring_wall / Z2_RING_NEW * 1e3,
         ring_launches=ring_counts,
         ring_rows_equal_flat_before_wrap=same_before_wrap,
         decode_step=times, step_weight_bytes=w_bytes,
         step_state_bytes=ssm_state_bytes(cfg, GEN_B),
         step_kv_bytes_needed=kv_need, floor_ms_datasheet=floor_ms,
         floor_share=floor_ms / times["flat"]["kernel_ms"],
         peak_mem_gb=peak_gb, seconds=time.perf_counter() - t_phase)
    del weights, tree, toks, ring, flat
    torch.cuda.empty_cache()
    ssm_prefill_and_gate(torch, np, "prefill_zamba2", cfg, rows,
                         Z2_TRAIN_LAYERS)
    return counts, ring_counts


def ssm_prefill_and_gate(torch, np, phase, cfg, rows, cpu_layers):
    """An SSM at full width and depth (weights from seed 0 on the card):
    the last logits of a GEN_PLEN-token prefill against the prompt fed
    through decode steps from the zero state (within PREFILL_TOL, the same
    greedy tokens); a prefill of PREFILL_B x PREFILL_LEN tokens (its SSD in
    four 256-token chunks; zamba2's attention against a cache of
    SSM_PREFILL_CACHE rows): device ms (CUDA events), its launches, its
    kernels by name, beside the kernel rows' times.  Then the card against
    the CPU at `cpu_layers` layers on the same weights (seed 3): a
    SSM_CPU_PROMPT-token prefill (two SSD chunks) and SSM_CPU_STEPS
    teacher-forced decode steps; zamba2 also through a Z2_CPU_RING-row
    ring, a Z2_CPU_RING_PROMPT-token prefill and Z2_CPU_RING_STEPS steps
    past its wrap.  The card runs it twice, with the kernels and with the
    plain versions (`plain_versions_on_card`): the kernels' logits and state
    after the steps (conv, SSM, zamba2's KV; relative to max(|CPU|, 1))
    must lie within SERVE_TOL of the CPU's, or within twice the plain
    card's distance, and the greedy tokens the CPU's margin decides
    equal."""
    from repro_torch import tree as T
    from repro_torch.kernels import ops
    from repro_torch.launch import weights as W
    from repro_torch.models import api

    t_phase = time.perf_counter()
    mod = api.get_module(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    weights = W.ServingWeights.from_seed(cfg, 0, device="cuda")
    tree = weights.as_tree()
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, cfg.vocab, (GEN_B, GEN_PLEN), dtype=np.int32)
    with torch.no_grad():
        pt = torch.from_numpy(prompts).cuda()
        lp, _ = mod.prefill(cfg, tree, pt, mod.init_cache(
            cfg, GEN_B, GEN_PLEN, device="cuda"))
        cache = mod.init_cache(cfg, GEN_B, GEN_PLEN, device="cuda")
        for i in range(GEN_PLEN):
            ld, cache = mod.decode_step(cfg, tree, pt[:, i], cache, i)
    err, scale = float((lp - ld).abs().max()), float(ld.abs().max())
    tol = PREFILL_TOL * max(scale, 1.0)
    check(err <= tol, f"{phase}: prefill vs decode logits differ by {err} > "
          f"{tol}")
    check(bool(torch.equal(lp.argmax(-1), ld.argmax(-1))),
          f"{phase}: prefill vs decode: another greedy token")
    del cache, lp, ld

    pt = torch.from_numpy(rng.integers(0, cfg.vocab, (PREFILL_B, PREFILL_LEN),
                                       dtype=np.int32)).cuda()
    cache = mod.init_cache(cfg, PREFILL_B, SSM_PREFILL_CACHE, device="cuda")
    with torch.no_grad():
        mod.prefill(cfg, tree, pt, cache)      # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        logits, _ = mod.prefill(cfg, tree, pt, cache)
        ev[1].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        pre_counts = {k: v for k, v in ops.launch_counts().items() if v}
        prof = profile_device_ms(torch,
                                 lambda: mod.prefill(cfg, tree, pt, cache))
    device_ms = ev[0].elapsed_time(ev[1])
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (PREFILL_B, cfg.vocab),
          f"{phase}: prefill logits {tuple(logits.shape)}, finite "
          f"{bool(torch.isfinite(logits).all())}")
    want = dict(rms_norm=norms_per_pass(cfg))
    if ssm_uses(cfg):
        want["flash_attention_fwd"] = ssm_uses(cfg)
    check(pre_counts == want, f"{phase}: prefill launches {pre_counts} != "
          f"{want}")
    d_inner = cfg.ssm_expand * cfg.d_model
    rows_ms = dict(gated_rms_norm=cfg.n_layers * rows[
        "rms_norm", f"[{PREFILL_B * PREFILL_LEN},{d_inner}]"]["ms"])
    if ssm_uses(cfg):
        rows_ms["flash_attention_fwd"] = ssm_uses(cfg) * rows[
            "flash_attention_fwd", Z2_ATTN["prefill"]]["ms"]
    flop = ssm_forward_flops(cfg, PREFILL_B, PREFILL_LEN,
                             unembed_rows=PREFILL_B)
    del cache, pt, logits, weights, tree
    torch.cuda.empty_cache()

    # card against CPU at cpu_layers layers
    cfg_n = dataclasses.replace(cfg, n_layers=cpu_layers)
    card = W.ServingWeights.from_seed(cfg_n, 3, device="cuda")
    host = cpu_weights(W, cfg_n, card)
    # the card with the plain versions in the kernels' place, against the
    # same CPU run: the card's own sum-order distance, the yardstick
    results = {way: dict(logits=0.0, state=0.0) for way in ("kernels",
                                                           "plain")}
    logits = {way: [] for way in ("kernels", "plain", "cpu")}

    def run(max_len, prompt_len, steps, window=0):
        caches = {way: mod.init_cache(
            cfg_n, SLOTS, max_len, device="cpu" if way == "cpu" else "cuda",
            window_override=window) for way in ("kernels", "plain", "cpu")}
        trees = dict(kernels=card.as_tree(), plain=card.as_tree(),
                     cpu=host.as_tree())
        prompt = rng.integers(0, cfg.vocab, (SLOTS, prompt_len))
        toks = rng.integers(0, cfg.vocab, (steps, SLOTS))
        for way in ("kernels", "plain", "cpu"):
            dev = "cpu" if way == "cpu" else "cuda"
            with torch.no_grad(), (plain_versions_on_card() if way == "plain"
                                   else contextlib.nullcontext()):
                lg, _ = mod.prefill(cfg_n, trees[way],
                                    torch.from_numpy(prompt).to(dev),
                                    caches[way])
                logits[way].append(lg.cpu())
                for i, pos in enumerate(range(prompt_len,
                                              prompt_len + steps)):
                    lg, _ = mod.decode_step(
                        cfg_n, trees[way], torch.from_numpy(toks[i]).to(dev),
                        caches[way], pos, ring=window > 0)
                    logits[way].append(lg.cpu())
        for way in ("kernels", "plain"):
            for a, b in zip(T.leaves(caches[way]), T.leaves(caches["cpu"])):
                e = float((a.cpu() - b).abs().max()) / max(
                    float(b.abs().max()), 1.0)
                results[way]["state"] = max(results[way]["state"], e)

    t0 = time.perf_counter()
    run(SSM_CPU_PROMPT + SSM_CPU_STEPS, SSM_CPU_PROMPT, SSM_CPU_STEPS)
    ring = None
    if ssm_uses(cfg):
        n = Z2_CPU_RING_PROMPT + Z2_CPU_RING_STEPS
        run(n, Z2_CPU_RING_PROMPT, Z2_CPU_RING_STEPS, window=Z2_CPU_RING)
        ring = dict(rows=Z2_CPU_RING, prompt=Z2_CPU_RING_PROMPT,
                    steps=Z2_CPU_RING_STEPS,
                    steps_past_wrap=n - Z2_CPU_RING)
    cpu_s = time.perf_counter() - t0
    for way in ("kernels", "plain"):
        results[way]["logits"] = max(
            float((a - b).abs().max())
            for a, b in zip(logits[way], logits["cpu"]))
    # the logits and the state within SERVE_TOL, or within twice the plain
    # card's distance: through the SSD's 256-term chunk sums zamba2's fp32
    # logits at 8 layers sit ~2e-4 from float64's on either device
    gate_tol = {k: max(SERVE_TOL, 2 * results["plain"][k])
                for k in ("logits", "state")}
    for k in ("logits", "state"):
        check(results["kernels"][k] <= gate_tol[k], f"{phase}: card vs CPU "
              f"{k} differ by {results['kernels'][k]} > {gate_tol[k]}")
    compare, res = logits_compare(gate_tol["logits"])
    for a, b in zip(logits["kernels"], logits["cpu"]):
        compare(a, b)
    check(res["agree"] == res["decided"], f"{phase}: greedy tokens differ: "
          f"{res['agree']}/{res['decided']}")
    emit(phase, arch=cfg.name, layers=cfg.n_layers, batch=PREFILL_B,
         prompt_len=PREFILL_LEN, cache_rows=SSM_PREFILL_CACHE,
         chunk=cfg.ssm_chunk, wall_ms=wall_ms, device_ms=device_ms,
         tokens_per_s=PREFILL_B * PREFILL_LEN / wall_ms * 1e3,
         launches=pre_counts, profiled=prof, kernel_rows_ms_x_launches=rows_ms,
         flop=flop, achieved_tflop_s=flop / device_ms / 1e9,
         prefill_vs_decode_max_abs_err=err, prefill_vs_decode_tol=tol,
         card_vs_cpu_layers=cpu_layers, card_vs_cpu_prompt=SSM_CPU_PROMPT,
         card_vs_cpu_steps=SSM_CPU_STEPS, card_vs_cpu_ring=ring,
         card_vs_cpu_max_abs_logit_err=results["kernels"]["logits"],
         card_vs_cpu_max_state_rel_err=results["kernels"]["state"],
         plain_card_vs_cpu_max_abs_logit_err=results["plain"]["logits"],
         plain_card_vs_cpu_max_state_rel_err=results["plain"]["state"],
         card_vs_cpu_tol=gate_tol, greedy_agree=res["agree"],
         greedy_decided=res["decided"], card_vs_cpu_s=cpu_s,
         seconds=time.perf_counter() - t_phase)
    del card, host
    torch.cuda.empty_cache()


def phase_train_mamba2(torch, np):
    """mamba2-130m training on the card at full width cut to 12 of its 24
    layers (83,799,648 parameters, 13 leaves) through `train_lm_path`: the
    LM recipe, W = 4 x 4 sequences of 1024 tokens (four 256-token SSD
    chunks each), 8 steps; per step and worker 25 rms_norm and
    rms_norm_bwd launches (through `_RmsNorm`: each layer's norm at d = 768
    and its gated norm at 1536, the final norm), AdamW once a leaf, no
    attention.  Returns the counts."""
    cfg, _ = lm_setup(M2_TRAIN_LAYERS, M2_ARCH)
    per = norms_per_pass(cfg) * M2_W * LM_STEPS
    return train_lm_path(
        torch, np, "train_mamba2", M2_ARCH, M2_W, M2_B, LM_SEQ,
        M2_PARAMS[M2_TRAIN_LAYERS], dict(rms_norm=per, rms_norm_bwd=per,
                                         adamw_update=M2_LEAVES * LM_STEPS),
        n_layers=M2_TRAIN_LAYERS)[0]


def phase_train_zamba2(torch, np):
    """zamba2-1.2b training on the card at full width cut to
    Z2_TRAIN_LAYERS layers (one group of 6, the shared block, the tail of
    2: 333,148,672 parameters, 34 leaves) through `train_lm_path`: the LM
    recipe, W = 4 x 1 x 1024, 8 steps; per step and worker 19 rms_norm and
    rms_norm_bwd (the gated rows of 4096 on the staged instances: 8 of
    each a lane in a profiled step) and one attention forward and backward
    (32 heads of 64), AdamW once a leaf.  Returns the counts."""
    from repro_torch.configs import registry as R
    cfg = dataclasses.replace(R.get_config(Z2_ARCH),
                              n_layers=Z2_TRAIN_LAYERS)
    per = norms_per_pass(cfg) * Z2_W * LM_STEPS
    attn = ssm_uses(cfg) * Z2_W * LM_STEPS
    staged = cfg.n_layers * Z2_W
    return train_lm_path(
        torch, np, "train_zamba2", Z2_ARCH, Z2_W, Z2_B, LM_SEQ,
        Z2_PARAMS[Z2_TRAIN_LAYERS],
        dict(rms_norm=per, rms_norm_bwd=per, flash_attention_fwd=attn,
             flash_attention_bwd=attn, adamw_update=Z2_LEAVES * LM_STEPS),
        kernel_calls={"rmsnorm_kernel<-2>": staged,
                      "rmsnorm_bwd_kernel<-2>": staged},
        n_layers=Z2_TRAIN_LAYERS,
        depth=f"{Z2_TRAIN_LAYERS} of 38 layers: one group of 6, the shared "
        "block, the tail of 2")[0]


# ---------------------------------------------------------- MoE family ------

def moe_capacity(cfg, n_tokens: int) -> int:
    """Rows of each expert's buffer for `n_tokens` tokens
    (`models/moe.py capacity`)."""
    from repro_torch.models import moe
    return moe.capacity(cfg, n_tokens)


def moe_forward_flops(cfg, seqs: int, seq: int,
                      unembed_rows: int | None = None) -> float:
    """Matmul + attention FLOPs of an MoE model's forward over `seqs`
    sequences of `seq` tokens: the attention products and pairs and the
    unembedding as `lm_forward_flops`; a layer's router, its experts' three
    products over their whole capacity buffer (E x capacity(T) rows, every
    row computed whether a pick fills it or not, as the reference's
    einsums do) and its shared expert's over every token."""
    t = seqs * seq
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    moe = (2.0 * t * d * e + 6.0 * e * moe_capacity(cfg, t) * d * f
           + 6.0 * t * d * f * cfg.n_shared_experts)
    return (lm_forward_flops(dataclasses.replace(cfg, d_ff=0), seqs, seq,
                             unembed_rows) + cfg.n_layers * moe)


def moe_prefill(torch, np, phase, cfg, weights, rows):
    """A timed prefill of PREFILL_B x PREFILL_LEN tokens on `weights`: its
    device ms (CUDA events, after a warm-up), launches (attention once a
    layer; an RMSNorm model's rms_norm and the shared expert's swiglu),
    kernels by name (torch.profiler) and the kernel rows' times at its
    shapes, beside its FLOP floor (the experts on their capacity rows)."""
    from repro_torch.kernels import ops
    from repro_torch.models import api
    t_phase = time.perf_counter()
    mod = api.get_module(cfg)
    tree = weights.as_tree()
    n_l, t = cfg.n_layers, PREFILL_B * PREFILL_LEN
    rng = np.random.default_rng(17)
    pt = torch.from_numpy(rng.integers(0, cfg.vocab, (PREFILL_B, PREFILL_LEN),
                                       dtype=np.int32)).cuda()
    cache = mod.init_cache(cfg, PREFILL_B, PREFILL_LEN, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        mod.prefill(cfg, tree, pt, cache)      # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        logits, _ = mod.prefill(cfg, tree, pt, cache)
        ev[1].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        prof = profile_device_ms(torch,
                                 lambda: mod.prefill(cfg, tree, pt, cache))
    device_ms = ev[0].elapsed_time(ev[1])
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape)
          == (PREFILL_B, cfg.vocab), f"{phase}: logits {tuple(logits.shape)}")
    # a decode step's norms and shared expert, on every row
    want = {k: v for k, v in decode_launches(cfg).items()
            if k != "flash_decode"}
    want["flash_attention_fwd"] = n_l
    check(counts == want, f"{phase}: launches {counts} != {want}")
    rows_ms = dict(flash_attention_fwd=n_l * rows[
        "flash_attention_fwd", DBRX_PREFILL_ATTN if cfg.name == DBRX_ARCH
        else KIMI_ATTN[1]]["ms"])
    if "rms_norm" in want:
        rows_ms["rms_norm"] = 2 * n_l * rows[
            "rms_norm", f"[{t},{cfg.d_model}]"]["ms"]
    if "swiglu" in want:
        rows_ms["swiglu"] = n_l * rows[
            "swiglu", f"[{t},{cfg.d_model}]x[{cfg.d_model},{cfg.d_ff}]"]["ms"]
    flop = moe_forward_flops(cfg, PREFILL_B, PREFILL_LEN,
                             unembed_rows=PREFILL_B)
    emit(phase, arch=cfg.name, layers=n_l, experts=cfg.n_experts,
         top_k=cfg.top_k, batch=PREFILL_B, prompt_len=PREFILL_LEN,
         capacity_rows_per_expert=moe_capacity(cfg, t),
         wall_ms=wall_ms, device_ms=device_ms,
         tokens_per_s=t / wall_ms * 1e3, launches=counts, profiled=prof,
         kernel_rows_ms_x_launches=rows_ms, flop=flop,
         flop_floor_ms=flop / PEAK_FP32_FLOP_PER_S * 1e3,
         achieved_tflop_s=flop / device_ms / 1e9,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         seconds=time.perf_counter() - t_phase)
    del cache, pt, logits
    torch.cuda.empty_cache()


def phase_service_dbrx(torch, np, rows):
    """dbrx-132b at full width (16 experts, top-4, capacity factor 1.25)
    cut to DBRX_LAYERS of its 40 layers (57.1 GB of fp32 weights) through
    `service_path`: per decode step flash_decode once a layer (G = 6), no
    rms_norm (layernorm) and no swiglu (the experts are batched products);
    one-shot `generate` of MOE_GEN; then a timed 4 x 1024 prefill
    (`moe_prefill`)."""
    from repro_torch.configs import registry as R
    cfg = dataclasses.replace(R.get_config(DBRX_ARCH), n_layers=DBRX_LAYERS)
    return service_path(
        torch, np, "service_dbrx", cfg, DBRX_PARAMS[DBRX_LAYERS],
        depth=f"{DBRX_LAYERS} of 40 layers: the full depth's "
        f"{4 * 131_597_021_184 / 1e9:.1f} GB of fp32 weights exceed the "
        "card's 80 GB", gen=MOE_GEN,
        then=lambda w: moe_prefill(torch, np, "prefill_dbrx", cfg, w, rows))


def phase_service_kimi(torch, np, rows):
    """kimi-k2-1t-a32b at full width (64 heads of 128 over 8 kv heads, the
    shared expert, top-8, vocab 163,840) cut to 1 of its 61 layers and
    KIMI_SERVE_EXPERTS of its 384 experts (32.7 GB) through
    `service_path`: per decode step 3 rms_norm (d = 7168, staged), one
    swiglu (the shared expert) and one flash_decode (G = 8); one-shot
    `generate` of MOE_GEN; then a timed 4 x 1024 prefill."""
    from repro_torch.configs import registry as R
    cfg = dataclasses.replace(R.get_config(KIMI_ARCH), n_layers=1,
                              n_experts=KIMI_SERVE_EXPERTS)
    return service_path(
        torch, np, "service_kimi", cfg, KIMI_PARAMS[KIMI_SERVE_EXPERTS],
        depth=f"1 of 61 layers and {KIMI_SERVE_EXPERTS} of 384 experts: one "
        "layer with all 384 is 77.8 GB of fp32 weights, which leaves ~7 GB "
        "of the card for everything else", gen=MOE_GEN,
        then=lambda w: moe_prefill(torch, np, "prefill_kimi", cfg, w, rows))


def moe_gate_cfg(arch):
    """The MoE card-vs-CPU gates' config: full width at 1 layer, kimi-k2
    with KIMI_TRAIN_EXPERTS of its experts (top-8 kept)."""
    from repro_torch.configs import registry as R
    cut = dict(n_layers=1)
    if arch == KIMI_ARCH:
        cut["n_experts"] = KIMI_TRAIN_EXPERTS
    return dataclasses.replace(R.get_config(arch), **cut)


def phase_card_vs_cpu_moe(torch, np, arch):
    """`arch` (dbrx-132b, or kimi-k2 with KIMI_TRAIN_EXPERTS experts) at full
    width and 1 layer, the same weights (seed 3) on the card with the
    kernels, on the card with the plain versions, and on the CPU: a
    prefill of MOE_CPU_B x MOE_CPU_PROMPT tokens (the capacity path: an
    expert's buffer sized to the 64 tokens, picks dropped where it binds,
    the same ones on every side), then MOE_CPU_STEPS greedy decode steps,
    every side fed the CPU's greedy tokens.  Each side's logits within
    SERVE_TOL of the CPU's (the dense gates' tolerance) and the card's
    greedy tokens the CPU's wherever its top-2 margin decides them; the
    KV caches after the steps within SERVE_TOL too."""
    from repro_torch import tree as T
    from repro_torch.launch import weights as W
    from repro_torch.models import api

    t_phase = time.perf_counter()
    phase = f"card_vs_cpu_{arch.split('-')[0]}"
    cfg = moe_gate_cfg(arch)
    mod = api.get_module(cfg)
    card = W.ServingWeights.from_seed(cfg, 3, device="cuda")
    # the CPU side reads views into host copies of the card's buckets
    trees = dict(kernels=card.as_tree(), plain=card.as_tree(),
                 cpu=card.spec.unflatten({b: v.cpu()
                                          for b, v in card.bufs.items()}))
    max_len = MOE_CPU_PROMPT + MOE_CPU_STEPS
    rng = np.random.default_rng(19)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (MOE_CPU_B, MOE_CPU_PROMPT)))
    logits = {way: [] for way in trees}
    caches = {}
    fed = []
    seconds = {}
    for way in ("cpu", "kernels", "plain"):
        t0 = time.perf_counter()
        dev = "cpu" if way == "cpu" else "cuda"
        caches[way] = mod.init_cache(cfg, MOE_CPU_B, max_len, device=dev)
        with torch.no_grad(), (plain_versions_on_card() if way == "plain"
                               else contextlib.nullcontext()):
            lg, _ = mod.prefill(cfg, trees[way], prompt.to(dev), caches[way])
            logits[way].append(lg.cpu())
            for i in range(MOE_CPU_STEPS):
                if way == "cpu":
                    fed.append(lg.argmax(-1))
                lg, _ = mod.decode_step(cfg, trees[way], fed[i].to(dev),
                                        caches[way], MOE_CPU_PROMPT + i)
                logits[way].append(lg.cpu())
        seconds[way] = time.perf_counter() - t0
    errs, state_errs = {}, {}
    for way in ("kernels", "plain"):
        errs[way] = max(float((a - b).abs().max())
                        for a, b in zip(logits[way], logits["cpu"]))
        state_errs[way] = max(float((a.cpu() - b).abs().max())
                              for a, b in zip(T.leaves(caches[way]),
                                              T.leaves(caches["cpu"])))
    compare, res = logits_compare(SERVE_TOL)
    for a, b in zip(logits["kernels"], logits["cpu"]):
        compare(a, b)
    emit(phase, arch=cfg.name, layers=cfg.n_layers, experts=cfg.n_experts,
         top_k=cfg.top_k, d_model=cfg.d_model, vocab=cfg.vocab,
         batch=MOE_CPU_B, prompt_len=MOE_CPU_PROMPT, steps=MOE_CPU_STEPS,
         prefill_capacity_rows=moe_capacity(cfg, MOE_CPU_B * MOE_CPU_PROMPT),
         max_abs_logit_err=errs["kernels"],
         plain_card_max_abs_logit_err=errs["plain"],
         max_abs_cache_err=state_errs["kernels"],
         plain_card_max_abs_cache_err=state_errs["plain"], tol=SERVE_TOL,
         greedy_agree=res["agree"], greedy_decided=res["decided"],
         side_seconds=seconds, seconds=time.perf_counter() - t_phase)
    for way in ("kernels", "plain"):
        check(errs[way] <= SERVE_TOL, f"{phase}: {way} card vs CPU logits "
              f"differ by {errs[way]} > {SERVE_TOL}")
        check(state_errs[way] <= SERVE_TOL, f"{phase}: {way} card vs CPU "
              f"caches differ by {state_errs[way]} > {SERVE_TOL}")
    check(res["agree"] == res["decided"], f"{phase}: greedy tokens differ: "
          f"{res['agree']}/{res['decided']}")
    del card, trees, caches
    torch.cuda.empty_cache()


def phase_train_kimi(torch, np):
    """kimi-k2 training on the card: full width, 1 layer, KIMI_TRAIN_EXPERTS
    experts (3,229,750,272 parameters, 16 leaves), W = 1 x 1 x 1024, remat
    on, the LM recipe's 8 steps of Local AdamW under QSR through
    `train_lm_path`: per step 5 rms_norm (ln1, ln2 twice under remat, the
    final norm; d = 7168), 3 rms_norm_bwd, 2 swiglu and 1 swiglu_bwd (the
    shared expert), 2 attention forwards and 1 backward (G = 8), AdamW
    once a leaf: the MoE backward, its aux loss and the backward kernels
    at kimi's shapes.  Returns the counts."""
    steps = LM_STEPS
    return train_lm_path(
        torch, np, "train_kimi", KIMI_ARCH, 1, 1, LM_SEQ,
        KIMI_PARAMS[KIMI_TRAIN_EXPERTS],
        dict(rms_norm=5 * steps, rms_norm_bwd=3 * steps, swiglu=2 * steps,
             swiglu_bwd=steps, flash_attention_fwd=2 * steps,
             flash_attention_bwd=steps, adamw_update=KIMI_LEAVES * steps),
        n_layers=1, cut=dict(n_experts=KIMI_TRAIN_EXPERTS), remat=True,
        depth=f"1 of 61 layers and {KIMI_TRAIN_EXPERTS} of 384 experts "
        "(top-8 kept): W = 2 would need ~103 GB")[0]


def count_beyond(a, b, atol: float = 1e-5) -> tuple[int, float]:
    """(elements of a more than atol (1 + |b|) from b, the largest |a - b|)
    over chunks of 2^24 elements of two tensors on the card."""
    a, b = a.reshape(-1), b.reshape(-1)
    off, big, step = 0, 0.0, 1 << 24
    for i in range(0, a.numel(), step):
        bi = b[i:i + step]
        d = (a[i:i + step] - bi).abs()
        off += int((d > atol * (1 + bi.abs())).sum())
        big = max(big, float(d.max()))
    return off, big


def phase_train_kimi_gate(torch, np):
    """`train_kimi`'s gate, on the card alone (its state, 51.7 GB, has no
    CPU side at this size; tests/test_torch_moe.py holds the CPU's parity
    at the smoke config): the same params (seed 3) and batches with the
    port's kernels and with the plain versions (`plain_versions_on_card`).

    * The first step at the same params: the loss and the aux loss within
      1e-5 relative, every gradient leaf within 1e-4 relative L2 (the SSM
      gates' rule for the first step's gradients).
    * One QSR round (H = 2 at the recipe's peak lr) from those params, and
      as the yardstick the plain round from the params moved by one ulp
      (`torch.nextafter`: a sum-order-sized change of every weight).  The
      SSM gates' rule for the later steps with the plain round as the
      reference and the yardstick's distance from it in the plain card's
      place: the first step's loss and grad norm within 1e-4 relative,
      the second's within max(1e-4, twice the yardstick's); after the
      round's sync the elements beyond 1e-5 of the plain round's, over
      all leaves, at most max(1 in 2,000, twice the yardstick's count),
      and none beyond 4 lr.  (After the first AdamW step, sign(g), the
      elements whose gradient sits at the sum-order noise part by ~2 lr
      whatever moved them: 1.35 M of the 3.23 G elements on an H100,
      0.12% of each expert leaf.)"""
    from repro_torch import tree as T
    from repro_torch.core import local_update as LU
    from repro_torch.core.sync import make_sync
    from repro_torch.data.synthetic import TokenStream, make_train_batch
    from repro_torch.kernels import ops
    from repro_torch.models import api, common as cm, param as pm

    t_phase = time.perf_counter()
    phase = "train_kimi_card_vs_plain"
    gc.collect()
    torch.cuda.empty_cache()
    cfg, run = lm_setup(1, KIMI_ARCH, dict(n_experts=KIMI_TRAIN_EXPERTS),
                        remat=True)
    mod = api.get_module(cfg)
    defs = mod.param_defs(cfg)
    lr = run.peak_lr

    def params(ulp=False):
        p = pm.init_params(defs, torch.Generator(device="cuda")
                           .manual_seed(3), device="cuda")
        if ulp:
            inf = torch.tensor(math.inf, device="cuda")
            for x in T.leaves(p):
                x.copy_(torch.nextafter(x, inf))
        return p
    stream = TokenStream(vocab=cfg.vocab, seed=0)
    batches = [T.map(lambda x: x.cuda(), make_train_batch(
        cfg, stream, t, 1, 1, LM_SEQ)) for t in range(2)]

    def first_step(plain):
        """(loss, aux, grads) at the seed's params on the first batch."""
        leaves, treedef = T.flatten(params())
        alias = [x.requires_grad_(True) for x in leaves]
        b = {k: v[0] for k, v in batches[0].items()}
        with (plain_versions_on_card() if plain
              else contextlib.nullcontext()):
            logits, aux = mod.forward(cfg, T.unflatten(treedef, alias),
                                      b["tokens"], remat=True)
            loss = cm.lm_loss(logits, b["labels"]) \
                + cfg.router_aux_coef * aux
            grads = torch.autograd.grad(loss, alias)
        return float(loss.detach()), float(aux.detach()), grads

    ops.reset_launch_counts()
    loss_k, aux_k, grads_k = first_step(False)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    loss_p, aux_p, grads_p = first_step(True)
    grad_errs = [float((a - b).norm() / b.norm().clamp_min(1e-30))
                 for a, b in zip(grads_k, grads_p)]
    del grads_k, grads_p
    torch.cuda.empty_cache()

    step_fn = LU.make_local_step(cfg, run, with_metrics=True)
    sync = make_sync(run)

    def rollout(plain, ulp=False):
        """One round of H = 2 from the seed's params (moved by one ulp):
        (params, losses, grad norms); the optimizer state is freed, the
        params stay on the card (12.9 GB: the plain round's beside a
        rollout make ~70 GB)."""
        st = LU.init_state(cfg, run, params(ulp), 1)
        losses, gns = [], []
        with (plain_versions_on_card() if plain
              else contextlib.nullcontext()):
            for batch in batches:
                st, (loss, gn) = step_fn(st, batch, lr)
                losses.append(float(loss))
                gns.append(float(gn))
        with torch.no_grad():
            st = sync(st)
        out = [x[0] for x in T.leaves(st["params"])]
        del st
        torch.cuda.empty_cache()
        return out, losses, gns

    def beyond(run_params):
        """(elements beyond 1e-5 of the plain round's by leaf, the largest
        difference)."""
        offs, worst = [], 0.0
        for a, b in zip(run_params, want):
            off, big = count_beyond(a, b)
            offs.append(off)
            worst = max(worst, big)
        return offs, worst

    want, losses_p, gns_p = rollout(True)
    got, losses_k, gns_k = rollout(False)
    offs, worst = beyond(got)
    del got
    torch.cuda.empty_cache()
    moved, losses_u, gns_u = rollout(True, ulp=True)
    yard_offs, yard_worst = beyond(moved)
    del moved, want
    torch.cuda.empty_cache()
    n_off, n_yard = sum(offs), sum(yard_offs)
    n_all = pm.count_params(defs)

    def rel(a, b):
        return abs(a - b) / abs(b)
    limits = {name: [1e-4, max(1e-4, 2 * rel(ys[1], xs[1]))]
              for name, xs, ys in (("loss", losses_p, losses_u),
                                   ("grad_norm", gns_p, gns_u))}
    fails = []
    for name, a, b, tol in (("loss", loss_k, loss_p, 1e-5),
                            ("aux", aux_k, aux_p, 1e-5)):
        if rel(a, b) > tol:
            fails.append(f"first-step {name} rel err {rel(a, b)} > {tol}")
    for i, e in enumerate(grad_errs):
        if e > 1e-4:
            fails.append(f"first-step gradient of leaf {i}: rel L2 {e}")
    for name, xs, ys in (("loss", losses_k, losses_p),
                         ("grad_norm", gns_k, gns_p)):
        for step, (a, b, lim) in enumerate(zip(xs, ys, limits[name])):
            if rel(a, b) > lim:
                fails.append(f"{name} rel err {rel(a, b)} > {lim} at step "
                             f"{step}")
    elem_limit = max(n_all // 2000, 2 * n_yard)
    if n_off > elem_limit:
        fails.append(f"{n_off} of {n_all} elements beyond 1e-5 > "
                     f"{elem_limit}")
    if worst > 4 * lr:
        fails.append(f"params differ by {worst}")
    emit(phase, arch=cfg.name, layers=cfg.n_layers, experts=cfg.n_experts,
         workers=1, b_loc=1, seq=LM_SEQ, remat=True,
         first_step_launches=counts, loss=loss_k, plain_loss=loss_p,
         aux=aux_k, plain_aux=aux_p, first_grad_rel_l2_by_leaf=grad_errs,
         losses=losses_k, plain_losses=losses_p, grad_norms=gns_k,
         plain_grad_norms=gns_p, ulp_losses=losses_u, ulp_grad_norms=gns_u,
         limits_by_step=limits, params_beyond_1e5=n_off, params=n_all,
         elements_limit=elem_limit, beyond_1e5_by_leaf=offs,
         max_param_abs_err=worst, ulp_params_beyond_1e5=n_yard,
         ulp_beyond_1e5_by_leaf=yard_offs, ulp_max_param_abs_err=yard_worst,
         failures=fails, seconds=time.perf_counter() - t_phase)
    check(not fails, f"{phase}: " + "; ".join(fails))


# ---------------------------------------------------- one rank a process --

# the sync harness's configurations on the card (multihost `run_sync` on its
# demo params, 3 rounds each, 4 ranks over gloo), after the 2-rank probe
MESH_SYNC_SUITE = [
    {"mode": "probe"},
    {"mode": "sync", "mesh": "2x2", "policy": "dp", "quantize": True},
    {"mode": "sync", "mesh": "2x2", "policy": "dp", "quantize": True,
     "momentum": 0.9},
    {"mode": "sync", "mesh": "2x2", "policy": "dp", "quantize": True,
     "overlap": True},
    {"mode": "sync", "mesh": "4x1", "policy": "dp", "quantize": True,
     "membership": "1,1,0,1"},
    {"mode": "sync", "mesh": "4x1", "policy": "dp", "quantize": True,
     "wire": "ring-int8"},
    {"mode": "sync", "mesh": "2x1x2", "policy": "fsdp", "quantize": True},
]
MESH_RANKS = 4
# ViT-B/16 on a mesh of 4 ranks on the one card: 2x2 dp (W = 2 workers x S
# = 2 shards) with the quantized flat_sharded sync at the auto wire, 2
# rounds of H = 2; then 4x1 dp (W = 4, S = 1) on the ring-int8 wire, 1
# round of H = 2.  The 2x2 run saves its state as a manifest and restores
# it (`ckpt`); the 4x1 run then restores that manifest at its own W
# (`restore`: the whole route)
MESH_TRAIN = [{"mesh": "2x2", "wire": "auto", "rounds": 2, "ckpt": True},
              {"mesh": "4x1", "wire": "ring-int8", "rounds": 1,
               "restore": True}]
MESH_H = 2
# elastic_chaos: the reference's story at its smoke config, 4 ranks on the
# card over gloo, the one-process references on the card too
ELASTIC = dict(num_workers=4, rounds=3, chaos="preempt-restore",
               heartbeat_timeout=8, timeout=300)


def mesh_spawn(torch, argv, timeout: float):
    """Spawn MESH_RANKS ranks running `argv` (a file store in a temporary
    directory); returns each rank's last JSON line, failing on a nonzero
    exit or a missing result."""
    from repro_torch.launch import multihost
    results = multihost.spawn_workers(MESH_RANKS, argv=argv, timeout=timeout)
    outs = []
    for i, (rc, so, se) in enumerate(results):
        rec = multihost.last_json(so)
        check(rc == 0 and rec is not None,
              f"mesh rank {i} exited {rc}: {(se or '')[-3000:]}")
        outs.append(rec)
    return outs


def phase_mesh_probe(torch):
    """NCCL at world size 1 on cuda:0 (this process): every verb of the
    mesh on device tensors, which shows NCCL initialises and takes them
    (the verbs over gloo, 2 and 4 ranks on the one card, open the
    `mesh_sync` suite)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import multihost
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-nccl-")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        out = multihost.probe(backend="nccl", device=torch.device("cuda", 0))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    emit("mesh_probe", backend="nccl", world_size=1, ok=out["ok"],
         checks=out["checks"], mesh_stats=out["mesh_stats"],
         seconds=time.perf_counter() - t0)
    check(out["ok"], f"mesh_probe: {out['checks']}")


def phase_mesh_sync(torch, counts):
    """The sync harness (`multihost` suite mode: the probe, then
    MESH_SYNC_SUITE) on 4 ranks over gloo on the card, and the same suite
    on 4 CPU ranks beside it.  Gates: every rank's chunks equal the host
    path's (`ok`: bitwise, the ring within `ring_tolerance`), every rank's
    digest and the CPU's equal, the shard hashes' union the CPU's (the
    ring: its digest), and the bf16 bucket's launches of
    `sync_flat_update` (the host path) and `sync_apply_update` (the
    collective apply) counted."""
    import concurrent.futures
    t0 = time.perf_counter()
    base = [sys.executable, "-m", "repro_torch.launch.multihost", "--mode",
            "suite", "--backend", "gloo", "--suite",
            json.dumps(MESH_SYNC_SUITE)]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        cpu = pool.submit(mesh_spawn, torch, base + ["--device", "cpu"], 300)
        card = mesh_spawn(torch, base + ["--device", "cuda"], 300)
        cpu = cpu.result()
    bf16 = {"sync_flat_update": 0, "sync_apply_update": 0}
    for i, c in enumerate(MESH_SYNC_SUITE):
        ranks = [r["results"][i] for r in card]
        cpus = [r["results"][i] for r in cpu]
        ok = all(r["ok"] for r in ranks + cpus)
        line = dict(config=c, ok=ok, ranks=len(ranks),
                    device=ranks[0]["device"],
                    mesh_stats=[r["mesh_stats"] for r in ranks])
        if c["mode"] == "sync":
            digests = {r["digest"] for r in ranks + cpus}
            hashes, cpu_hashes = {}, {}
            for r in ranks:
                hashes.update(r["shard_hashes"])
            for r in cpus:
                cpu_hashes.update(r["shard_hashes"])
            ring = c.get("wire") == "ring-int8"
            line.update(
                digest=sorted(digests)[0], digests_equal=len(digests) == 1,
                shard_hashes_equal_cpu=hashes == cpu_hashes,
                wire_dtype=ranks[0]["wire_dtype"],
                max_abs_diff=max(r["max_abs_diff"] for r in ranks),
                ring_tol=ranks[0]["ring_tol"],
                participant_exact=ranks[0]["participant_exact"],
                launches=[r["launches"] for r in ranks],
                bf16_launches=[r["bf16_launches"] for r in ranks])
            check(len(digests) == 1, f"mesh_sync {c}: digests {digests}")
            check(ring or hashes == cpu_hashes,
                  f"mesh_sync {c}: the card's shard hashes are not the CPU's")
            for r in ranks:
                for k in bf16:
                    bf16[k] += r["bf16_launches"][k]
                for k in ("sync_flat_update", "sync_apply_update",
                          "ring_combine", "ring_quantize"):
                    counts[k] += r["launches"].get(k, 0)
        emit("mesh_sync", **line)
        check(ok, f"mesh_sync {c}: a rank's chunks left the host path")
    emit("mesh_sync_bf16", bf16_launches=bf16,
         phase_seconds=time.perf_counter() - t0)
    check(all(v > 0 for v in bf16.values()),
          f"mesh_sync: bf16 launches {bf16}")


def mesh_train_reference(torch, np, spec) -> dict:
    """The single-process mesh-less engine on the card (ViT-B/16, W
    workers x B_LOC, layout flat_sharded with as many shards as ranks),
    `spec`'s rounds of H = MESH_H: for every rank's (worker, shard) slice,
    the hashes of the state each sync saw and left; and for the ring run
    the consensus after it, written for the ranks to compare with."""
    from repro_torch.launch.multihost import _parse_mesh
    from repro_torch.optim.lr import make_lr_fn
    dims, _ = _parse_mesh(spec["mesh"])
    w = dims[0]
    s_n = MESH_RANKS // w
    _, run, _, _, eng = train_setup(
        torch, layout="flat_sharded", workers=w, sync_quantize=True,
        sync_wire=spec["wire"], shards=MESH_RANKS)
    lr_fn = make_lr_fn(run)
    state = eng.init_state()
    step, sync = eng._programs()
    seen = []

    def hashes(st):
        return {f"{i},{j}": _slice_hashes(st, i, j, s_n)
                for i in range(w) for j in range(s_n)}

    def traced(st):
        before = hashes(st)
        st = sync(st)
        seen.append({"before": before, "after": hashes(st)})
        return st

    eng._sync = traced
    t0 = time.perf_counter()
    losses = []
    for r in range(spec["rounds"]):
        state, m = eng.run_round(state, r * MESH_H, MESH_H, lr_fn)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    out = {"syncs": seen, "losses": losses,
           "seconds": time.perf_counter() - t0}
    if spec["wire"] == "ring-int8":
        path = os.path.join(CKPT_ROOT, "mesh_ring_anchor.pt")
        os.makedirs(CKPT_ROOT, exist_ok=True)
        torch.save({b: x.cpu() for b, x in state["anchor"].items()}, path)
        amax = 4.0 * MESH_H * run.peak_lr
        out.update(ref_file=path, amax_bound=amax)
    del state, eng, step, sync
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _slice_hashes(state, w, s, n_shards) -> dict:
    """sha1 of worker w's shard-s chunk of a single-process flat state's
    params and of shard s of its anchor."""
    import hashlib

    from repro_torch.launch.multihost import _bytes
    out = {}
    for b, x in state["params"].items():
        c = x.shape[1] // n_shards
        out[f"params/{b}"] = hashlib.sha1(
            _bytes(x[w, s * c:(s + 1) * c])).hexdigest()
    for b, x in state["anchor"].items():
        c = x.shape[0] // n_shards
        out[f"anchor/{b}"] = hashlib.sha1(
            _bytes(x[s * c:(s + 1) * c])).hexdigest()
    return out


def _rank_hashes(state) -> dict:
    """sha1 of a mesh rank's params chunk (its one lane) and anchor
    chunk, keyed as `_slice_hashes`."""
    import hashlib

    from repro_torch.launch.multihost import _bytes
    out = {f"params/{b}": hashlib.sha1(_bytes(x[0])).hexdigest()
           for b, x in state["params"].items()}
    out.update({f"anchor/{b}": hashlib.sha1(_bytes(x)).hexdigest()
                for b, x in state["anchor"].items()})
    return out


def mesh_train_rank(torch, spec, device) -> dict:
    """One rank of ViT-B/16 on `spec`'s mesh (run by `mesh_rank_main` in a
    spawned process): the mesh engine's rounds, each local step timed
    (host wall, and CUDA events on the rank's stream: the stream's span,
    its waits on the host's collectives included), each sync timed with
    its wire bytes and host staging, the hashes of the chunks each sync saw
    and left, and the peak memory."""
    from repro_torch.configs import registry as R
    from repro_torch.configs.base import RunConfig
    from repro_torch.core.engine import RoundEngine
    from repro_torch.data.synthetic import VisionStream, vision_batch_fn
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.multihost import _parse_mesh
    from repro_torch.models import param as pm
    from repro_torch.optim.lr import make_lr_fn

    dims, axes = _parse_mesh(spec["mesh"])
    mesh = Mesh(dims, axes, backend="gloo", device=device)
    cfg = R.get_config(TRAIN_ARCH)
    run = RunConfig(**{**TRAIN_RUN, "sync_quantize": True,
                       "sync_wire": spec["wire"]})
    w = pm.worker_count("dp", mesh)
    g = mesh.groups(pm.worker_mesh_axes("dp", mesh))
    stream = VisionStream(n_classes=cfg.n_classes, image=IMAGE, seed=42)
    torch.cuda.reset_peak_memory_stats(device)
    eng = RoundEngine(cfg, run, workers=w, b_loc=B_LOC, seq=1, data="host",
                      batch_fn=vision_batch_fn(stream, w, B_LOC,
                                               lanes=[g.worker_index]),
                      layout="flat_sharded", mesh=mesh, policy="dp")
    lr_fn = make_lr_fn(run)
    state = eng.init_state()
    step, sync = eng._programs()
    steps, syncs = [], []

    def timed_step(st, batch, lr):
        torch.cuda.synchronize(device)
        staged = mesh.stats.staging_s
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        out = step(st, batch, lr)
        ev[1].record()
        torch.cuda.synchronize(device)
        steps.append({"wall_ms": (time.perf_counter() - t0) * 1e3,
                      "event_ms": ev[0].elapsed_time(ev[1]),
                      "staging_ms": (mesh.stats.staging_s - staged) * 1e3})
        return out

    def timed_sync(st):
        before = _rank_hashes(st)
        torch.cuda.synchronize(device)
        wire = dict(mesh.stats.wire_bytes)
        calls = dict(mesh.stats.calls)
        staged = mesh.stats.staging_s
        t0 = time.perf_counter()
        st = sync(st)
        torch.cuda.synchronize(device)
        syncs.append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "staging_ms": (mesh.stats.staging_s - staged) * 1e3,
            "wire_bytes": {k: v - wire.get(k, 0)
                           for k, v in mesh.stats.wire_bytes.items()
                           if v - wire.get(k, 0)},
            "calls": {k: v - calls.get(k, 0)
                      for k, v in mesh.stats.calls.items()
                      if v - calls.get(k, 0)},
            "before": before, "after": _rank_hashes(st)})
        return st

    eng._step, eng._sync = timed_step, timed_sync
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    losses = []
    for r in range(spec["rounds"]):
        state, m = eng.run_round(state, r * MESH_H, MESH_H, lr_fn)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize(device)
    out = {"mesh": spec["mesh"], "wire": spec["wire"],
           "worker": g.worker_index, "shard": g.shard_index,
           "workers": w, "shards": g.n_shards, "losses": losses,
           "steps": steps, "syncs": syncs,
           "launches": {k: v for k, v in ops.launch_counts().items() if v},
           "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9,
           "seconds": time.perf_counter() - t0,
           "chunk": int(state["anchor"]["float32"].numel())}
    if spec.get("ckpt"):
        out["ckpt"] = rank_ckpt_sharded(torch, eng, state, spec["ckpt_dir"],
                                        device)
    if spec.get("ref_file"):
        ref = torch.load(spec["ref_file"], map_location=device)
        diff = 0.0
        for b, x in ref.items():
            c = state["anchor"][b].numel()
            part = x[g.shard_index * c:(g.shard_index + 1) * c]
            diff = max(diff, float((state["params"][b][0] - part).abs().max()),
                       float((state["anchor"][b] - part).abs().max()))
        out["max_abs_diff_vs_host_ring"] = diff
    if spec.get("restore"):
        out["restore"] = rank_restore_other_w(torch, eng, spec["ckpt_dir"],
                                              state, device)
    return out


def leaf_hashes(torch, tree) -> list:
    """sha1 of every tensor leaf's bytes, in tree order."""
    import hashlib

    from repro_torch import tree as T
    from repro_torch.launch.multihost import _bytes
    return [hashlib.sha1(_bytes(x)).hexdigest() for x in T.leaves(tree)
            if isinstance(x, torch.Tensor)]


def rss_gb() -> float:
    """This process's resident host memory now (VmRSS), GB."""
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise SmokeFailure("/proc/self/status has no VmRSS")


def with_rss_peak(fn):
    """(fn(), the peak of this process's resident host memory while fn ran,
    GB): VmRSS sampled every 20 ms on a thread (`getrusage`'s peak would
    carry a spawning parent's over the exec, and VmHWM is not there on
    every kernel)."""
    import threading
    peak, done = [rss_gb()], threading.Event()

    def sample():
        while not done.wait(0.02):
            peak[0] = max(peak[0], rss_gb())

    th = threading.Thread(target=sample, daemon=True)
    th.start()
    try:
        out = fn()
    finally:
        done.set()
        th.join()
    return out, max(peak[0], rss_gb())


def rank_ckpt_sharded(torch, eng, state, path, device) -> dict:
    """`ckpt_sharded` on one rank of `train_mesh` (after its rounds):
    `save_sharded` of the state it holds (its shard file, the barrier, rank
    0's manifest, the barrier), then `restore_elastic` (the fast path: its
    own blocks), gated bitwise against what it held; the seconds, the bytes
    of its shard file, its peak host RSS, and every leaf's sha1 for the
    parent's restores."""
    from repro_torch import tree as T
    from repro_torch.checkpoint import io as ckpt_io
    step = eng.h_trace[-1][0] + eng.h_trace[-1][1]
    torch.cuda.synchronize(device)
    rss_before = rss_gb()
    t0 = time.perf_counter()
    _, save_rss = with_rss_peak(
        lambda: eng.save_sharded(path, state, step=step))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (got, got_step), restore_rss = with_rss_peak(
        lambda: eng.restore_elastic(path, state))
    torch.cuda.synchronize(device)
    restore_s = time.perf_counter() - t0
    bitwise = got_step == step and all(
        torch.equal(a, b) for a, b in zip(T.leaves(got), T.leaves(state)))
    del got
    g = eng._groups
    shard_file = os.path.join(path, ckpt_io._shard_fname(step,
                                                         eng.mesh.rank))
    return {"worker": g.worker_index, "shard": g.shard_index, "step": step,
            "save_s": save_s, "restore_s": restore_s,
            "host_available_gb": host_available_gb(),
            "file_bytes": os.path.getsize(shard_file),
            "state_bytes": sum(x.numel() * x.element_size()
                               for x in T.leaves(state)),
            "bitwise": bitwise, "peak_rss_gb": max(save_rss, restore_rss),
            "rss_before_gb": rss_before,
            "barriers": eng.mesh.stats.calls.get("barrier", 0),
            "hashes": leaf_hashes(torch, state)}


def rank_restore_other_w(torch, eng, path, like, device) -> dict:
    """`ckpt_sharded`'s other W on one rank of `train_mesh_ring` (4x1, W =
    4, after its round): `restore_elastic` of `train_mesh`'s manifest (W =
    2 on 2x2) by the whole route (the state assembled on the host,
    converted on the rank's device, sliced to its chunks), one rank at a
    time between barriers (4 whole states at once would share one card);
    its seconds, its host RSS before and at peak, the device memory it
    took beyond what it held, and every leaf's sha1 for the parent's
    gate."""
    from repro_torch import tree as T
    mesh, out = eng.mesh, None
    for turn in range(mesh.size):
        if turn == mesh.rank:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            held = torch.cuda.memory_allocated(device)
            rss_before = rss_gb()
            t0 = time.perf_counter()
            (got, step), peak_rss = with_rss_peak(
                lambda: eng.restore_elastic(path, like))
            torch.cuda.synchronize(device)
            restore_s = time.perf_counter() - t0
            out = {"worker": eng._groups.worker_index, "step": step,
                   "restore_s": restore_s, "rss_before_gb": rss_before,
                   "peak_rss_gb": peak_rss,
                   "peak_device_gb_beyond_held":
                   (torch.cuda.max_memory_allocated(device) - held) / 1e9,
                   "state_bytes": sum(x.numel() * x.element_size()
                                      for x in T.leaves(got)
                                      if isinstance(x, torch.Tensor)),
                   "host_available_gb": host_available_gb(),
                   "hashes": leaf_hashes(torch, got)}
            del got
        mesh.barrier()
    return out


def phase_ckpt_sharded(torch, np, ranks, others, path, spawn_s) -> None:
    """ViT-B/16's `train_mesh` state (2x2 dp, W = 2 x S = 2, 4 ranks on the
    card) as a manifest checkpoint: each rank saved and restored it in the
    spawn (`rank_ckpt_sharded`: bitwise what it held), and each rank of
    `train_mesh_ring` (4x1, W = 4) restored it at its own W by the whole
    route (`rank_restore_other_w`: `others`); this process then restores
    the manifest into the mesh-less engine of `train_mesh`'s reference (W
    = 2, flat_sharded, 4 shards: every rank's chunks bitwise) and into one
    at W = 4 (lanes 0-1 bitwise W = 2's, lanes 2-3 bitwise lane 0, params
    and moments; and each 4x1 rank's state bitwise its worker's chunks).
    `seconds` is this process's part; the ranks' part is inside
    `train_mesh_ring`'s spawn."""
    from repro_torch.core import flat
    t0 = time.perf_counter()
    avail_gb = host_available_gb()
    rr = [r["ckpt"] for r in ranks]
    fails = [f"rank {i}: the restored state is not what it saved"
             for i, r in enumerate(rr) if not r["bitwise"]]
    files = sorted(f for f in os.listdir(path) if f.startswith("shards-"))
    file_bytes = sum(os.path.getsize(os.path.join(path, f)) for f in files)
    restores, rss, held = {}, {}, None
    for w in (2, 4):
        _, run, _, _, eng = train_setup(torch, layout="flat_sharded",
                                        workers=w, sync_quantize=True,
                                        shards=MESH_RANKS)
        like = eng.init_state()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (st, step), rss[w] = with_rss_peak(
            lambda: eng.restore_elastic(path, like))
        torch.cuda.synchronize()
        restores[w] = time.perf_counter() - t1
        del like
        if step != rr[0]["step"]:
            fails.append(f"W = {w} restored step {step}, not {rr[0]['step']}")
        if w == 2:
            for r in rr:
                mine = flat.take_slices(st, flat.flat_state_slices(
                    run, eng.spec, r["worker"], r["shard"], 2))
                if leaf_hashes(torch, mine) != r["hashes"]:
                    fails.append(f"W = 2: worker {r['worker']} shard "
                                 f"{r['shard']} is not the rank's state")
            held = st
            continue
        lanes = [st["params"]] + [st["opt"][k] for k in ("m", "v")]
        ref = [held["params"]] + [held["opt"][k] for k in ("m", "v")]
        for got, want in zip(lanes, ref):
            for b, x in got.items():
                if not torch.equal(x[:2], want[b]):
                    fails.append(f"W = 4: lanes 0-1 of {b} are not W = 2's")
                if not (torch.equal(x[2], x[0]) and torch.equal(x[3], x[0])):
                    fails.append(f"W = 4: lanes 2-3 of {b} are not lane 0")
        for b, x in st["anchor"].items():
            if not torch.equal(x, held["anchor"][b]):
                fails.append(f"W = 4: the anchor of {b} is not W = 2's")
        for r in others:
            mine = flat.take_slices(st, flat.flat_state_slices(
                run, eng.spec, r["worker"], 0, 1))
            if r["step"] != step or leaf_hashes(torch, mine) != r["hashes"]:
                fails.append(f"4x1 rank of worker {r['worker']}: its "
                             "restore is not W = 4's lane")
        del st, eng
    del held
    gc.collect()
    torch.cuda.empty_cache()
    gb = sum(r["file_bytes"] for r in rr) / 1e9
    save_wall = max(r["save_s"] for r in rr)
    restore_wall = max(r["restore_s"] for r in rr)
    emit("ckpt_sharded", mesh="2x2", workers=2, shards=2, ranks=len(rr),
         step=rr[0]["step"], shard_files=len(files),
         shard_file_bytes=file_bytes, state_bytes_per_rank=[
             r["state_bytes"] for r in rr],
         file_bytes_per_rank=[r["file_bytes"] for r in rr],
         save_s_per_rank=[r["save_s"] for r in rr],
         restore_s_per_rank=[r["restore_s"] for r in rr],
         save_gb_s_per_rank=[r["file_bytes"] / 1e9 / r["save_s"] for r in rr],
         restore_gb_s_per_rank=[r["state_bytes"] / 1e9 / r["restore_s"]
                                for r in rr],
         save_gb_s_whole=gb / save_wall,
         restore_gb_s_whole=sum(r["state_bytes"] for r in rr) / 1e9
         / restore_wall,
         rank_peak_rss_gb=[r["peak_rss_gb"] for r in rr],
         rank_host_available_gb=[r["host_available_gb"] for r in rr],
         barriers_per_rank=[r["barriers"] for r in rr],
         ranks_bitwise=all(r["bitwise"] for r in rr),
         restore_s_meshless={f"W{w}": t for w, t in restores.items()},
         rank_rss_before_gb=[r["rss_before_gb"] for r in rr],
         other_w={"mesh": "4x1", "workers": 4, "route": "whole",
                  "bitwise": not any("4x1" in f for f in fails),
                  "restore_s_per_rank": [r["restore_s"] for r in others],
                  "read_gb_s_per_rank": [file_bytes / 1e9 / r["restore_s"]
                                         for r in others],
                  "state_bytes_per_rank": [r["state_bytes"] for r in others],
                  "rss_before_gb": [r["rss_before_gb"] for r in others],
                  "peak_rss_gb": [r["peak_rss_gb"] for r in others],
                  "peak_device_gb_beyond_held": [
                      r["peak_device_gb_beyond_held"] for r in others],
                  "host_available_gb": [r["host_available_gb"]
                                        for r in others]},
         parent_peak_rss_gb={f"W{w}": g for w, g in rss.items()},
         rank_spawn_seconds=spawn_s,
         host_available_gb=[avail_gb, host_available_gb()],
         launches=0, failures=fails, seconds=time.perf_counter() - t0)
    check(not fails, "ckpt_sharded: " + "; ".join(fails))


def phase_elastic_chaos(torch, counts) -> None:
    """`multihost.run_elastic` (`ELASTIC`: 4 workers, 3 rounds,
    preempt-restore) at the reference's smoke config: every generation's
    ranks on the card over gloo, the one-process references on the card.
    Gates, the reference's own (its tests/test_chaos.py): gen 0 rank 2
    exits 7 and the others 3 with the verdict missing [2], resume round 1;
    gen 1's consensus bitwise the one-process 3-lane run and its moments
    within the norms tolerance (1e-5); gen 2 within 1e-5 of the 4-lane
    run's norms and 1e-4 of its losses (its bitwise reported).  The
    kernels' launches are the ranks' and references' sums."""
    from repro_torch.launch import multihost
    t0 = time.perf_counter()
    avail_gb = host_available_gb()
    wd = ckpt_path("elastic")
    tel = multihost.run_elastic(workdir=wd, device="cuda", backend="gloo",
                                **ELASTIC)
    gens = tel["generations"]
    fails = [] if tel["ok"] else ["the controller's verdict is not ok"]
    g0 = gens[0]
    if not (g0["rcs"][2] == 7 and all(rc == 3 for i, rc in
                                      enumerate(g0["rcs"]) if i != 2)
            and len(g0["verdicts"]) == 3
            and all(v["missing"] == [2] and v["resume_round"] == 1
                    for v in g0["verdicts"])):
        fails.append(f"gen 0: rcs {g0['rcs']}, verdicts {g0['verdicts']}")
    if len(gens) > 1 and not (gens[1]["bitwise_vs_single_process"]
                              and gens[1]["moments_tolerance_ok"]):
        fails.append("gen 1 parted from the one-process 3-lane run")
    if len(gens) < 3 or not gens[2]["tolerance_vs_single_process"]:
        fails.append("gen 2 is not within the tolerance of the one-process "
                     "4-lane run")
    # the kernels the generations launched: the ranks' (over their steps,
    # 2 a round: gen 0's survivors ran round 0) and the references'
    launched, ref_launched, steps = {}, {}, 0
    for g in gens:
        if "verdicts" in g:
            steps += sum(2 * v["rounds_done"] for v in g["verdicts"])
        else:
            steps += 2 * len(g.get("losses") or []) * g["lanes"]
        for dst, src in ((launched, g.get("launches") or {}),
                         (ref_launched, g.get("reference_launches") or {})):
            for k, v in src.items():
                dst[k] = dst.get(k, 0) + v
    for src in (launched, ref_launched):
        for k, v in src.items():
            if k in counts:
                counts[k] += v
    shutil.rmtree(wd, ignore_errors=True)
    emit("elastic_chaos", **{k: v for k, v in ELASTIC.items()},
         arch="starcoder2-3b (smoke)", device=tel.get("device"),
         generations=[{k: v for k, v in g.items() if k != "verdicts"}
                      for g in gens],
         verdicts=g0["verdicts"], ok=tel["ok"],
         gen2_bitwise_vs_single_process=(gens[2]["bitwise_vs_single_process"]
                                         if len(gens) > 2 else None),
         launches=launched, reference_launches=ref_launched,
         rank_steps=steps,
         launches_per_rank_step={k: v / steps for k, v in launched.items()}
         if steps else None, host_available_gb=avail_gb, failures=fails,
         seconds=time.perf_counter() - t0)
    check(not fails, "elastic_chaos: " + "; ".join(fails))


def mesh_rank_main(arg: str) -> int:
    """A spawned rank of `phase_train_mesh`: its runs in order, one JSON
    line."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import multihost
    spec = json.loads(arg)
    multihost.initialize(backend="gloo")
    try:
        device = multihost.rank_device("cuda", "gloo")
        runs = [mesh_train_rank(torch, r, device) for r in spec["runs"]]
    finally:
        dist.destroy_process_group()
    print(json.dumps({"ok": True, "runs": runs}), flush=True)
    return 0


def phase_train_mesh(torch, np, counts):
    """ViT-B/16 at full width on meshes of 4 ranks, one process each, all
    on the one card over gloo (`MESH_TRAIN`): `train_mesh` (2x2 dp: W = 2 x
    S = 2, the int16 code sums reduce-scattered and gathered) held bitwise,
    sync by sync, against the single-process mesh-less engine at W = 2
    (flat_sharded, 4 shards) on the card — the chunks each sync saw and
    the consensus it left; `train_mesh_ring` (4x1 dp, the ring-int8 wire)
    held within `ring_tolerance` of the single-process host ring.  The
    references run first, then one spawn of the 4 ranks runs both meshes:
    the first line's `seconds` are the references', the second's the
    spawn's."""
    from repro_torch.core.sync import ring_tolerance
    t0 = time.perf_counter()
    refs = [mesh_train_reference(torch, np, spec) for spec in MESH_TRAIN]
    runs = []
    ckpt_dir = ckpt_path("mesh_sharded")
    for spec, ref in zip(MESH_TRAIN, refs):
        runs.append(dict(spec, ref_file=ref.get("ref_file"),
                         ckpt_dir=ckpt_dir if spec.get("ckpt")
                         or spec.get("restore") else None))
    ref_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    ranks = mesh_spawn(torch, [sys.executable, os.path.join(ROOT,
                                                            "chip_smoke.py"),
                               "--mesh-rank", json.dumps({"runs": runs})],
                       600)
    spawn_s = time.perf_counter() - t1
    for k, (spec, ref) in enumerate(zip(MESH_TRAIN, refs)):
        phase = "train_mesh" if spec["wire"] == "auto" else "train_mesh_ring"
        rr = [r["runs"][k] for r in ranks]
        fails = []
        n_sync = len(ref["syncs"])
        before_eq = after_eq = True
        # the syncs whose chunks (seen or left) part from the reference's
        parted = []
        for r in rr:
            key = f"{r['worker']},{r['shard']}"
            for i in range(n_sync):
                for when in ("before", "after"):
                    bad = [k for k, v in r["syncs"][i][when].items()
                           if v != ref["syncs"][i][when][key][k]]
                    if bad:
                        parted.append({"rank": key, "sync": i, "when": when,
                                       "keys": bad})
                before_eq &= r["syncs"][i]["before"] == \
                    ref["syncs"][i]["before"][key]
                after_eq &= r["syncs"][i]["after"] == \
                    ref["syncs"][i]["after"][key]
            for kern, v in r["launches"].items():
                if kern in counts:
                    counts[kern] += v
        tol = None
        if spec["wire"] == "auto":
            if not after_eq:
                fails.append("a rank's consensus is not the single-process "
                             "run's after a sync")
        else:
            tol = ring_tolerance(rr[0]["workers"], ref["amax_bound"],
                                 spec["rounds"])
            worst = max(r["max_abs_diff_vs_host_ring"] for r in rr)
            if worst > tol:
                fails.append(f"ring {worst} > ring_tolerance {tol}")
        losses = {tuple(r["losses"]) for r in rr}
        if len(losses) != 1:
            fails.append(f"ranks report different losses {losses}")
        steps = [s for r in rr for s in r["steps"]]
        syncs = [s for r in rr for s in r["syncs"]]
        emit(phase, mesh=spec["mesh"], wire=spec["wire"],
             workers=rr[0]["workers"], shards=rr[0]["shards"], b_loc=B_LOC,
             rounds=spec["rounds"], h=MESH_H, ranks=len(rr),
             chunk_elements=rr[0]["chunk"],
             losses=rr[0]["losses"], reference_losses=ref["losses"],
             presync_bitwise=before_eq, consensus_bitwise=after_eq,
             parted_from_reference=parted,
             max_abs_diff_vs_host_ring=(
                 None if tol is None else
                 max(r["max_abs_diff_vs_host_ring"] for r in rr)),
             ring_tolerance=tol,
             wall_ms_per_step=sum(s["wall_ms"] for s in steps) / len(steps),
             event_ms_per_step=sum(s["event_ms"] for s in steps) / len(steps),
             staging_ms_per_step=sum(s["staging_ms"] for s in steps)
             / len(steps),
             ms_per_sync=sum(s["ms"] for s in syncs) / len(syncs),
             staging_ms_per_sync=sum(s["staging_ms"] for s in syncs)
             / len(syncs),
             wire_bytes_per_sync_per_rank=rr[0]["syncs"][0]["wire_bytes"],
             calls_per_sync_per_rank=rr[0]["syncs"][0]["calls"],
             peak_gb_per_rank=[r["peak_gb"] for r in rr],
             rank_seconds=[r["seconds"] for r in rr],
             launches_per_rank=[r["launches"] for r in rr],
             reference_seconds=ref["seconds"], failures=fails,
             seconds=(ref_s if k == 0 else 0.0) + (spawn_s if k == 1 else 0.0))
        check(not fails, f"{phase}: " + "; ".join(fails))
    for ref in refs:
        if ref.get("ref_file"):
            os.remove(ref["ref_file"])
    k = next(i for i, spec in enumerate(MESH_TRAIN) if spec.get("ckpt"))
    j = next(i for i, spec in enumerate(MESH_TRAIN) if spec.get("restore"))
    try:
        phase_ckpt_sharded(torch, np, [r["runs"][k] for r in ranks],
                           [r["runs"][j]["restore"] for r in ranks],
                           ckpt_dir, spawn_s)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.models import common  # noqa: F401  (turns TF32 off)

    t_run = time.perf_counter()
    smi = nvidia_smi()
    host_low = watch_host_memory()
    # whether this machine has msgpack: nothing uses it (the checkpoints
    # are read and written by repro_torch/checkpoint/wire.py)
    emit("env", gpu=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device_name=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         host_available_gb=host_available_gb(),
         msgpack_importable=importlib.util.find_spec("msgpack") is not None)

    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    # the training gates' inputs, and their CPU sides on a background thread
    # beside every phase up to them
    t0 = time.perf_counter()
    gates = start_gate_cpu_sides(torch)
    gates_s = time.perf_counter() - t0
    try:
        return run_phases(torch, np, build, smi, t_run, build_s, gates,
                          gates_s, host_low)
    finally:
        for gate in gates.values():
            if "cpu" in gate:
                gate["cpu"].cancel()


def run_phases(torch, np, build, smi, t_run, build_s, gates,
               gates_s, host_low) -> int:
    emit("build", seconds=build_s,
         nvcc_seconds=build.build_seconds,
         sources=[str(p.relative_to(ROOT)) for p in build.sources()],
         ptxas=[ln.strip() for ln in build.ptxas_log.splitlines()
                if "entry function" in ln or "registers" in ln
                or "spill" in ln])
    emit("gate_setup", seconds=gates_s, archs=list(gates),
         workers={k: g["w"] for k, g in gates.items()},
         host_available_gb=host_available_gb())
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 must be off")

    max_len = max(PROMPT_LENS) + MAX_NEW
    timed, rows = phase_kernels(torch, max_len)
    t_summary, t_rows = phase_training_kernels(torch)
    timed.update(t_summary)
    rows.update(t_rows)
    timed.update(phase_sync_kernels(torch))
    bf16_rows = phase_sync_bf16(torch)
    b_summary, b_rows = phase_backward_kernels(torch)
    timed.update(b_summary)
    rows.update(b_rows)
    # each path's counts at 0 just before it and read just after; a
    # kernel's launches in the `kernels` line sum the paths that run it
    counts = dict.fromkeys(SOURCES, 0)

    def add(path_counts, names):
        for k in names:
            counts[k] += path_counts[k]

    serve, gen = phase_service(torch, np, rows)
    add(serve, SERVING_KERNELS)
    add(gen, SERVING_KERNELS + ("flash_attention_fwd",))
    phase_card_vs_cpu(torch, np)
    phase_hot_swap(torch, np)
    serve, gen = phase_service_starcoder2(torch, np)
    add(serve, ("flash_decode",))
    add(gen, ("flash_decode", "flash_attention_fwd"))
    phase_card_vs_cpu(torch, np, LM_ARCH)
    # phi3-medium-14b (untied head, d = 5120), qwen1.5-110b (QKV bias, d =
    # 8192) and paligemma-3b (the image prefix)
    for phase in (phase_service_phi3, phase_service_qwen):
        serve, gen = phase(torch, np)
        add(serve, SERVING_KERNELS)
        add(gen, SERVING_KERNELS + ("flash_attention_fwd",))
    add(phase_generate_paligemma(torch, np, rows),
        SERVING_KERNELS + ("flash_attention_fwd",))
    phase_card_vs_cpu(torch, np, PHI3_ARCH)
    phase_card_vs_cpu(torch, np, QWEN_ARCH, n_layers=1)
    phase_card_vs_cpu(torch, np, VLM_ARCH)
    # whisper-base (the audio family), and ring-buffer serving
    add(phase_generate_whisper(torch, np),
        ("flash_decode", "flash_attention_fwd"))
    add(phase_generate_ring(torch, np),
        SERVING_KERNELS + ("flash_attention_fwd",))
    # the SSM families: mamba2 (conv and SSM state in the cache) and
    # zamba2 (its shared attention block, flat and through a ring)
    serve, gen = phase_service_mamba2(torch, np, rows)
    add(serve, ("rms_norm",))
    add(gen, ("rms_norm",))
    for path in phase_serve_zamba2(torch, np, rows):
        add(path, ("rms_norm", "flash_decode", "flash_attention_fwd"))
    # the MoE family (the routed experts are batched products): dbrx-132b
    # runs attention's kernels alone, kimi-k2 its norms and shared expert too
    serve, gen = phase_service_dbrx(torch, np, rows)
    add(serve, ("flash_decode",))
    add(gen, ("flash_decode", "flash_attention_fwd"))
    phase_card_vs_cpu_moe(torch, np, DBRX_ARCH)
    serve, gen = phase_service_kimi(torch, np, rows)
    add(serve, SERVING_KERNELS)
    add(gen, SERVING_KERNELS + ("flash_attention_fwd",))
    phase_card_vs_cpu_moe(torch, np, KIMI_ARCH)
    add(phase_train(torch, np), TRAINING_KERNELS[:3])
    flat, flat_state = phase_train_flat_quantized(torch, np)
    add(flat, ("sync_flat_update",))
    phase_train_card_vs_cpu(torch, np)
    # the sync variants
    overlap, walls = phase_train_overlap(torch, np, flat_state)
    del flat_state
    add(overlap, ("sync_apply_update",))
    add(phase_train_partial(torch, np), ("sync_apply_update",))
    add(phase_train_ring(torch, np), SYNC_KERNELS)
    phase_train_card_vs_cpu_overlap(torch, np)
    # the adaptive controller: H, the effective batch and the overlap depth
    # decided at round boundaries from the run's telemetry
    add(phase_train_adaptive(torch, np, walls),
        TRAINING_KERNELS[:3] + ("sync_apply_update",))
    phase_train_adaptive_card_vs_cpu(torch, np)
    # one rank a process: NCCL at one rank, the sync harness on 4 ranks over
    # gloo (the collective halves, the int16 ring, the bf16 instances), and
    # ViT-B/16 on meshes of 4 ranks against the single-process engine
    phase_mesh_probe(torch)
    phase_mesh_sync(torch, counts)
    torch.cuda.empty_cache()
    phase_train_mesh(torch, np, counts)
    # elastic rounds: a rank killed, the survivors on a reduced mesh, the
    # lane rejoining from the manifest checkpoint
    phase_elastic_chaos(torch, counts)
    # the LM training path, on host and on device data
    lm_counts, lm_row = phase_train_lm(torch, np)
    add(lm_counts, TRAINING_KERNELS[:3])
    # microbatch 2 and 4: gradient accumulation over chunks of each batch
    add(phase_train_microbatch(torch, np, lm_row), TRAINING_KERNELS[:3])
    add(phase_train_lm_device(torch, np, lm_row), TRAINING_KERNELS[:3])
    phase_train_lm_full_depth(torch, np)
    phase_train_lm_card_vs_cpu(torch, np, LM_ARCH, gates.pop(LM_ARCH))
    # gemma3 training: the rms_norm / swiglu backward kernels
    add(phase_train_gemma3(torch, np),
        ("rms_norm", "swiglu") + BACKWARD_KERNELS + TRAINING_KERNELS[:3])
    phase_train_lm_card_vs_cpu(torch, np, G3_ARCH, gates.pop(G3_ARCH))
    rms_swiglu = ("rms_norm", "swiglu") + BACKWARD_KERNELS + TRAINING_KERNELS[:3]
    add(phase_train_phi3(torch, np), rms_swiglu)
    phase_train_lm_card_vs_cpu(torch, np, PHI3_ARCH, gates.pop(PHI3_ARCH))
    add(phase_train_paligemma(torch, np), rms_swiglu)
    phase_train_lm_card_vs_cpu(torch, np, VLM_ARCH, gates.pop(VLM_ARCH))
    for data in ("host", "device"):
        add(phase_train_whisper(torch, np, data)[0], TRAINING_KERNELS[:3])
    phase_train_lm_card_vs_cpu(torch, np, WH_ARCH, gates.pop(WH_ARCH))
    # the SSM families through the rms_norm backward kernel
    add(phase_train_mamba2(torch, np),
        ("rms_norm", "rms_norm_bwd", "adamw_update"))
    phase_train_lm_card_vs_cpu(torch, np, M2_ARCH, gates.pop(M2_ARCH))
    add(phase_train_zamba2(torch, np),
        ("rms_norm", "rms_norm_bwd") + TRAINING_KERNELS[:3])
    phase_train_lm_card_vs_cpu(torch, np, Z2_ARCH, gates.pop(Z2_ARCH))
    # kimi-k2 training: the MoE backward, its aux loss and the backward
    # kernels at d = 7168
    add(phase_train_kimi(torch, np), rms_swiglu)
    phase_train_kimi_gate(torch, np)
    # checkpoints: resume across layouts, and train to serve
    try:
        phase_ckpt_resume(torch, np)
        add(phase_train_to_serve(torch, np), TRAINING_KERNELS[:3])
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    check(all(counts[k] > 0 for k in SOURCES),
          f"a kernel of a path never launched: {counts}")

    emit("attention_vs_cuda_core", **{name: dict(
        ms=timed[name]["ms"], cuda_core_ms=CUDA_CORE_MS[name],
        library_ms=timed[name]["library_ms"],
        bound_ms=timed[name]["bound_ms"],
        bound_fp32_ms=timed[name]["bound_fp32_ms"],
        speedup_vs_cuda_core=CUDA_CORE_MS[name] / timed[name]["ms"],
        speedup_vs_library=timed[name]["library_ms"] / timed[name]["ms"])
        for name in CUDA_CORE_MS})
    # the LM path's shapes, beside each kernel's main-path row
    rows_n = (SLOTS, BWD_ROWS, PREFILL_B * PREFILL_LEN)
    lm_shapes = {
        "rms_norm": [f"[{PREFILL_B * PREFILL_LEN},2560]"]
        + [f"[{n},{PHI3_D}]" for n in rows_n]
        + [f"[{n},{QWEN_D}]" for n in rows_n[1:]]
        + [f"[{n},{d}]" for n, d in SSM_NORM_ROWS + KIMI_NORM_ROWS],
        "rms_norm_bwd": [f"[{BWD_ROWS},{PHI3_D}]", f"[{BWD_ROWS},{QWEN_D}]",
                         f"[{M2_B * LM_SEQ},1536]",
                         f"[{Z2_B * LM_SEQ},4096]",
                         f"[{BWD_ROWS},{KIMI_D}]"],
        "swiglu_bwd": [f"[{BWD_ROWS},{KIMI_D}]x[{KIMI_D},{KIMI_F}]"],
        "swiglu": [f"[{n},2560]x[2560,10240]"
                   for n in (16, 48, 128, 256, PREFILL_B * PREFILL_LEN)]
        + [f"[{n},{PHI3_D}]x[{PHI3_D},17920]" for n in (SLOTS, BWD_ROWS)]
        + [f"[{SLOTS},{QWEN_D}]x[{QWEN_D},49152]"]
        + [f"[{n},{KIMI_D}]x[{KIMI_D},{KIMI_F}]" for n in rows_n],
        "flash_decode": [*SC2_DECODE, *(
            label for (kern, label) in rows if kern == "flash_decode"
            and label.startswith(("phi3", "qwen", "paligemma", "whisper",
                                  "gemma3-4b", "zamba2", "dbrx", "kimi")))],
        "flash_attention_fwd": [LM_TRAIN_ATTN, VIT_MB_ATTN,
                                *LM_MB_ATTN.values(), *PREFILL_ATTN,
                                PHI3_TRAIN_ATTN, *VLM_ATTN,
                                *WH_ATTN.values(), *Z2_ATTN.values(),
                                DBRX_PREFILL_ATTN, *KIMI_ATTN],
        "flash_attention_bwd": [LM_TRAIN_ATTN, VIT_MB_ATTN,
                                *LM_MB_ATTN.values(), PHI3_TRAIN_ATTN,
                                *VLM_ATTN,
                                *(WH_ATTN[k] for k in ("enc_train",
                                                       "dec_train",
                                                       "cross_train")),
                                *Z2_ATTN.values(), DBRX_PREFILL_ATTN,
                                *KIMI_ATTN]}
    kernels = []
    for name in (SERVING_KERNELS + TRAINING_KERNELS + SYNC_KERNELS
                 + BACKWARD_KERNELS):
        t = timed[name]
        extra = {key: t[key] for key in (
            "bound_fp32_ms", "bound_fp32_by", "gate_ms", "dw_ms", "dx_ms",
            "forward_ms", "forward_pair_ms", "rows_2x") if key in t}
        bf16 = [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "bitwise") if k in r}
                for r in bf16_rows if r["kernel"] == name]
        if bf16:
            extra["bf16"] = bf16
        if name in lm_shapes:
            extra["lm_path"] = [
                {key: rows[name, label][key] for key in (
                    "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by", "bound_fp32_ms", "max_abs_err", "path",
                    "bitwise_strided_path")
                 if key in rows[name, label]}
                for label in lm_shapes[name]]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=counts[name],
            max_abs_err=t["max_abs_err"], ms=t["ms"], kernel_ms=t["ms"],
            plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=t["shape"], **extra))
    emit("run", seconds=time.perf_counter() - t_run,
         host_available_low_gb=host_low["gb"],
         host_available_low_after=host_low["after"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-rank":
        sys.exit(mesh_rank_main(sys.argv[2]))
    sys.exit(main())
