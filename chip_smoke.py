#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     the port's precision knob at its default (``RELPOSE_MATMUL_PRECISION``
     = ``highest``: TF32 off for matmuls and cuDNN convs), checked;
  2. build the hand-written CUDA kernels from ``rel_pose_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version on the card, fp32 and
     bf16 (ViT stack -- the tensor-core kernels for bf16, SIMT for fp32 --
     at G=16 and at G=3 sequences, whose 1,728 rows leave a ragged GEMM
     tile, and at G=3 of width 64, off the 192-column tiles; essential
     block at B=8 pairs); the sha256 of the fp32 outputs is printed
     (``scripts/vit_stack_bits.py`` compares two trees' bits);
  3b. the training kernels the same way: the ViT stack's stash against the
     plain block inputs, the ViT stack backward (dx and the 12 weight
     gradients, the same three shapes) and the essential block backward
     (dq, dk, dv, dpos, B=8) against their plain backward versions, and
     each backward twice for identical bits;
  4. the slice: ``PosePredictor`` over the flagship ``ViTEss`` (depth 6,
     seeded random weights) answers InteriorNet-style 256x256 requests of
     1, 5 and 8 pairs and a Matterport-style 480x640 request resized to
     384x512, in fp32 and bf16, at batch_size 8.  Poses must be finite,
     (B, 2, 7), pose 0 the identity, unit quaternions (or the 0.01-floor
     case), agree with the plain path on the card, and every kernel's launch
     counter must have risen during this phase;
  4b. the training slice: the flagship ViTEss (depth 6, seeded weights)
     takes 3 ``train_step``s (geodesic loss, backward, clip 2.5, Adam,
     OneCycle) on Matterport-style 384x512 uint8 batches of 4 pairs with
     random unit-quaternion poses, in fp32 and bf16, with the kernels and on
     the plain path (``kernels=False``, autograd through the plain
     versions).  Losses finite; the step-1 loss and every parameter's
     step-1 gradient (cosine, norm ratio) agree with the plain path;
     BatchNorm running statistics moved and counted 3 batches; all four
     kernels' launch counters rose; a checkpoint saved after step 2 and
     resumed into a fresh model reproduces step 3 bit for bit;
  5. times (CUDA events, after warm-up): each forward kernel and its plain
     version at the eval shapes of batch 256 in bf16 (the ViT stack checked
     at that size against the plain version first; its GEMM and attention
     parts from ``torch.profiler``; #2's parts too -- key statistics, vb_n,
     moments, F-partial sum, qkv GEMM, LayerNorm -- each with the TFLOP/s
     of its executed products and its exp2 count over 3.9 T/s), and the eval
     forward in pairs/s at batch 256, 256x256 uint8, bf16, preprocessing
     included;
  5b. each backward kernel and its plain version at the training shapes of
     batch 60 in bf16 (the ViT stack's and #6's also by part: #6's
     statistics, prologue, rho / gamma passes and its two gradient passes);
     as the yardstick of #1 and #5, timed only, the same 5-block
     stack from library calls (``F.layer_norm``, cuBLAS ``F.linear``,
     ``F.scaled_dot_product_attention``, ``F.gelu``), forward (eval shapes)
     and backward of a kept forward (training shapes), and one SDPA call
     each way; and the training step in pairs/s at batch 60, 384x512 uint8
     (bench.py's train protocol), fp32 and bf16, kernels and plain path.

The --noess ablation (``ModelConfig(noess=True)``: Pallas kernel #7, the
cross block's plain attention, in place of the essential block):

  3c. kernel #7 (``csrc/mhsa.cu``: bf16 on the tensor cores of
     ``csrc/attention_tc.cuh``, fp32 on the SIMT ``attention.cuh``) against
     its plain versions at G = 24 heads of N = 64, 100 (a ragged last tile)
     and 576, fp32 and bf16: the forward against ``mhsa_reference``, dq,
     dk, dv against ``mhsa_bwd_reference``; a second call gives the same
     bits; in bf16 the row statistics the forward keeps against
     ``mhsa_stats_reference``, the backward under autograd (the forward's
     statistics) equal bit for bit to ``fused_mhsa_bwd`` without them (its
     stats pass), and the forward equal with and without statistics; the
     fp32 outputs' sha256 printed; both launch counters rose;
  4c. the noess slice at depth 6 with seeded weights, kernels against the
     plain path, fp32 and bf16: ``PosePredictor`` answers the requests of
     phase 4; 3 train steps of 4 pairs as phase 4b (step-1 loss and
     per-leaf gradients against the plain path, losses finite); the
     ``pool_attn`` BatchNorm state moves; the ViT stack's and #7's counters
     rose in each run;
  5c. #7's forward at the eval shapes (G = 1,536) and forward and backward
     at the training shapes (G = 360), bf16: kernel (with the TFLOP/s of
     the function's products, 4 N^2 d a head forward and 10 backward; the
     backward also with the forward's statistics, as a train step runs
     it), plain version and ``F.scaled_dot_product_attention`` (the
     yardstick, timed only); the noess eval forward at batch 256 (bf16) and
     train step at batch 60 (fp32, bf16), kernels and plain path.

The ablations of the Essential Matrix Module (``ModelConfig`` with
``use_single_softmax``, ``cross_features``, ``no_pos_encoding`` or
``l1_pos_encoding``: variants of kernels #2 and #6, and #3, #4):

  3d. #2, #4 (``fused_essential_block``) and #6 for every combination of
     {positions, none} x {dual, single softmax} x {va = v_self, cross
     features} against their plain versions at B = 8 pairs of N = 576, and
     #4 and #6 again at B = 4 of a ragged N = 100, fp32 and bf16 (bf16: the
     tensor-core kernels of ``csrc/essential_tc.cuh`` and
     ``essential_tc_bwd.cuh``); #2 and each backward twice for the same
     bits; the fp32 outputs' sha256 printed (``scripts/vit_stack_bits.py``
     prints them for another tree); #3 (``fused_essential_block_x``) for
     the flagship flags and one ablated combination; the four counters
     rose;
  4d. #3 and #4 through their public ops (``essential_cross_attention``,
     ``fused_essential_block``) under autograd, forward and backward
     against the plain versions, their counters set to 0 just before and
     read just after; then for each flag the depth-6 model with seeded
     weights: phase 4's serving and phase 4b's three training steps, fp32
     and bf16, kernels against the plain path, #1, #2, #5 and #6 launched;
  5d. bf16 times of the #2 variants (batch 256) and the #6 variants
     (batch 60) for the single softmax, no positions and cross features,
     of #3 and #4 (batch 256), with plain times and bounds; each
     ablation's eval forward (batch 256) and bf16 train step (batch 60),
     kernels and plain path.

The last two Pallas kernels: #8, the per-head bilinear op of
``rel_pose_tpu/ops/pallas_essential.py`` (``ops/bilinear.py``,
``csrc/bilinear.cu``, ``csrc/bilinear_bwd.cu``), whose public route is
``essential_block_head_stacked``, and #9, the microbenchmark variants of
``scripts/bench_cross.py`` (``ops/cross_variants.py``,
``csrc/cross_variants.cu``), driven by ``scripts/bench_cross_torch.py``:

  3e. #8's forward and backward against their plain versions at G = 24
     slices of N = 576 and of a ragged N = 100, e in {70, 64}, dual and
     single softmax, va is vb and va != vb, fp32 (SIMT) and bf16 (the
     tensor-core body of ``csrc/essential_tc.cuh`` /
     ``essential_tc_bwd.cuh``), forward and backward each twice for the
     same bits; then ``essential_block_head_stacked`` under autograd
     against #4 + #6 at B = 8 for the 8 flag combinations, fp32 and bf16
     (F, dqkv1, dqkv2, dpos), #8's counters set to 0 just before that route
     and read just after;
  3f. ``essential_block_s`` (S = 2, 4) against #4 at B = 8, fp32 and bf16:
     bf16 must give #4's bits (fp32's equal bits reported);
     ``essential_block_variant`` (mxu_sums, bf16_mul) against its plain
     version at B = 8, bf16; every bf16 case twice for the same bits; both
     counters rose;
  5e. bf16 times: #8's forward at G = 1,536 (e = 70) and backward at G =
     360 against their plain versions, and by part (statistics, vb_n
     packing, moments, F-partial sum; statistics, prologue, each pass) with
     TFLOP/s and exp2 floors; the head-stacked forward + backward against
     #4 + #6 and its plain version at batch 60; the microbenchmark script's
     cases at batch 256 (#9's counters set to 0 just before and read just
     after), with the plain times of s2, mxu_sums and bf16_mul; each with
     its bound.

The no-fusion baseline (``ModelConfig(fusion_transformer=False)``, the
training CLI's default; no hand kernel on its path) and the training CLI:

  4e. the no-fusion model at full width with seeded weights:
     ``PosePredictor`` on the card answers phase 4's requests, fp32 and
     bf16, against the same weights run by the port on the CPU in fp32; 3
     train steps of 4 pairs per dtype, losses finite, the step-1 loss and
     per-leaf gradients against the CPU's step in the same dtype on the
     same batch; its eval forward at batch 256 (bf16) and its train step
     at batch 60 (fp32, bf16) in pairs/s;
  6. ``python -m rel_pose_tpu_torch.cli.train`` as a user runs it, on
     Matterport-layout trees of 480x640 JPEGs written under
     ``output/chip_smoke_cli/``: the native host library
     (``rel_pose_tpu_torch/native``) built and loaded; in-process, the
     flagship at depth 6, bf16, batch 6, 4 steps, a checkpoint every 2,
     with #1, #2, #5 and #6's counters set to 0 just before and read just
     after (each must have launched), finite losses and the checkpoints;
     the module in a child process to step 5, which must resume; the
     no-fusion default in fp32 for 2 steps; the flagship bf16 at batch 60
     for 15 steps: the CLI's steady-state pairs/s and the share of its
     loop's time spent waiting on the data loader, beside phase 5b's
     synthetic step; then the host pipeline by part (one thread's decode
     and whole-sample milliseconds a pair, the loader alone in pairs/s).

The eval, demo, epipolar and convert CLIs and the predictor's warm-up:

  7. on trees written under ``output/chip_smoke_eval/`` (64 Matterport
     pairs cycling through 8 480x640 JPEG pairs, 32 InteriorNet 256x256
     PNG pairs) with the flagship's seeded weights at depth 6, saved as a
     ``.pth`` and converted by ``cli.convert_checkpoint`` to a ``.ckpt``:
     (a) ``cli.test_matterport`` fp32 and bf16 from each file, the same
     bytes from both, its per-pair errors against the plain path's
     through the CLI's ``eval_camera`` within phase 4's pose tolerance
     carried through the metric (``rotation_err_tol``, ``tran_err_tol``),
     #1's and #2's counters set to 0 just before each run and read just
     after; (b) ``cli.test_streetlearn_interiornet`` bf16, the same; (c)
     ``cli.demo`` on a ``matterport`` name and another, its printed numbers
     those of ``PosePredictor``; (d) ``cli.generate_epipolar_imgs`` on the
     card and on the CPU: the lines within 1e-5 relative, the PNGs
     compared bit for bit (reported); (e) ``PosePredictor.warmup()`` and
     the first requests of 1 and 8 pairs in a fresh child process, against
     one without the warm-up; (f) the Matterport CLI's pairs/s and
     decode-wait share at batch 64 over 640 pairs, beside the forward
     alone; (g) ``cli.train --ckpt model.ckpt``, bf16, 2 steps: weights
     only restored, finite losses, #1, #2, #5 and #6 launched.

Data parallelism (``rel_pose_tpu_torch.parallel``; this host has one card
and NCCL takes one GPU a rank, so what runs here is two ranks sharing the
card over gloo, and a world of one over NCCL -- never two cards):

  8a. two ranks over gloo on the one card, child processes of this script
     (``--ddp-child``): 3 DDP ``train_step``s of the depth-6 flagship with
     the kernels, fp32 and bf16, 4 Matterport-style 384x512 pairs a rank,
     against this process's ``train_step`` on all 8 pairs from the same
     seeded weights: the step-1 global loss, every parameter's step-1
     gradient (cosine and norm ratio), the BatchNorm running statistics,
     the parameters after step 3; both ranks' parameters and buffers
     bit-identical after every step; each rank's #1, #2, #5 and #6
     launched; the two-rank step's ms beside the one-process step's (the
     ranks share one card and all-reduce through host memory: not a
     figure of DDP's speed);
  8b. ``cli.train`` as a world of one over NCCL (torchrun's RANK=0,
     WORLD_SIZE=1 set by hand) on phase 6's tree, flagship bf16, 2 steps
     at batch 6: its step-2 checkpoint equal bit for bit to the same run's
     with ``--no_ddp``; #1, #2, #5 and #6 launched;
  8c. ``cli.test_matterport`` as 2 ranks on the card (gloo), fp32, batch
     16, on phase 7's 64 pairs: the rows in rank-major order, pair for pair
     within phase 7's fp32 bounds of its single-process rows, the metrics
     within 1e-4 degrees and 1e-4 m.

The tooling (``rel_pose_tpu_torch/utils/profiling.py``, ``gradcheck.py``,
``train/checkpoint.AsyncCheckpointer``, ``rel_pose_tpu_torch/tools/``),
under ``output/chip_smoke_tooling/``; 9e's two runs and 9d's float64
reference are child processes that run beside 9a-9d:

  9a. the FLOPs a pair of the eval forward and the train step
     (``estimate_step_flops``); MFU against 989 TFLOP/s of phase 5's eval
     forward (batch 256, bf16) and phase 5b's bf16 train step (batch 60);
     phase 6's batch-60 CLI record carries an ``mfu`` equal to its pairs/s
     x FLOPs a pair / 989e12 within 1e-6 relative; every MFU in (0, 1);
  9b. ``utils.profiling.trace`` around 2 eval forwards: the Chrome trace
     parses and holds device events of #1 and #2 under their kernel names;
  9c. the flagship bf16 after 2 steps of 4 pairs: ``save_checkpoint``, then
     ``AsyncCheckpointer.save`` and 2 more steps at once, then ``close()``:
     both files equal tensor by tensor; the training thread's ms in
     ``save()`` beside the synchronous save's;
  9d. ``tools.check_grads`` in fp32 and bf16 at batch 4: the kernels' and
     the plain path's gradients of every parameter triangulated against
     one float64 reference (JAX's gates), the top 5 leaves printed;
  9e. ``tools.convergence_run`` in fp32 and bf16 (``CONV_STEPS``) through
     ``cli.train``: tests/test_convergence.py's gates on each trajectory.

The line before the last is the card's name and power limit; the last is
``{"ok": true, "device": {...}}``; the one before the card's line is the
``{"kernels": [...]}`` line of all twelve kernels, whose ``launches`` of
#1, #2, #5 and #6 are phase 4b's; phase 9's in this process (9b-9d) are
logged on their own (``[tooling]``).  Checkpoints and the CLIs' trees go
to ``output/`` beside this file and are removed.  The run needs no
network and starts no process besides
``nvidia-smi``, ``nvcc``, ``make`` (the native host library), the training
CLI's child process, phase 7e's two (this script with ``--serve-child``),
phase 8a's two ranks (``--ddp-child``), 8c's two and phase 9's three (two
``tools.convergence_run``, each with its ``cli.train`` child, and
``tools.check_grads --reference-child``), each of which it waits for.
"""

import itertools
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

SEED = 0
EVAL_BATCH = 256        # bench.py's eval protocol
TRAIN_BATCH = 60        # bench.py's train protocol: 384x512 uint8 pairs
SLICE_TRAIN_BATCH = 4   # the training slice's check batches
OUTPUT_DIR = pathlib.Path(__file__).resolve().parent / "output"
# One H100 SXM (NVIDIA data sheet): dense bf16 tensor-core and
# fp32 non-tensor-core peaks, and the HBM rate, for the kernels' bounds.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
NVSMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]
# (fp32, bf16) tolerances, each against the plain PyTorch version on the
# card.  Tokens: |err| <= atol + rtol * max|ref| -- the kernels sum in
# another order, and in bf16 a sum-order flip moves a rounding by one ulp
# (2^-8 relative: 0.0625 at |x| in [8, 16)), which later blocks carry on; the
# bf16 bound is 2e-2 * max|ref|, about 4 ulps of the largest token (2 ulps
# measured on an H100).  F: |err| <= rtol * max|F|.  Poses: |err| <= atol
# (quaternion entries are at most 1; bf16 flips upstream reach the fp32
# regressor).
TOKEN_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (3e-2, 2e-2)}
F_RTOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
POSE_ATOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
DTYPES = (torch.float32, torch.bfloat16)
# Backward outputs against the plain backward on the card, ||err|| / ||ref||:
# fp32 1e-4 -- the same fp32 arithmetic summed in another order (the weight
# gradients add 9,216 rows in 2,048-row chunks, the plain version in one
# cuBLAS reduction); bf16 3e-2 -- both round every product operand to bf16
# at the same points, but a sum-order difference flips a rounding by one ulp
# (2^-8 relative), and the residual cotangent carries such flips back
# through 5 blocks.
GRAD_NORMREL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# Training slice, kernels against the plain path (autograd through the
# plain versions, which round bf16 elsewhere: it differentiates the rounded
# forward, the kernels follow the Pallas backward).  Step-1 loss relative:
# fp32 1e-4 (one depth-6 model summed in another order), bf16 5e-2 (the
# bf16 forward flips, as POSE_ATOL).  Per-parameter step-1 gradient, as
# rel_pose_tpu/utils/gradcheck.py measures it: cosine >= LEAF_COS and
# |norm ratio - 1| <= LEAF_RATIO, the cosine skipped for leaves below 1e-4
# of the largest gradient norm; fp32 differs by sum order only, bf16 by the
# rounding points above, amplified by training BatchNorm's division by
# batch deviations.
LOSS_RTOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# Kernel #7's forward against mhsa_reference, ||err|| / ||ref||: fp32 1e-5
# (exp2 and the division after the product against exp and a normalized
# softmax; 5e-7 measured on the CPU against the Pallas kernel); bf16 2e-2
# (the plain version rounds the scores to bf16 before the softmax, the
# kernel keeps them fp32, as #7 does; 5e-3 measured on the CPU).  Its
# backward is held to mhsa_bwd_reference at GRAD_NORMREL.
MHSA_FWD_NORMREL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# The row statistics (m, l) that #7's bf16 forward keeps, against
# mhsa_stats_reference, ||err|| / ||ref|| per statistic: 1e-5 -- fp32 sums
# of the same exact bf16 products in another order, and exp2 on both sides
# (3e-7 measured on the CPU between the plain version and JAX).
MHSA_STATS_NORMREL = 1e-5
MHSA_SCALE = 64 ** -0.5
LEAF_COS = {torch.float32: 0.9999, torch.bfloat16: 0.98}
LEAF_RATIO = {torch.float32: 1e-3, torch.bfloat16: 0.1}
# The no-fusion step on the card against the CPU's (phase 4e), the trunk's
# leaves (ResNet and extractor): their convolutions sum in cuDNN's order on
# one side and oneDNN's on the other, and training BatchNorm's cancellation
# amplifies that, as it does between the two packages on the CPU
# (tests/test_torch_nofusion.py: 8.1e-3 relative in fp32 on the trunk, 1.3e-5
# on the head).  Measured on an H100: fp32 |norm ratio - 1| up to 1.3e-3
# (cosine 0.99999), bf16 cosine down to 0.968.  The pool head and the
# regressor keep LEAF_COS / LEAF_RATIO.
TRUNK_LEAF_COS = {torch.float32: 0.9999, torch.bfloat16: 0.9}
TRUNK_LEAF_RATIO = {torch.float32: 1e-2, torch.bfloat16: 0.2}
# The head-stacked route (#8's forward and backward under autograd) against
# #4 + #6 on the same inputs, gradients ||err|| / ||ref||: fp32 1e-4, the
# same fp32 arithmetic summed in another order; bf16 3e-2 as GRAD_NORMREL,
# but for other roundings than #6 against its plain version: #6 sums each
# v's dva and dvb in fp32 and rounds once, dv = T(dvb + dva), and sums the
# positional cotangent of the 2 x heads combos in fp32, where the
# head-stacked route rounds dva and dvb to T on their own and autograd adds
# them, and the heads' positional columns, in T.
HEAD_STACKED_NORMREL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def log(*args):
    print(*args, flush=True)


def cuda_time_ms(fn, iters, warmup=1):
    """Mean milliseconds of ``fn()`` between CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- inputs --

def vit_inputs(rng, G, dtype, device, depth=5, C=192, hidden=768):
    """Tokens, (1, N, C) pos and stacked block params at the model's
    widths, drawn from ``rng``; weights scaled like PyTorch's init."""
    def t(shape, scale):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)
        ).to(device)
    stacked = {
        "ln1_scale": 1 + t((depth, C), 0.1), "ln1_bias": t((depth, C), 0.1),
        "qkv_w": t((depth, 3 * C, C), C ** -0.5),
        "qkv_b": t((depth, 3 * C), 0.1),
        "proj_w": t((depth, C, C), C ** -0.5), "proj_b": t((depth, C), 0.1),
        "ln2_scale": 1 + t((depth, C), 0.1), "ln2_bias": t((depth, C), 0.1),
        "fc1_w": t((depth, hidden, C), C ** -0.5),
        "fc1_b": t((depth, hidden), 0.1),
        "fc2_w": t((depth, C, hidden), hidden ** -0.5),
        "fc2_b": t((depth, C), 0.1)}
    x = t((G, 576, C), 1.0).to(dtype)
    pos = t((1, 576, C), 0.02).to(dtype)
    return x, {k: v.to(dtype) for k, v in stacked.items()}, pos


def essential_inputs(rng, B, dtype, device, C=192, N=576):
    def t(shape, scale):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)
        ).to(device)
    xpair = t((B, 2, N, C), 1.0).to(dtype)
    ln = (1 + t((C,), 0.1), t((C,), 0.1))
    qkv = (t((3 * C, C), C ** -0.5), t((3 * C,), 0.1))
    positional = t((B, N, 6), 1.0)
    return xpair, ln, qkv, positional


# ---------------------------------------------------------------- phases --

def phase_device():
    smi = subprocess.run(NVSMI_QUERY, capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip()
    log(f"[device] nvidia-smi: {card}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    # the port's precision knob at its default: full fp32, no TF32
    from rel_pose_tpu_torch.utils.precision import apply_matmul_precision
    value = apply_matmul_precision()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    log(f"[device] RELPOSE_MATMUL_PRECISION={value}: cudnn.allow_tf32="
        f"{flags[0]} cuda.matmul.allow_tf32={flags[1]}")
    if value != "highest" or any(flags):
        raise SystemExit(f"precision default: {value}, TF32 flags {flags}")
    return card


def phase_build():
    from rel_pose_tpu_torch.ops import _build
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def check_tokens(name, out, ref, dtype, failures):
    atol, rtol = TOKEN_TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    scale = ref.float().abs().max().item()
    tol = atol + rtol * scale
    ok = bool(np.isfinite(err)) and err <= tol
    log(f"[check] {name} {str(dtype)[6:]}: max_abs_err={err:.3e} "
        f"mean_abs_err={diff.mean().item():.3e} max|ref|={scale:.3f} "
        f"tol={tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name} {dtype}")
    return err


def check_f(name, out, ref, dtype, failures):
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    ok = bool(np.isfinite(err)) and err <= F_RTOL[dtype] * scale
    log(f"[check] {name} {str(dtype)[6:]}: max_abs_err={err:.3e} "
        f"max|ref|={scale:.3f} rel={err / scale:.3e} "
        f"rtol={F_RTOL[dtype]:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name} {dtype}")
    return err


def phase_kernels(device):
    from rel_pose_tpu_torch.ops.essential_block import (
        essential_block_pair_reference, fused_essential_block_pair)
    from rel_pose_tpu_torch.ops.vit_stack import (fused_vit_stack,
                                                  vit_stack_reference)
    failures = []
    for dtype in DTYPES:
        rng = np.random.default_rng(SEED)
        # G = 16; G = 3, whose 1,728 rows leave a ragged 128-row GEMM tile;
        # and C = 64, one head, MLP 256: widths off the 192-column tiles,
        # which take the bf16 kernels' 64-column ones
        for G, C, hidden in ((16, 192, 768), (3, 192, 768), (3, 64, 256)):
            x, stacked, pos = vit_inputs(rng, G, dtype, device, C=C,
                                         hidden=hidden)
            out = fused_vit_stack(x, stacked, C // 64, pos)
            torch.cuda.synchronize()
            check_tokens(f"vit_stack G={G} C={C} depth=5", out,
                         vit_stack_reference(x, stacked, C // 64, pos),
                         dtype, failures)
            if dtype == torch.float32:
                log(f"[check] vit_stack fp32 G={G} C={C} sha256 "
                    f"{digest(out)}")
        args = essential_inputs(rng, 8, dtype, device)
        f = fused_essential_block_pair(*args, 3)
        torch.cuda.synchronize()
        check_f("essential_block B=8", f,
                essential_block_pair_reference(*args, 3), dtype, failures)
    if failures:
        raise SystemExit(f"kernel checks failed: {failures}")


def digest(*tensors):
    """sha256 of the tensors' bytes, the first 16 hex digits: two runs of a
    deterministic kernel on one card give the same digest."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def normrel(out, ref):
    """||out - ref|| / ||ref|| in fp64 (the gradient checks' metric)."""
    ref = ref.double()
    return ((out.double() - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def check_grad(name, out, ref, dtype, failures, tol=None):
    """An output against its plain version: ||err|| / ||ref|| <= tol,
    GRAD_NORMREL[dtype] by default (the backward outputs); returns max
    |err|."""
    tol = GRAD_NORMREL[dtype] if tol is None else tol
    rel = normrel(out, ref)
    err = (out.float() - ref.float()).abs().max().item()
    ok = bool(np.isfinite(rel)) and rel <= tol
    log(f"[check] {name} {str(dtype)[6:]}: normrel={rel:.3e} "
        f"max_abs_err={err:.3e} max|ref|={ref.float().abs().max().item():.3e}"
        f" tol={tol:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name} {dtype}")
    return err


def check_vit_bwd(G, dtype, rng, device, failures, C=192, hidden=768):
    """#1's stash and #5 at G sequences of width C against the plain
    versions; the backward twice for the same bits; fp32's digest printed.
    Returns the largest max |err|."""
    from rel_pose_tpu_torch.ops import vit_stack as tv
    heads, name = C // 64, f"G={G} C={C}"
    x, stacked, pos = vit_inputs(rng, G, dtype, device, C=C, hidden=hidden)
    out, xs = tv._launch_forward(x, stacked, heads, pos, stash=True)
    plain_xs = []
    ref = tv.vit_stack_reference(x, stacked, heads, pos, stash=plain_xs)
    nostash = tv.fused_vit_stack(x, stacked, heads, pos)
    torch.cuda.synchronize()
    if not torch.equal(out, nostash):
        failures.append(f"stash changed the output {dtype} {name}")
    check_tokens(f"vit_stack(stash) out {name}", out, ref, dtype, failures)
    for i, want in enumerate(plain_xs):
        check_tokens(f"vit_stack stash[{i}] {name}", xs[i], want, dtype,
                     failures)
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(
        np.float32)).to(device, dtype)
    dx, grads = tv.fused_vit_stack_bwd(xs, g, stacked, heads)
    dx2, grads2 = tv.fused_vit_stack_bwd(xs, g, stacked, heads)
    torch.cuda.synchronize()
    same = torch.equal(dx, dx2) and all(
        torch.equal(grads[k], grads2[k]) for k in grads)
    log(f"[check] vit_stack_bwd {name} {str(dtype)[6:]}: two calls "
        f"{'bit for bit' if same else 'DIFFER'}")
    if not same:
        failures.append(f"vit_stack_bwd not bitwise repeatable {dtype} "
                        f"{name}")
    if dtype == torch.float32:
        log(f"[check] vit_stack_bwd fp32 {name} sha256 "
            f"{digest(dx, *grads.values())}")
    rdx, rgrads = tv.vit_stack_bwd_reference(xs, g, stacked, heads)
    e = [check_grad(f"vit_stack_bwd dx {name}", dx, rdx, dtype, failures)]
    for k in grads:
        e.append(check_grad(f"vit_stack_bwd d{k} {name}", grads[k],
                            rgrads[k], dtype, failures))
    return max(e)


def phase_kernels_bwd(device):
    """(3b) the stash and both backward kernels against their plain
    versions on the card, fp32 and bf16, and bitwise repeatability."""
    from rel_pose_tpu_torch.ops import essential_block as te
    from rel_pose_tpu_torch.ops import vit_stack as tv
    from rel_pose_tpu_torch.nn.layers import layernorm
    failures = []
    errs = {}
    for dtype in DTYPES:
        rng = np.random.default_rng(SEED + 3)
        # G = 16 and G = 3 (ragged row tiles and dW chunks) at the model's
        # widths, and C = 64 (the bf16 kernels' 64-column tiles)
        e = [check_vit_bwd(G, dtype, rng, device, failures, C, hidden)
             for G, C, hidden in ((16, 192, 768), (3, 192, 768),
                                  (3, 64, 256))]
        errs["vit_stack_bwd", dtype] = e[0]

        xpair, ln, qkvp, positional = essential_inputs(rng, 8, dtype, device)
        qkv = te.linear_rounded(layernorm(xpair, *ln), *qkvp)
        df = torch.from_numpy((0.1 * rng.standard_normal(
            (8, 2, 3, 70, 70))).astype(np.float32)).to(device)
        dq, dp = te.fused_essential_block_bwd(qkv, positional, df, 3)
        dq2, dp2 = te.fused_essential_block_bwd(qkv, positional, df, 3)
        torch.cuda.synchronize()
        if not (torch.equal(dq, dq2) and torch.equal(dp, dp2)):
            failures.append(
                f"essential_block_bwd not bitwise repeatable {dtype}")
        rq, rp = te.essential_block_bwd_reference(qkv, positional, df, 3)
        C = 192
        e = [check_grad(f"essential_block_bwd {part} B=8",
                        dq[..., sl], rq[..., sl], dtype, failures)
             for part, sl in (("dq", slice(0, C)), ("dk", slice(C, 2 * C)),
                              ("dv", slice(2 * C, 3 * C)))]
        e.append(check_grad("essential_block_bwd dpos B=8", dp, rp, dtype,
                            failures))
        errs["essential_block_bwd", dtype] = max(e)
    if failures:
        raise SystemExit(f"backward kernel checks failed: {failures}")
    return errs


def heads(rng, G, dtype, device, n, N=576):
    """``n`` (G, N, 64) tensors of unit normal entries, the scale of the
    cross block's q, k, v (a Linear of LayerNormed tokens)."""
    return [torch.from_numpy(rng.standard_normal((G, N, 64)).astype(
        np.float32)).to(device, dtype) for _ in range(n)]


def check_mhsa(G, dtype, device, failures, seed=SEED + 6, N=576):
    """Kernel #7 forward and backward at G heads of N against the plain
    versions -> (max |err| forward, max |err| backward)."""
    from rel_pose_tpu_torch.ops import attention as ta
    q, k, v, do = heads(np.random.default_rng(seed), G, dtype, device, 4, N)
    o = ta.fused_mhsa(q, k, v, MHSA_SCALE)
    grads = ta.fused_mhsa_bwd(q, k, v, do, MHSA_SCALE)
    torch.cuda.synchronize()
    e_fwd = check_grad(f"mhsa_fwd G={G} N={N}", o,
                       ta.mhsa_reference(q, k, v, MHSA_SCALE), dtype,
                       failures, MHSA_FWD_NORMREL[dtype])
    ref = ta.mhsa_bwd_reference(q, k, v, do, MHSA_SCALE)
    e_bwd = max(check_grad(f"mhsa_bwd {name} G={G} N={N}", g, r, dtype,
                           failures)
                for name, g, r in zip(("dq", "dk", "dv"), grads, ref))
    return e_fwd, e_bwd


def check_mhsa_routes(q, k, v, do, failures, label):
    """bf16: the forward's kept (m, l) against mhsa_stats_reference; the
    forward with and without them, and the backward from them (autograd)
    and from the stats pass, bit for bit."""
    from rel_pose_tpu_torch.ops import attention as ta
    o, stats = ta._launch_fwd(q, k, v, MHSA_SCALE, stats=True)
    ref = ta.mhsa_stats_reference(q, k, MHSA_SCALE)
    for i, name in enumerate(("m", "l")):
        check_grad(f"mhsa_fwd stats {name} {label}", stats[..., i],
                   ref[..., i], q.dtype, failures, MHSA_STATS_NORMREL)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o_grad = ta.fused_mhsa(*leaves, MHSA_SCALE)
    saved = torch.autograd.grad(o_grad, leaves, do)
    passed = ta.fused_mhsa_bwd(q, k, v, do, MHSA_SCALE)
    torch.cuda.synchronize()
    same_fwd = torch.equal(o, ta.fused_mhsa(q, k, v, MHSA_SCALE)) and \
        torch.equal(o, o_grad.detach())
    same_bwd = all(torch.equal(a, b) for a, b in zip(saved, passed))
    log(f"[check] mhsa {label} bf16: forward with / without stats "
        f"{'bit for bit' if same_fwd else 'DIFFER'}; backward from the "
        f"forward's stats / the stats pass "
        f"{'bit for bit' if same_bwd else 'DIFFER'}")
    if not (same_fwd and same_bwd):
        failures.append(f"mhsa routes differ {label}")


def phase_kernels_mhsa(device):
    """(3c) kernel #7 against its plain versions, fp32 and bf16, G = 24
    heads of N = 64, 100, 576; each kernel twice for identical bits; bf16's
    statistics and both backward routes; both counters rose."""
    from rel_pose_tpu_torch.ops import attention as ta
    failures = []
    ta.fused_mhsa.launches = ta.fused_mhsa_bwd.launches = 0
    for dtype in DTYPES:
        for N in (64, 100, 576):
            check_mhsa(24, dtype, device, failures, N=N)
            q, k, v, do = heads(np.random.default_rng(SEED + 7), 24, dtype,
                                device, 4, N)
            outs = [(ta.fused_mhsa(q, k, v, MHSA_SCALE),
                     *ta.fused_mhsa_bwd(q, k, v, do, MHSA_SCALE))
                    for _ in range(2)]
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(*outs)):
                failures.append(f"mhsa not bitwise repeatable {dtype} N={N}")
            if dtype == torch.float32:
                log(f"[check] mhsa fp32 G=24 N={N} sha256 "
                    f"{digest(*outs[0])}")
            else:
                check_mhsa_routes(q, k, v, do, failures, f"G=24 N={N}")
    launches = (ta.fused_mhsa.launches, ta.fused_mhsa_bwd.launches)
    log(f"[check] mhsa launches (fwd, bwd): {launches}")
    if min(launches) < 6 * len(DTYPES):
        failures.append(f"mhsa launch counters {launches}")
    if failures:
        raise SystemExit(f"mhsa kernel checks failed: {failures}")


def make_models(device, **flags):
    """The eval models (dtype, kernels) of ``ModelConfig(**flags)`` and
    their seeded state dict."""
    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.models.vitess import ViTEss
    from rel_pose_tpu_torch.nn.init import seeded_state_dict
    models = {}
    sd = None
    for dtype in DTYPES:
        cfg = ModelConfig(compute_dtype=str(dtype)[6:], **flags)  # depth 6
        for kernels in (True, False):
            m = ViTEss(cfg, device=device, kernels=kernels)
            if sd is None:
                sd = seeded_state_dict(m, SEED)
            m.load_state_dict(sd)
            models[dtype, kernels] = m
    return models, sd


def requests(rng):
    """(name, images, intrinsics, image_size) request mix."""
    from rel_pose_tpu_torch.infer import (INTERIORNET_STREETLEARN_INTRINSICS,
                                          MATTERPORT_INTRINSICS)
    out = [(f"interiornet n={n}",
            rng.integers(0, 256, (n, 2, 3, 256, 256), dtype=np.uint8),
            INTERIORNET_STREETLEARN_INTRINSICS, None) for n in (1, 5, 8)]
    out.append(("matterport n=3",
                rng.integers(0, 256, (3, 2, 3, 480, 640), dtype=np.uint8),
                MATTERPORT_INTRINSICS, (384, 512)))
    return out


def check_poses(name, dtype, poses, plain, n, failures, label="slice"):
    problems = []
    if poses.shape != (n, 2, 7):
        problems.append(f"shape {poses.shape}")
    if not np.isfinite(poses).all():
        problems.append("non-finite")
    ident = np.array([0, 0, 0, 0, 0, 0, 1], np.float32)
    if not (poses[:, 0] == ident).all():
        problems.append("pose 0 is not the identity")
    qn = np.linalg.norm(poses[:, 1, 3:], axis=-1)
    qn_plain = np.linalg.norm(plain[:, 1, 3:], axis=-1)
    unit = np.abs(qn - 1) < 1e-3
    floor = (qn < 1) & (qn_plain < 0.99)    # |q_raw| < 0.01: q / 0.01
    if not (unit | floor).all():
        problems.append(f"quaternion norms {qn}")
    err = float(np.abs(poses - plain).max())
    if not err <= POSE_ATOL[dtype]:
        problems.append(f"vs plain {err:.3e} > {POSE_ATOL[dtype]:.0e}")
    log(f"[{label}] {name} {str(dtype)[6:]}: shape {poses.shape} "
        f"|q| in [{qn.min():.6f}, {qn.max():.6f}] "
        f"max_abs_err_vs_plain={err:.3e} "
        f"{'ok' if not problems else 'FAIL ' + '; '.join(problems)}")
    if problems:
        failures.append(f"{name} {dtype}")


def phase_slice(device, models, label="slice"):
    from rel_pose_tpu_torch.infer import PosePredictor
    from rel_pose_tpu_torch.ops.essential_block import \
        fused_essential_block_pair
    from rel_pose_tpu_torch.ops.vit_stack import fused_vit_stack
    reqs = requests(np.random.default_rng(SEED + 1))

    def serve(kernels):
        out = {}
        for dtype in DTYPES:
            for name, images, intr, size in reqs:
                pred = PosePredictor(models[dtype, kernels], intrinsics=intr,
                                     batch_size=8, image_size=size)
                out[name, dtype] = pred.predict_batch(images)
        return out

    fused_vit_stack.launches = 0
    fused_essential_block_pair.launches = 0
    got = serve(kernels=True)
    torch.cuda.synchronize()
    launches = {"vit_stack": fused_vit_stack.launches,
                "essential_block_pair": fused_essential_block_pair.launches}
    log(f"[{label}] kernel launches during the slice: {launches}")
    plain = serve(kernels=False)
    failures = [f"{k} never launched" for k, v in launches.items()
                if v <= 0]
    for (name, dtype), poses in got.items():
        n = next(len(r[1]) for r in reqs if r[0] == name)
        check_poses(name, dtype, poses, plain[name, dtype], n, failures,
                    label)
    if failures:
        raise SystemExit(f"{label} checks failed: {failures}")
    return launches


def bound(flops, nbytes, dtype):
    """(ms, "operations" or "bytes"): the least time one H100 needs for
    ``flops`` at its peak for ``dtype`` and ``nbytes`` at its HBM rate."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def vit_flops(G, N, C, hidden, depth):
    """Products of the stack's forward: 4 Linears (2 M C (3C + C + 2
    hidden)) and the two attention products (2 * 2 N^2 C per sequence)."""
    M = G * N
    return depth * (2 * M * C * (4 * C + 2 * hidden) + 4 * G * N * N * C)


def moments_fwd_flops(B, N, heads, d=64, e=70):
    """Per (pair, direction, head) the scores (2 N^2 d), P . vb (2 N^2 e)
    and va^T av (2 N e^2): #4's products."""
    return 2 * B * heads * (2 * N * N * d + 2 * N * N * e + 2 * N * e * e)


def essential_fwd_flops(B, N, C, heads, d=64, e=70):
    """The qkv Linear of 2B images, then the moments (#2, #3)."""
    return 2 * 2 * B * N * 3 * C * C + moments_fwd_flops(B, N, heads, d, e)


def essential_bwd_flops(B, N, heads, d=64, e=70):
    """Per combo: the scores (2 N^2 d), dva, dvb, dA (3 x 2 N^2 e), dq, dk
    (2 x 2 N^2 d) and vb dF^T, va dF (2 x 2 N e^2)."""
    return 2 * B * heads * (3 * 2 * N * N * d + 3 * 2 * N * N * e
                            + 2 * 2 * N * e * e)


def sdpa_ms(G, dtype, device, backward):
    """One ``F.scaled_dot_product_attention`` call at (G, 3, 576, 64):
    the forward, or the backward of a kept forward -- the yardstick of the
    kernels' attention parts, never called by the port."""
    import torch.nn.functional as F
    gen = torch.Generator(device=device).manual_seed(SEED)
    q, k, v = (torch.randn((G, 3, 576, 64), generator=gen, device=device,
                           dtype=dtype, requires_grad=backward)
               for _ in range(3))
    if not backward:
        with torch.no_grad():
            return cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v), 3)
    out = F.scaled_dot_product_attention(q, k, v)
    g = torch.randn_like(out)
    return cuda_time_ms(lambda: torch.autograd.grad(
        out, (q, k, v), g, retain_graph=True), 3)


def library_vit_stack(x, stacked, heads, pos):
    """The stack's function from library calls -- ``F.layer_norm``,
    cuBLAS ``F.linear``, ``F.scaled_dot_product_attention``, ``F.gelu`` --
    in the activation dtype: the yardstick of #1 and #5, timed only and
    never called by the port."""
    import torch.nn.functional as F
    G, N, C = x.shape
    x = x + pos
    for i in range(stacked["qkv_w"].shape[0]):
        p = {k: v[i] for k, v in stacked.items()}
        y = F.layer_norm(x, (C,), p["ln1_scale"], p["ln1_bias"], 1e-6)
        q, k, v = F.linear(y, p["qkv_w"], p["qkv_b"]).view(
            G, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, v)
        x = x + F.linear(a.transpose(1, 2).reshape(G, N, C), p["proj_w"],
                         p["proj_b"])
        y = F.layer_norm(x, (C,), p["ln2_scale"], p["ln2_bias"], 1e-6)
        h = F.gelu(F.linear(y, p["fc1_w"], p["fc1_b"]), approximate="tanh")
        x = x + F.linear(h, p["fc2_w"], p["fc2_b"])
    return x


def library_stack_ms(x, stacked, pos, backward):
    """(ms, max |err| against the plain version) of
    :func:`library_vit_stack`: its forward, or the backward (dx and every
    stacked gradient) of a kept forward."""
    from rel_pose_tpu_torch.ops.vit_stack import vit_stack_reference
    if not backward:
        with torch.no_grad():
            out = library_vit_stack(x, stacked, 3, pos)
            err = (out.float() - vit_stack_reference(
                x, stacked, 3, pos).float()).abs().max().item()
            return cuda_time_ms(
                lambda: library_vit_stack(x, stacked, 3, pos), 3), err
    leaves = [x.detach().requires_grad_()] + [
        v.detach().requires_grad_() for v in stacked.values()]
    out = library_vit_stack(leaves[0], dict(zip(stacked, leaves[1:])), 3,
                            pos)
    g = torch.randn_like(out)
    ms = cuda_time_ms(lambda: torch.autograd.grad(out, leaves, g,
                                                  retain_graph=True), 3)
    return ms, None


def kernel_parts_ms(fn):
    """Device time of one ``fn()`` by part: the tensor-core attention
    kernels (``rp::tc::attn_*``), the tensor-core GEMMs (``rp::tc::gemm_*``)
    and the rest."""
    return profile_parts_ms(fn, lambda key: (
        "attention" if "tc::attn_" in key else
        "gemm" if "tc::gemm_" in key else "other"))


# The special-function units' exp2 rate of one H100 SXM, ~3.9 T/s (the
# FlashAttention-3 paper): the essential block's floor beside its
# tensor-core bound, since every score takes one to three exp2.
EXP2_PER_S = 3.9e12


def essential_part(key):
    """The part of the essential block's tensor-core path a profiled kernel
    belongs to, from its (demangled) name."""
    m = re.search(r"eb_bwd_pass_kernel<[\w:]+, \d+, (true|false), "
                  r"(true|false)", key)
    if m:
        return {("false", "false"): "gamma pass", ("true", "false"):
                "rho pass", ("true", "true"): "dq/dva pass",
                ("false", "true"): "dk/dvb pass"}[m.groups()]
    for sub, part in (("eb_stats_kernel<true", "key statistics"),
                      ("eb_stats_kernel<false", "query statistics"),
                      ("eb_vbn_kernel", "vb_n"),
                      ("eb_moments_kernel", "moments"),
                      ("sum_partials", "F-partial sum"),
                      ("gemm_fwd_kernel", "qkv GEMM"),
                      ("layernorm", "LayerNorm"),
                      ("eb_bwd_prologue", "prologue")):
        if sub in key:
            return part
    return "other"


def profile_parts_ms(fn, part_of, once=False):
    """Device time of one ``fn()`` by part (``part_of(kernel name)``) over 3
    calls, from ``torch.profiler``; empty when it recorded no device time.
    Late in a long run (phase 5e, on an H100) the profiler lost the
    records of the first kernels of a window, a call's worth or more, even
    50 ms into it.  With ``once`` -- for an ``fn`` that launches each kernel
    once -- a kernel counts its mean time per recorded launch, which a lost
    record does not bias; else its total over the 3 calls, divided by 3."""
    from torch.profiler import ProfilerActivity, profile
    reps = 3
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    parts = {}
    for ev in prof.key_averages():
        t = ev.self_device_time_total
        if ev.device_type != torch.autograd.DeviceType.CUDA or t <= 0:
            continue
        part = part_of(ev.key)
        ms = t / 1e3 / (ev.count if once else reps)
        parts[part] = parts.get(part, 0.0) + ms
    return parts


def essential_executed(B, N, e, single, backward, C=192, heads=3):
    """{part: (executed products' FLOPs, exp2 count)} of the bf16
    tensor-core path at B pairs (padded widths: 72 columns for an e-wide
    product with e = 70, 80 as the k depth over e)."""
    G = 2 * B * heads
    wn, wk = 8 * -(-e // 8), 16 * -(-e // 16)
    score, n2 = 2 * N * N * 64 * G, N * N * G
    if not backward:
        out = {"moments": (2 * score + 2 * N * N * wn * G
                           + 2 * N * wk * wn * G, n2 * (1 if single else 2)),
               "qkv GEMM": (2 * 2 * B * N * 3 * C * C, 0)}
        if not single:
            out["key statistics"] = (score, n2)
        return out
    pa = score + 2 * N * N * wk * G                 # s and dA of one pass
    grad = pa + score + 2 * N * N * wn * G          # + out1, out2
    x = 1 if single else 2
    out = {"query statistics": (score, n2),
           "prologue": (2 * 2 * N * wk * wn * G, 0),
           "rho pass": (pa, x * n2), "dq/dva pass": (grad, x * n2),
           "dk/dvb pass": (grad, x * n2)}
    if not single:
        out["key statistics"] = (score, n2)
        out["gamma pass"] = (pa, 2 * n2)
    return out


def log_essential_parts(name, parts, executed, card):
    """Each part's time; the TFLOP/s of its executed products and its exp2
    count over EXP2_PER_S, where it has them."""
    if not parts:
        log(f"[time] {name} parts: not measured (no device time in the "
            f"profile)")
        return
    n_exp = sum(x for _, x in executed.values())
    for part, ms in sorted(parts.items(), key=lambda kv: -kv[1]):
        flops, exps = executed.get(part, (0, 0))
        rate = (f", {flops / ms / 1e9:.2f} TFLOP/s of its executed products"
                if flops and ms > 0 else "")
        floor = (f", exp2 floor {exps / EXP2_PER_S * 1e3:.3f} ms"
                 if exps else "")
        log(f"[time] {name} {part} part: {ms:.3f} ms{rate}{floor} ({card})")
    log(f"[time] {name} exp2 count {n_exp / 1e9:.3f} G, floor "
        f"{n_exp / EXP2_PER_S * 1e3:.3f} ms at {EXP2_PER_S / 1e12:.1f} T/s "
        f"({card})")


def vit_attention_flops(G, N, C, depth, passes):
    """Products of the stack's attention: ``passes`` N x N x C products per
    sequence and block (2 in the forward's function)."""
    return depth * passes * 2 * G * N * N * C


def log_parts(name, parts, gemm_flops, attn_flops, card):
    if not parts:
        log(f"[time] {name} parts: not measured (no device time in the "
            f"profile)")
        return
    for part, flops in (("gemm", gemm_flops), ("attention", attn_flops)):
        ms = parts.get(part, 0.0)
        rate = f"{flops / ms / 1e9:.2f} TFLOP/s" if ms > 0 else "n/a"
        log(f"[time] {name} {part} part: {ms:.3f} ms, {rate} of the "
            f"function's products ({card})")
    log(f"[time] {name} other kernels: {parts.get('other', 0.0):.3f} ms "
        f"({card})")


def phase_times(device, models, card):
    from rel_pose_tpu_torch.ops.essential_block import (
        essential_block_pair_reference, fused_essential_block_pair)
    from rel_pose_tpu_torch.ops.vit_stack import (fused_vit_stack,
                                                  vit_stack_reference)
    B = EVAL_BATCH
    dtype = torch.bfloat16
    rng = np.random.default_rng(SEED + 2)
    rows = {}
    failures = []

    x, stacked, pos = vit_inputs(rng, 2 * B, dtype, device)
    out = fused_vit_stack(x, stacked, 3, pos)
    ref = vit_stack_reference(x, stacked, 3, pos)
    err = check_tokens(f"vit_stack G={2 * B} depth=5", out, ref, dtype,
                       failures)
    del out, ref
    ms = cuda_time_ms(lambda: fused_vit_stack(x, stacked, 3, pos), 3)
    plain_ms = cuda_time_ms(lambda: vit_stack_reference(x, stacked, 3, pos),
                            3)
    lib_ms, lib_err = library_stack_ms(x, stacked, pos, backward=False)
    sdpa = sdpa_ms(2 * B, dtype, device, backward=False)
    G = 2 * B
    b = bound(vit_flops(G, 576, 192, 768, 5),
              2 * nbytes(x) + nbytes(pos, *stacked.values()), dtype)
    rows["vit_stack"] = (err, ms, plain_ms, lib_ms, b)
    log(f"[time] vit_stack bf16 G={G}: kernel {ms:.3f} ms, library "
        f"stack {lib_ms:.3f} ms (max |err| "
        f"{lib_err:.3e} against the plain version), one SDPA call "
        f"{sdpa:.3f} ms ({card})")
    attn = vit_attention_flops(G, 576, 192, 5, 2)
    log_parts(f"vit_stack G={G}", kernel_parts_ms(
        lambda: fused_vit_stack(x, stacked, 3, pos)),
        vit_flops(G, 576, 192, 768, 5) - attn, attn, card)
    del x, stacked, pos

    args = essential_inputs(rng, B, dtype, device)
    f = fused_essential_block_pair(*args, 3)
    err = check_f(f"essential_block B={B}", f,
                  essential_block_pair_reference(*args, 3), dtype, failures)
    ms = cuda_time_ms(lambda: fused_essential_block_pair(*args, 3), 3)
    plain_ms = cuda_time_ms(
        lambda: essential_block_pair_reference(*args, 3), 3)
    xpair, ln, qkvp, positional = args
    small = sum(t.numel() for t in (*ln, *qkvp, positional))
    b = bound(essential_fwd_flops(B, 576, 192, 3),
              nbytes(xpair, f) + 2 * small, dtype)   # weights, pos as bf16
    rows["essential_block_pair"] = (err, ms, plain_ms, None, b)
    log_essential_parts(f"essential_block_pair B={B}", profile_parts_ms(
        lambda: fused_essential_block_pair(*args, 3), essential_part,
        once=True),
        essential_executed(B, 576, 70, False, False), card)
    del args, f, xpair, positional
    if failures:
        raise SystemExit(f"batch-256 kernel checks failed: {failures}")
    for name, (err, ms, plain_ms, lib_ms, b) in rows.items():
        log(f"[time] {name} bf16 batch {B}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, library {lib_ms} ms, bound {b[0]:.3f} ms "
            f"({b[1]}) ({card})")

    images = torch.from_numpy(rng.integers(
        0, 256, (B, 2, 3, 256, 256), dtype=np.uint8)).to(device)
    intr = torch.full((B, 2, 4), 128.0, device=device)
    eval_ms = {}
    for kernels in (True, False):
        model = models[dtype, kernels]
        with torch.inference_mode():
            ms = cuda_time_ms(lambda: model(images, intr), 3)
        eval_ms[kernels] = ms
        log(f"[time] eval forward bf16 batch {B} 256x256 uint8 "
            f"({'kernels' if kernels else 'plain path'}): {ms:.3f} ms, "
            f"{B / ms * 1e3:.2f} pairs/s ({card})")
    return rows, eval_ms[True]


# ------------------------------------------------------- training slice --

def random_poses(rng, B):
    """(B, 2, 7): pose 0 the identity, pose 1 a random unit quaternion
    (W last, rotations below ~60 degrees) and a translation of ~0.5."""
    poses = np.zeros((B, 2, 7), np.float32)
    poses[..., 6] = 1.0
    q = rng.standard_normal((B, 4))
    q[:, 3] = np.abs(q[:, 3]) + 2.0
    poses[:, 1, 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    poses[:, 1, :3] = 0.3 * rng.standard_normal((B, 3))
    return poses


def train_batch(rng, B, device):
    """Matterport-style (images 384x512 uint8, poses, intrinsics) on the
    card."""
    from rel_pose_tpu_torch.infer import MATTERPORT_INTRINSICS
    images = rng.integers(0, 256, (B, 2, 3, 384, 512), dtype=np.uint8)
    intr = np.tile(MATTERPORT_INTRINSICS, (B, 2, 1))
    return tuple(torch.from_numpy(a).to(device)
                 for a in (images, random_poses(rng, B), intr))


def train_model(dtype, sd, device, kernels, **flags):
    """A depth-6 ``ModelConfig(**flags)`` model loaded from ``sd``, with its
    Adam and OneCycle."""
    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.models.vitess import ViTEss
    from rel_pose_tpu_torch.train.optim import make_optimizer
    model = ViTEss(ModelConfig(compute_dtype=str(dtype)[6:], **flags),
                   device=device, kernels=kernels)
    model.load_state_dict(sd)
    opt, sched = make_optimizer(model, lr=5e-4, steps=1000, warmup=100)
    return model, opt, sched


def kernel_counters():
    from rel_pose_tpu_torch.ops import essential_block as te
    from rel_pose_tpu_torch.ops import vit_stack as tv
    return {"vit_stack": tv.fused_vit_stack,
            "vit_stack_bwd": tv.fused_vit_stack_bwd,
            "essential_block_pair": te.fused_essential_block_pair,
            "essential_block_bwd": te.fused_essential_block_bwd}


def compare_leaves(dtype, grads, plain, failures, label="train",
                   leaf_cos=LEAF_COS, leaf_ratio=LEAF_RATIO):
    """Per-parameter cosine and norm ratio of the kernel path's step-1
    gradient against the plain path's (``leaf_cos``, ``leaf_ratio``: the
    bounds by dtype)."""
    scale = max(g.norm().item() for g in plain.values())
    worst_cos, worst_ratio, bad = 1.0, 0.0, []
    for name, g in grads.items():
        ref = plain[name].double()
        gn, rn = g.double().norm().item(), ref.norm().item()
        ratio = abs(gn / rn - 1) if rn > 0 else abs(gn)
        cos = ((g.double() * ref).sum().item() / (gn * rn)
               if gn * rn > 0 else 1.0)
        if rn >= 1e-4 * scale:
            worst_cos = min(worst_cos, cos)
            worst_ratio = max(worst_ratio, ratio)
            if cos < leaf_cos[dtype] or ratio > leaf_ratio[dtype]:
                bad.append(f"{name} cos {cos:.6f} ratio {gn / rn:.4f}")
    log(f"[{label}] {str(dtype)[6:]} step-1 gradients, {len(grads)} "
        f"leaves: min cosine {worst_cos:.6f} (>= {leaf_cos[dtype]}), max "
        f"|norm ratio - 1| {worst_ratio:.3e} (<= {leaf_ratio[dtype]}) "
        f"{'ok' if not bad else 'FAIL ' + '; '.join(bad[:5])}")
    if bad:
        failures.append(f"step-1 gradients {dtype}")


def phase_train(device, sd, label="train", **flags):
    """(4b) three train steps per dtype of ``ModelConfig(**flags)``,
    kernels and plain path; see the module docstring.  Deterministic
    algorithms on (cuDNN and the rest), so that a resumed step can be
    compared bit for bit."""
    from rel_pose_tpu_torch.train import checkpoint
    from rel_pose_tpu_torch.train.step import train_step
    counters = kernel_counters()
    ckpt_dir = OUTPUT_DIR / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    failures = []
    for c in counters.values():
        c.launches = 0
    for dtype in DTYPES:
        rng = np.random.default_rng(SEED + 4)
        batches = [train_batch(rng, SLICE_TRAIN_BATCH, device)
                   for _ in range(3)]
        runs = {}
        for kernels in (True, False):
            model, opt, sched = train_model(dtype, sd, device, kernels,
                                            **flags)
            bn0 = {k: v.clone() for k, v in model.state_dict().items()
                   if "running" in k}
            losses, grads1 = [], None
            name = f"run_{str(dtype)[6:]}"
            for step, batch in enumerate(batches):
                if kernels and step == 2:
                    checkpoint.save_checkpoint(
                        checkpoint.checkpoint_path(name, 2, str(ckpt_dir)),
                        model, opt, sched)
                metrics, poses = train_step(model, opt, sched, *batch)
                losses.append(metrics["loss"].item())
                if step == 0:
                    grads1 = {n: p.grad.detach().clone()
                              for n, p in model.named_parameters()}
            runs[kernels] = (losses, grads1)
            log(f"[{label}] {str(dtype)[6:]} "
                f"{'kernels' if kernels else 'plain path'}: losses "
                f"{[round(v, 6) for v in losses]}")
            sdict = model.state_dict()
            moved = all(not torch.equal(sdict[k], v) for k, v in bn0.items()
                        if k.endswith("running_mean"))
            counts = {int(v) for k, v in sdict.items()
                      if k.endswith("num_batches_tracked")}
            if not (moved and counts == {3}):
                failures.append(f"BatchNorm state {dtype} {kernels}: moved "
                                f"{moved}, counts {counts}")
            if not all(np.isfinite(losses)) or poses.shape != (
                    SLICE_TRAIN_BATCH, 2, 7):
                failures.append(f"losses / poses {dtype} {kernels}")
            if kernels:
                fresh, opt2, sched2 = train_model(dtype, sd, device, True,
                                                  **flags)
                start = checkpoint.resume(name, fresh, opt2, sched2,
                                          str(ckpt_dir))
                m3, _ = train_step(fresh, opt2, sched2, *batches[2])
                same = start == 2 and m3["loss"].item() == losses[2] and all(
                    torch.equal(a, b) for a, b in zip(
                        fresh.state_dict().values(), sdict.values()))
                log(f"[{label}] {str(dtype)[6:]} resume from step {start}: "
                    f"step 3 {'bit for bit' if same else 'DIFFERS'}")
                if not same:
                    failures.append(f"resume {dtype}")
                del fresh, opt2, sched2
            del model, opt, sched
        (lk, gk), (lp, gp) = runs[True], runs[False]
        rel = abs(lk[0] - lp[0]) / abs(lp[0])
        ok = rel <= LOSS_RTOL[dtype]
        log(f"[{label}] {str(dtype)[6:]} step-1 loss kernels {lk[0]:.6f} "
            f"plain {lp[0]:.6f} rel {rel:.3e} (<= {LOSS_RTOL[dtype]}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"step-1 loss {dtype}")
        compare_leaves(dtype, gk, gp, failures, label)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    log(f"[{label}] kernel launches during the training slice: {launches}")
    failures += [f"{k} never launched" for k, v in launches.items()
                 if v <= 0]
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if failures:
        raise SystemExit(f"{label} checks failed: {failures}")
    return launches


def phase_times_train(device, sd, card):
    """(5b) the backward kernels at the training shapes of batch 60 (bf16)
    and the training step in pairs/s."""
    from rel_pose_tpu_torch.nn.layers import layernorm
    from rel_pose_tpu_torch.ops import essential_block as te
    from rel_pose_tpu_torch.ops import vit_stack as tv
    from rel_pose_tpu_torch.train.step import train_step
    B, G = TRAIN_BATCH, 2 * TRAIN_BATCH
    dtype = torch.bfloat16
    rng = np.random.default_rng(SEED + 5)
    rows, failures = {}, []

    x, stacked, pos = vit_inputs(rng, G, dtype, device)
    _, xs = tv._launch_forward(x, stacked, 3, pos, stash=True)
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(
        np.float32)).to(device, dtype)
    dx, grads = tv.fused_vit_stack_bwd(xs, g, stacked, 3)
    rdx, rgrads = tv.vit_stack_bwd_reference(xs, g, stacked, 3)
    err = max([check_grad(f"vit_stack_bwd dx G={G}", dx, rdx, dtype,
                          failures)]
              + [check_grad(f"vit_stack_bwd d{k} G={G}", grads[k],
                            rgrads[k], dtype, failures) for k in grads])
    del dx, grads, rdx, rgrads
    ms = cuda_time_ms(lambda: tv.fused_vit_stack_bwd(xs, g, stacked, 3), 3)
    plain_ms = cuda_time_ms(
        lambda: tv.vit_stack_bwd_reference(xs, g, stacked, 3), 2)
    lib_ms, _ = library_stack_ms(x, stacked, pos, backward=True)
    sdpa = sdpa_ms(G, dtype, device, backward=True)
    n_params = sum(v.numel() for v in stacked.values())
    b = bound(2 * vit_flops(G, 576, 192, 768, 5),
              nbytes(xs) + 2 * nbytes(g) + nbytes(*stacked.values())
              + 4 * n_params, dtype)
    rows["vit_stack_bwd"] = (err, ms, plain_ms, lib_ms, b)
    log(f"[time] vit_stack_bwd bf16 G={G}: kernel {ms:.3f} ms, library "
        f"stack backward {lib_ms:.3f} ms, "
        f"one SDPA backward {sdpa:.3f} ms ({card})")
    # the backward's products: each Linear's recompute, dX and dW (3 x the
    # forward's), and 6 N x N x C attention products: the recompute's 2 and
    # the backward's 4 (dv, dp, dq, dk)
    fwd = vit_flops(G, 576, 192, 768, 5)
    attn_fwd = vit_attention_flops(G, 576, 192, 5, 2)
    gemm = 3 * (fwd - attn_fwd)
    log_parts(f"vit_stack_bwd G={G}", kernel_parts_ms(
        lambda: tv.fused_vit_stack_bwd(xs, g, stacked, 3)), gemm,
        vit_attention_flops(G, 576, 192, 5, 6), card)
    del x, stacked, pos, xs, g

    xpair, ln, qkvp, positional = essential_inputs(rng, B, dtype, device)
    qkv = te.linear_rounded(layernorm(xpair, *ln), *qkvp)
    pos = positional.to(dtype)
    df = torch.from_numpy((0.1 * rng.standard_normal(
        (B, 2, 3, 70, 70))).astype(np.float32)).to(device)
    dq, dp = te.fused_essential_block_bwd(qkv, pos, df, 3)
    rq, rp = te.essential_block_bwd_reference(qkv, pos, df, 3)
    err = max(check_grad(f"essential_block_bwd dqkv B={B}", dq, rq, dtype,
                         failures),
              check_grad(f"essential_block_bwd dpos B={B}", dp, rp, dtype,
                         failures))
    del rq, rp
    ms = cuda_time_ms(lambda: te.fused_essential_block_bwd(qkv, pos, df, 3),
                      3)
    plain_ms = cuda_time_ms(
        lambda: te.essential_block_bwd_reference(qkv, pos, df, 3), 2)
    b = bound(essential_bwd_flops(B, 576, 3),
              2 * nbytes(qkv) + nbytes(pos, df, dp), dtype)
    rows["essential_block_bwd"] = (err, ms, plain_ms, None, b)
    log_essential_parts(f"essential_block_bwd B={B}", profile_parts_ms(
        lambda: te.fused_essential_block_bwd(qkv, pos, df, 3),
        essential_part, once=True),
        essential_executed(B, 576, 70, False, True), card)
    del xpair, qkv, pos, df, dq, dp
    if failures:
        raise SystemExit(f"batch-60 backward checks failed: {failures}")
    for name, (err, ms, plain_ms, lib_ms, b) in rows.items():
        log(f"[time] {name} bf16 batch {B}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, library {lib_ms} ms, bound {b[0]:.3f} ms "
            f"({b[1]}) ({card})")

    batch = train_batch(rng, B, device)
    step_ms = {}
    for dtype in DTYPES:
        for kernels in (True, False):
            model, opt, sched = train_model(dtype, sd, device, kernels)
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_time_ms(lambda: train_step(model, opt, sched, *batch),
                              3)
            step_ms[dtype, kernels] = ms
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"[time] train step {str(dtype)[6:]} batch {B} 384x512 uint8 "
                f"({'kernels' if kernels else 'plain path'}): {ms:.3f} ms, "
                f"{B / ms * 1e3:.2f} pairs/s, peak {peak:.2f} GiB ({card})")
            del model, opt, sched
    return rows, step_ms[torch.bfloat16, True]


# ------------------------------------------------------------ --noess --

def noess_counters():
    from rel_pose_tpu_torch.ops import attention as ta
    from rel_pose_tpu_torch.ops import vit_stack as tv
    return {"vit_stack": tv.fused_vit_stack,
            "vit_stack_bwd": tv.fused_vit_stack_bwd,
            "mhsa_fwd": ta.fused_mhsa, "mhsa_bwd": ta.fused_mhsa_bwd}


def phase_noess(device, models, sd):
    """(4c) the noess slice: ``PosePredictor`` over the depth-6 noess
    ViTEss answers phase 4's requests, then 3 train steps per dtype, each
    with the kernels and on the plain path; returns the launch counts of
    (serving, training)."""
    from rel_pose_tpu_torch.infer import PosePredictor
    from rel_pose_tpu_torch.train.step import train_step
    counters = noess_counters()
    reqs = requests(np.random.default_rng(SEED + 1))
    failures = []

    def serve(kernels):
        return {(name, dtype): PosePredictor(
                    models[dtype, kernels], intrinsics=intr, batch_size=8,
                    image_size=size).predict_batch(images)
                for dtype in DTYPES for name, images, intr, size in reqs}

    for c in counters.values():
        c.launches = 0
    got = serve(kernels=True)
    torch.cuda.synchronize()
    eval_launches = {k: counters[k].launches for k in ("vit_stack",
                                                       "mhsa_fwd")}
    log(f"[noess] kernel launches while serving: {eval_launches}")
    failures += [f"{k} never launched while serving"
                 for k, v in eval_launches.items() if v <= 0]
    plain = serve(kernels=False)
    for (name, dtype), poses in got.items():
        n = next(len(r[1]) for r in reqs if r[0] == name)
        check_poses(f"noess {name}", dtype, poses, plain[name, dtype], n,
                    failures)

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    for c in counters.values():
        c.launches = 0
    for dtype in DTYPES:
        rng = np.random.default_rng(SEED + 4)
        batches = [train_batch(rng, SLICE_TRAIN_BATCH, device)
                   for _ in range(3)]
        runs = {}
        for kernels in (True, False):
            model, opt, sched = train_model(dtype, sd, device, kernels,
                                            noess=True)
            bn0 = {k: v.clone() for k, v in model.state_dict().items()
                   if k.startswith("pool_attn.") and "running" in k}
            losses, grads1 = [], None
            for step, batch in enumerate(batches):
                metrics, poses = train_step(model, opt, sched, *batch)
                losses.append(metrics["loss"].item())
                if step == 0:
                    grads1 = {n: p.grad.detach().clone()
                              for n, p in model.named_parameters()}
            runs[kernels] = (losses, grads1)
            log(f"[noess] train {str(dtype)[6:]} "
                f"{'kernels' if kernels else 'plain path'}: losses "
                f"{[round(v, 6) for v in losses]}")
            sdict = model.state_dict()
            moved = all(not torch.equal(sdict[k], v) for k, v in bn0.items())
            counts = {int(sdict[f"pool_attn.{i}.num_batches_tracked"])
                      for i in (1, 4)}
            if not (moved and len(bn0) == 4 and counts == {3}):
                failures.append(f"pool_attn BatchNorm state {dtype} "
                                f"{kernels}: moved {moved}, counts {counts}")
            if not all(np.isfinite(losses)) or poses.shape != (
                    SLICE_TRAIN_BATCH, 2, 7):
                failures.append(f"noess losses / poses {dtype} {kernels}")
            del model, opt, sched
        (lk, gk), (lp, gp) = runs[True], runs[False]
        rel = abs(lk[0] - lp[0]) / abs(lp[0])
        ok = rel <= LOSS_RTOL[dtype]
        log(f"[noess] train {str(dtype)[6:]} step-1 loss kernels {lk[0]:.6f}"
            f" plain {lp[0]:.6f} rel {rel:.3e} (<= {LOSS_RTOL[dtype]}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"noess step-1 loss {dtype}")
        compare_leaves(dtype, gk, gp, failures)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    log(f"[noess] kernel launches during training: {launches}")
    failures += [f"{k} never launched in training"
                 for k, v in launches.items() if v <= 0]
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    if failures:
        raise SystemExit(f"noess slice checks failed: {failures}")
    return eval_launches, launches


def phase_times_noess(device, models, sd, card):
    """(5c) kernel #7 at the eval and training shapes, bf16, and the noess
    eval forward and train step."""
    from rel_pose_tpu_torch.ops import attention as ta
    from rel_pose_tpu_torch.train.step import train_step
    dtype = torch.bfloat16
    rng = np.random.default_rng(SEED + 8)
    failures, rows = [], {}
    G_eval, G_train = 2 * EVAL_BATCH * 3, 2 * TRAIN_BATCH * 3
    err_fwd, _ = check_mhsa(G_eval, dtype, device, failures, SEED + 8)
    _, err_bwd = check_mhsa(G_train, dtype, device, failures, SEED + 9)
    if failures:
        raise SystemExit(f"mhsa checks at the model's shapes failed: "
                         f"{failures}")
    N, d = 576, 64
    q, k, v = heads(rng, G_eval, dtype, device, 3)
    ms = cuda_time_ms(lambda: ta.fused_mhsa(q, k, v, MHSA_SCALE), 5)
    plain_ms = cuda_time_ms(lambda: ta.mhsa_reference(q, k, v, MHSA_SCALE),
                            3)
    lib_ms = sdpa_ms(G_eval // 3, dtype, device, backward=False)
    b = bound(4 * G_eval * N * N * d, 4 * nbytes(q), dtype)
    rows["mhsa_fwd"] = (err_fwd, ms, plain_ms, lib_ms, b)
    del q, k, v
    q, k, v, do = heads(rng, G_train, dtype, device, 4)
    ms = cuda_time_ms(lambda: ta.fused_mhsa_bwd(q, k, v, do, MHSA_SCALE), 5)
    plain_ms = cuda_time_ms(
        lambda: ta.mhsa_bwd_reference(q, k, v, do, MHSA_SCALE), 3)
    lib_ms = sdpa_ms(G_train // 3, dtype, device, backward=True)
    b = bound(10 * G_train * N * N * d, 7 * nbytes(q), dtype)
    rows["mhsa_bwd"] = (err_bwd, ms, plain_ms, lib_ms, b)
    fwd_train_ms = cuda_time_ms(lambda: ta.fused_mhsa(q, k, v, MHSA_SCALE), 5)
    _, stats = ta._launch_fwd(q, k, v, MHSA_SCALE, stats=True)
    saved_ms = cuda_time_ms(
        lambda: ta.fused_mhsa_bwd(q, k, v, do, MHSA_SCALE, stats), 5)
    del q, k, v, do, stats
    log(f"[time] mhsa_fwd bf16 G={G_train} (training shapes): kernel "
        f"{fwd_train_ms:.3f} ms; mhsa_bwd from the forward's stats "
        f"{saved_ms:.3f} ms, {10 * G_train * N * N * d / saved_ms / 1e9:.1f}"
        f" TFLOP/s ({card})")
    for name, G, per_head in (("mhsa_fwd", G_eval, 4),
                              ("mhsa_bwd", G_train, 10)):
        err, ms, plain_ms, lib_ms, (b_ms, b_by) = rows[name]
        log(f"[time] {name} bf16 G={G}: kernel {ms:.3f} ms "
            f"({per_head * G * N * N * d / ms / 1e9:.1f} TFLOP/s of the "
            f"function's products), plain {plain_ms:.3f} ms, library "
            f"{lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}) ({card})")

    B = EVAL_BATCH
    images = torch.from_numpy(rng.integers(
        0, 256, (B, 2, 3, 256, 256), dtype=np.uint8)).to(device)
    intr = torch.full((B, 2, 4), 128.0, device=device)
    for kernels in (True, False):
        model = models[dtype, kernels]
        with torch.inference_mode():
            ms = cuda_time_ms(lambda: model(images, intr), 3)
        log(f"[time] noess eval forward bf16 batch {B} 256x256 uint8 "
            f"({'kernels' if kernels else 'plain path'}): {ms:.3f} ms, "
            f"{B / ms * 1e3:.2f} pairs/s ({card})")
    del images
    batch = train_batch(rng, TRAIN_BATCH, device)
    for dt in DTYPES:
        for kernels in (True, False):
            model, opt, sched = train_model(dt, sd, device, kernels,
                                            noess=True)
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_time_ms(lambda: train_step(model, opt, sched, *batch),
                              3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"[time] noess train step {str(dt)[6:]} batch {TRAIN_BATCH} "
                f"384x512 uint8 ({'kernels' if kernels else 'plain path'}): "
                f"{ms:.3f} ms, {TRAIN_BATCH / ms * 1e3:.2f} pairs/s, peak "
                f"{peak:.2f} GiB ({card})")
            del model, opt, sched
    return rows

# ------------------------------------ the Essential Matrix Module's ablations --

ABLATIONS = ("use_single_softmax", "cross_features", "no_pos_encoding",
             "l1_pos_encoding")
# (has_pos, cross_features, use_single_softmax): the variants of #2 and #6
VARIANTS = [(p, x, s) for p in (True, False) for x in (False, True)
            for s in (False, True)]


def variant_name(has_pos, cross, single):
    return (f"{'pos' if has_pos else 'nopos'}-{'cross' if cross else 'self'}"
            f"-{'single' if single else 'dual'}")


def variant_kw(cross, single):
    return {"cross_features": cross, "use_single_softmax": single}


def essential_counters():
    from rel_pose_tpu_torch.ops import essential_block as te
    return {"essential_block_pair": te.fused_essential_block_pair,
            "essential_block_x": te.fused_essential_block_x,
            "essential_block": te.fused_essential_block,
            "essential_block_bwd": te.fused_essential_block_bwd}


def check_moments_bwd(name, te, qkv, pos, df, kw, dtype, failures):
    """#6 twice (the same bits) and against its plain version: dq, dk, dv
    and, with a positional table, dpos -> (max |err|, (dqkv, dpos))."""
    (dq, dp), (dq2, dp2) = (te.fused_essential_block_bwd(qkv, pos, df, 3,
                                                         **kw)
                            for _ in range(2))
    torch.cuda.synchronize()
    if not (torch.equal(dq, dq2) and (dp is None or torch.equal(dp, dp2))):
        failures.append(f"{name} not bitwise repeatable {dtype}")
    rq, rp = te.essential_block_bwd_reference(qkv, pos, df, 3, **kw)
    C = qkv.shape[-1] // 3
    errs = [check_grad(f"{name} {part}", dq[..., sl], rq[..., sl], dtype,
                       failures)
            for part, sl in (("dq", slice(0, C)), ("dk", slice(C, 2 * C)),
                             ("dv", slice(2 * C, 3 * C)))]
    if pos is not None:
        errs.append(check_grad(f"{name} dpos", dp, rp, dtype, failures))
    elif dp is not None:
        failures.append(f"{name}: a positional cotangent without positions")
    return max(errs), (dq, dp)


def split_pair(xpair, ln, qkvp):
    """(x1, x2): the pre-normed tokens of #3; (q1, q2): the rounded qkv of
    #4; the pair's qkv (B, 2, N, 3C) of #6."""
    from rel_pose_tpu_torch.nn.layers import layernorm
    from rel_pose_tpu_torch.ops.essential_block import linear_rounded
    y = layernorm(xpair, *ln)
    qkv = linear_rounded(y, *qkvp)
    return ((y[:, 0].contiguous(), y[:, 1].contiguous()),
            (qkv[:, 0].contiguous(), qkv[:, 1].contiguous()), qkv)


def phase_kernels_variants(device):
    """(3d) #2 and #6 for every combination of {pos, no pos} x {dual,
    single} x {va = v_self, cross}, and #4 for each too, against their
    plain versions at B = 8 pairs of N = 576 tokens, and #4 and #6 again at
    a ragged N = 100 (a 36-row last tile), fp32 and bf16; #2 and each
    backward twice for the same bits, the fp32 outputs' sha256 printed
    (``scripts/vit_stack_bits.py`` prints them for another tree); #3 for
    the flagship flags and one ablated combination; the four counters
    rose."""
    from rel_pose_tpu_torch.ops import essential_block as te
    counters = essential_counters()
    for c in counters.values():
        c.launches = 0
    failures = []
    for dtype in DTYPES:
        rng = np.random.default_rng(SEED + 10)
        xpair, ln, qkvp, positional = essential_inputs(rng, 8, dtype, device)
        (x1, x2), (q1, q2), qkv = split_pair(xpair, ln, qkvp)
        for has_pos, cross, single in VARIANTS:
            name, kw = variant_name(has_pos, cross, single), variant_kw(
                cross, single)
            pos = positional if has_pos else None
            f, f2 = (te.fused_essential_block_pair(xpair, ln, qkvp, pos, 3,
                                                   **kw) for _ in range(2))
            g = te.fused_essential_block(q1, q2, pos, 3, **kw)
            torch.cuda.synchronize()
            if not torch.equal(f, f2):
                failures.append(f"essential_block_pair {name} not bitwise "
                                f"repeatable {dtype}")
            check_f(f"essential_block_pair {name} B=8", f,
                    te.essential_block_pair_reference(xpair, ln, qkvp, pos,
                                                      3, **kw),
                    dtype, failures)
            check_f(f"essential_block {name} B=8", g,
                    te.essential_block_reference(q1, q2, pos, 3, **kw),
                    dtype, failures)
            e = 64 + 6 * has_pos
            df = torch.from_numpy((0.1 * rng.standard_normal(
                (8, 2, 3, e, e))).astype(np.float32)).to(device)
            dq, dp = check_moments_bwd(
                f"essential_block_bwd {name} B=8", te, qkv,
                None if pos is None else pos.to(dtype), df, kw, dtype,
                failures)[1]
            if dtype == torch.float32:
                grads = [dq] if dp is None else [dq, dp]
                log(f"[check] essential fp32 {name} sha256 pair "
                    f"{digest(f)} bwd {digest(*grads)}")
        for has_pos, cross, single in ((True, False, False),
                                       (False, True, True)):
            name, kw = variant_name(has_pos, cross, single), variant_kw(
                cross, single)
            pos = positional if has_pos else None
            f = te.fused_essential_block_x(x1, x2, qkvp, pos, 3, **kw)
            torch.cuda.synchronize()
            check_f(f"essential_block_x {name} B=8", f,
                    te.essential_block_x_reference(x1, x2, qkvp, pos, 3,
                                                   **kw), dtype, failures)
        # a ragged N: rows past N load as zeros, keys past N are masked
        xpair, ln, qkvp, positional = essential_inputs(rng, 4, dtype, device,
                                                       N=100)
        _, (q1, q2), qkv = split_pair(xpair, ln, qkvp)
        for has_pos, cross, single in VARIANTS:
            name, kw = variant_name(has_pos, cross, single), variant_kw(
                cross, single)
            pos = positional if has_pos else None
            g = te.fused_essential_block(q1, q2, pos, 3, **kw)
            torch.cuda.synchronize()
            check_f(f"essential_block {name} B=4 N=100", g,
                    te.essential_block_reference(q1, q2, pos, 3, **kw),
                    dtype, failures)
            e = 64 + 6 * has_pos
            df = torch.from_numpy((0.1 * rng.standard_normal(
                (4, 2, 3, e, e))).astype(np.float32)).to(device)
            check_moments_bwd(f"essential_block_bwd {name} B=4 N=100", te,
                              qkv, None if pos is None else pos.to(dtype),
                              df, kw, dtype, failures)
    launches = {k: c.launches for k, c in counters.items()}
    log(f"[check] essential variants' launches: {launches}")
    failures += [f"{k} never launched" for k, v in launches.items()
                 if v <= 0]
    if failures:
        raise SystemExit(f"essential variant checks failed: {failures}")


def phase_entry_points(device):
    """(4d) #3 and #4 through their public ops, as a caller runs them:
    ``ops.essential.essential_cross_attention`` (#3, then the projection)
    and ``fused_essential_block`` (#4) at B = 8, forward and backward under
    autograd (the backward is #6), fp32 and bf16, with the counters set to
    0 just before and read just after.  Outputs against the plain versions;
    fp32 gradients against autograd through the plain versions (bf16:
    finite).  Returns the launch counts."""
    from rel_pose_tpu_torch.ops import essential_block as te
    from rel_pose_tpu_torch.ops.essential import essential_cross_attention
    counters = essential_counters()
    failures, runs = [], []
    for dtype in DTYPES:
        rng = np.random.default_rng(SEED + 11)
        xpair, ln, qkvp, positional = essential_inputs(rng, 8, dtype, device)
        (x1, x2), (q1, q2), _ = split_pair(xpair, ln, qkvp)
        proj = (torch.from_numpy((rng.standard_normal((192, 210)) * 0.05)
                                 .astype(np.float32)).to(device),
                torch.zeros(192, device=device))

        def x_call(a, b, w, block, bias=qkvp[1], pos=positional, proj=proj):
            return torch.stack(essential_cross_attention(
                a, b, (w, bias), proj, pos, 3, block=block), 1)

        def block_call(a, b, p, block):
            return block(a, b, p, 3)

        runs.append((dtype, "essential_cross_attention (#3)", x_call,
                     (x1, x2, qkvp[0]), te.fused_essential_block_x,
                     te.essential_block_x_reference))
        runs.append((dtype, "fused_essential_block (#4)", block_call,
                     (q1, q2, positional), te.fused_essential_block,
                     te.essential_block_reference))

    def grads(fn, inputs, block):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves, block)
        gen = torch.Generator(device=device).manual_seed(SEED)
        cot = torch.randn(out.shape, generator=gen, device=device)
        (out.float() * cot).sum().backward()
        return out.detach(), [t.grad for t in leaves]

    for c in counters.values():
        c.launches = 0
    outs = [grads(fn, inputs, fused) for _, _, fn, inputs, fused, _ in runs]
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    log(f"[entry] kernel launches through the public ops: {launches}")
    failures += [f"{k} never launched" for k in (
        "essential_block_x", "essential_block", "essential_block_bwd")
        if launches[k] <= 0]
    for (dtype, name, fn, inputs, _, plain), (out, gk) in zip(runs, outs):
        ref, gp = grads(fn, inputs, plain)
        if name.endswith("(#3)"):
            check_tokens(f"{name} out", out, ref, dtype, failures)
        else:
            check_f(f"{name} F", out, ref, dtype, failures)
        for i, (a, b) in enumerate(zip(gk, gp)):
            if dtype == torch.float32:
                check_grad(f"{name} grad {i}", a, b, dtype, failures)
            elif not torch.isfinite(a).all():
                failures.append(f"{name} grad {i} {dtype} not finite")
    if failures:
        raise SystemExit(f"entry-point checks failed: {failures}")
    return launches


def phase_ablations(device):
    """(4d) for each ablation flag, the depth-6 ``ModelConfig(<flag>=True)``
    with seeded weights: phase 4's serving and phase 4b's training checks,
    kernels against the plain path; returns the launches per flag."""
    out = {}
    for flag in ABLATIONS:
        models, sd = make_models(device, **{flag: True})
        serve = phase_slice(device, models, label=f"ablation {flag}")
        del models
        train = phase_train(device, sd, label=f"ablation {flag}",
                            **{flag: True})
        out[flag] = (serve, train)
    return out


def phase_times_variants(device, card):
    """(5d) bf16 CUDA-event times of the #2 and #6 variants (single
    softmax; no positions; cross features) at the eval shapes of batch 256
    (#2) and the training shapes of batch 60 (#6), of #3 and #4 at batch
    256 with the flagship flags, then the eval forward (batch 256) and the
    bf16 train step (batch 60) of each ablation's model, kernels and plain
    path.  Returns the kernels-line rows of #3 and #4."""
    from rel_pose_tpu_torch.ops import essential_block as te
    from rel_pose_tpu_torch.train.step import train_step
    dtype = torch.bfloat16
    rng = np.random.default_rng(SEED + 12)
    failures, rows = [], {}
    timed = (("single", (True, False, True)), ("nopos", (False, False, False)),
             ("cross", (True, True, False)))
    B = EVAL_BATCH
    xpair, ln, qkvp, positional = essential_inputs(rng, B, dtype, device)
    small = sum(t.numel() for t in (*ln, *qkvp))
    for tag, (has_pos, cross, single) in timed:
        kw = variant_kw(cross, single)
        pos = positional if has_pos else None
        e = 64 + 6 * has_pos
        f = te.fused_essential_block_pair(xpair, ln, qkvp, pos, 3, **kw)
        err = check_f(f"essential_block_pair {tag} B={B}", f,
                      te.essential_block_pair_reference(xpair, ln, qkvp,
                                                        pos, 3, **kw),
                      dtype, failures)
        ms = cuda_time_ms(lambda: te.fused_essential_block_pair(
            xpair, ln, qkvp, pos, 3, **kw), 3)
        plain_ms = cuda_time_ms(lambda: te.essential_block_pair_reference(
            xpair, ln, qkvp, pos, 3, **kw), 3)
        b = bound(essential_fwd_flops(B, 576, 192, 3, e=e),
                  nbytes(xpair, f) + 2 * (small + (pos is not None)
                                          * positional.numel()), dtype)
        log(f"[time] essential_block_pair {tag} bf16 batch {B}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.3f} ms "
            f"({b[1]}), max_abs_err {err:.3e} ({card})")
        del f

    (x1, x2), (q1, q2), _ = split_pair(xpair, ln, qkvp)
    pos = positional.to(dtype)
    f = te.fused_essential_block(q1, q2, pos, 3)
    err = check_f(f"essential_block B={B}", f,
                  te.essential_block_reference(q1, q2, pos, 3), dtype,
                  failures)
    ms = cuda_time_ms(lambda: te.fused_essential_block(q1, q2, pos, 3), 3)
    plain_ms = cuda_time_ms(
        lambda: te.essential_block_reference(q1, q2, pos, 3), 3)
    b = bound(moments_fwd_flops(B, 576, 3), nbytes(q1, q2, pos, f), dtype)
    rows["essential_block"] = (err, ms, plain_ms, None, b)
    f = te.fused_essential_block_x(x1, x2, qkvp, pos, 3)
    err = check_f(f"essential_block_x B={B}", f,
                  te.essential_block_x_reference(x1, x2, qkvp, pos, 3),
                  dtype, failures)
    ms = cuda_time_ms(
        lambda: te.fused_essential_block_x(x1, x2, qkvp, pos, 3), 3)
    plain_ms = cuda_time_ms(
        lambda: te.essential_block_x_reference(x1, x2, qkvp, pos, 3), 3)
    b = bound(essential_fwd_flops(B, 576, 192, 3),
              nbytes(x1, x2, pos, f) + 2 * small, dtype)
    rows["essential_block_x"] = (err, ms, plain_ms, None, b)
    del xpair, x1, x2, q1, q2, f, pos, positional

    B = TRAIN_BATCH
    xpair, ln, qkvp, positional = essential_inputs(rng, B, dtype, device)
    _, _, qkv = split_pair(xpair, ln, qkvp)
    del xpair
    for tag, (has_pos, cross, single) in timed:
        kw = variant_kw(cross, single)
        pos = positional.to(dtype) if has_pos else None
        e = 64 + 6 * has_pos
        df = torch.from_numpy((0.1 * rng.standard_normal(
            (B, 2, 3, e, e))).astype(np.float32)).to(device)
        err = check_moments_bwd(f"essential_block_bwd {tag} B={B}", te, qkv,
                                pos, df, kw, dtype, failures)[0]
        ms = cuda_time_ms(lambda: te.fused_essential_block_bwd(
            qkv, pos, df, 3, **kw), 3)
        plain_ms = cuda_time_ms(lambda: te.essential_block_bwd_reference(
            qkv, pos, df, 3, **kw), 2)
        nb = 2 * nbytes(qkv) + nbytes(df)
        if pos is not None:
            nb += nbytes(pos) + 2 * 3 * pos.numel() * 4   # dpos partials
        b = bound(essential_bwd_flops(B, 576, 3, e=e), nb, dtype)
        log(f"[time] essential_block_bwd {tag} bf16 batch {B}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b[0]:.3f} ms "
            f"({b[1]}), max_abs_err {err:.3e} ({card})")
    del qkv, positional
    if failures:
        raise SystemExit(f"variant timing checks failed: {failures}")
    for name, (err, ms, plain_ms, _, b) in rows.items():
        log(f"[time] {name} bf16 batch {EVAL_BATCH}: kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {b[0]:.3f} ms ({b[1]}) "
            f"({card})")

    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.models.vitess import ViTEss
    from rel_pose_tpu_torch.nn.init import seeded_state_dict
    images = torch.from_numpy(rng.integers(
        0, 256, (EVAL_BATCH, 2, 3, 256, 256), dtype=np.uint8)).to(device)
    intr = torch.full((EVAL_BATCH, 2, 4), 128.0, device=device)
    batch = train_batch(rng, TRAIN_BATCH, device)
    for flag in ABLATIONS:
        sd = seeded_state_dict(ViTEss(ModelConfig(**{flag: True}),
                                      device="meta"), SEED)
        for kernels in (True, False):
            mode = "kernels" if kernels else "plain path"
            model, opt, sched = train_model(dtype, sd, device, kernels,
                                            **{flag: True})
            with torch.inference_mode():
                ms = cuda_time_ms(lambda: model(images, intr), 3)
            log(f"[time] {flag} eval forward bf16 batch {EVAL_BATCH} "
                f"256x256 uint8 ({mode}): {ms:.3f} ms, "
                f"{EVAL_BATCH / ms * 1e3:.2f} pairs/s ({card})")
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_time_ms(lambda: train_step(model, opt, sched, *batch),
                              3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"[time] {flag} train step bf16 batch {TRAIN_BATCH} 384x512 "
                f"uint8 ({mode}): {ms:.3f} ms, "
                f"{TRAIN_BATCH / ms * 1e3:.2f} pairs/s, peak {peak:.2f} GiB "
                f"({card})")
            del model, opt, sched
    return rows


# ------------------------------------------ kernels #8 and #9 (the last) --

def bilinear_inputs(rng, G, e, dtype, device, same, N=576):
    """q, k (G, N, 64), va, vb (G, N, e) of unit normal entries (va is vb
    with ``same``) and a dF (G, e, e) of 0.1 x unit normal, fp32."""
    def t(shape, scale=1.0, dt=dtype):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(device, dt)
    q, k, vb = t((G, N, 64)), t((G, N, 64)), t((G, N, e))
    va = vb if same else t((G, N, e))
    return q, k, va, vb, t((G, e, e), 0.1, torch.float32)


def moments_grads(fn, q1, q2, pos, kw, cot):
    """F and the gradients of (qkv1, qkv2, pos) of ``fn`` under autograd for
    the cotangent ``cot``."""
    leaves = [t.detach().clone().requires_grad_() for t in (q1, q2, pos)
              if t is not None]
    f = fn(leaves[0], leaves[1], leaves[2] if pos is not None else None, 3,
           **kw)
    f.backward(cot)
    return f.detach(), [t.grad for t in leaves]


def phase_kernels_bilinear(device):
    """(3e) #8 against its plain versions at G = 24 slices (4 pairs x 2
    directions x 3 heads) of N = 576 and of a ragged N = 100, e in {70,
    64}, dual and single softmax, va is vb and va != vb, fp32 (SIMT) and
    bf16 (the tensor-core body of essential_tc.cuh / essential_tc_bwd.cuh);
    forward and backward each twice for the same bits.  Then #8's public
    route, ``essential_block_head_stacked`` under autograd, against #4 + #6
    (``fused_essential_block`` under autograd) at B = 8 for the 8 flag
    combinations, fp32 and bf16, #8's counters set to 0 just before that
    route and read just after.  Returns (max |err| of the forward, of the
    backward, the route's launches)."""
    from rel_pose_tpu_torch.ops import bilinear as tb
    from rel_pose_tpu_torch.ops import essential_block as te
    failures, e_fwd, e_bwd = [], [], []
    for dtype in DTYPES:
        rng = np.random.default_rng(SEED + 13)
        for n, e, single, same in itertools.product(
                (576, 100), (70, 64), (False, True), (True, False)):
            name = (f"bilinear N={n} e={e} "
                    f"{'single' if single else 'dual'} "
                    f"{'va=vb' if same else 'va!=vb'} G=24")
            q, k, va, vb, df = bilinear_inputs(rng, 24, e, dtype, device,
                                               same, n)
            f, f_again = (tb.fused_bilinear_attention(q, k, va, vb, 0.125,
                                                      single)
                          for _ in range(2))
            grads, again = (tb.fused_bilinear_attention_bwd(
                q, k, va, vb, df, 0.125, single) for _ in range(2))
            torch.cuda.synchronize()
            e_fwd.append(check_f(f"{name} F", f,
                                 tb.bilinear_attention_reference(
                                     q, k, va, vb, 0.125, single),
                                 dtype, failures))
            if not torch.equal(f, f_again):
                failures.append(f"{name} F not bitwise repeatable {dtype}")
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                failures.append(f"{name} bwd not bitwise repeatable "
                                f"{dtype}")
            ref = tb.bilinear_attention_bwd_reference(q, k, va, vb, df,
                                                      0.125, single)
            e_bwd += [check_grad(f"{name} {part}", g, r, dtype, failures)
                      for part, g, r in zip(("dq", "dk", "dva", "dvb"),
                                            grads, ref)]
    counters = (tb.fused_bilinear_attention, tb.fused_bilinear_attention_bwd)
    runs = []
    for dtype in DTYPES:
        rng = np.random.default_rng(SEED + 14)
        xpair, ln, qkvp, positional = essential_inputs(rng, 8, dtype, device)
        _, (q1, q2), _ = split_pair(xpair, ln, qkvp)
        for has_pos, cross, single in VARIANTS:
            e = 64 + 6 * has_pos
            cot = torch.from_numpy(rng.standard_normal(
                (8, 2, 3, e, e)).astype(np.float32)).to(device)
            runs.append((dtype, variant_name(has_pos, cross, single),
                         (q1, q2, positional if has_pos else None,
                          variant_kw(cross, single), cot)))
    for c in counters:
        c.launches = 0
    stacked = [moments_grads(te.essential_block_head_stacked, *args)
               for _, _, args in runs]
    torch.cuda.synchronize()
    launches = {"bilinear_fwd": counters[0].launches,
                "bilinear_bwd": counters[1].launches}
    log(f"[check] head-stacked route (#8) launches: {launches}")
    failures += [f"{k} never launched" for k, v in launches.items() if v <= 0]
    same_bits = []
    for (dtype, name, args), (f, grads) in zip(runs, stacked):
        ref_f, ref_grads = moments_grads(te.fused_essential_block, *args)
        same_bits.append(torch.equal(f, ref_f))
        check_f(f"head-stacked {name} F vs #4 B=8", f, ref_f, dtype,
                failures)
        for part, g, r in zip(("dqkv1", "dqkv2", "dpos"), grads, ref_grads):
            check_grad(f"head-stacked {name} {part} vs #6 B=8", g, r, dtype,
                       failures, HEAD_STACKED_NORMREL[dtype])
    log(f"[check] head-stacked F equal to #4's bits in "
        f"{sum(same_bits)} of {len(same_bits)} runs")
    if failures:
        raise SystemExit(f"#8 checks failed: {failures}")
    return max(e_fwd), max(e_bwd), launches


def phase_kernels_cross_variants(device):
    """(3f) #9: ``essential_block_s`` for S in {2, 4} against #4 at B = 8,
    fp32 and bf16 (F_RTOL held; bf16 must give #4's bits, fp32's equal
    bits reported), and both modes of ``essential_block_variant`` against
    their plain version at B = 8 in bf16; every bf16 case twice for the
    same bits; both counters rose.  Returns max |err| of (S, variants)."""
    from rel_pose_tpu_torch.ops import cross_variants as cv
    from rel_pose_tpu_torch.ops import essential_block as te
    failures, e_s, e_v = [], [], []
    cv.essential_block_s.launches = cv.essential_block_variant.launches = 0
    for dtype in DTYPES:
        rng = np.random.default_rng(SEED + 15)
        xpair, ln, qkvp, positional = essential_inputs(rng, 8, dtype, device)
        _, (q1, q2), _ = split_pair(xpair, ln, qkvp)
        f4 = te.fused_essential_block(q1, q2, positional, 3)
        bf16 = dtype == torch.bfloat16
        for S in (2, 4):
            f, again = (cv.essential_block_s(q1, q2, positional, S)
                        for _ in range(2))
            torch.cuda.synchronize()
            same = torch.equal(f, f4)
            log(f"[check] essential_block_s S={S} {str(dtype)[6:]}: F "
                f"{'equal to' if same else 'DIFFERS from'} #4's bits")
            if bf16 and not same:
                failures.append(f"essential_block_s S={S} bf16 F differs "
                                f"from #4's bits")
            if bf16 and not torch.equal(f, again):
                failures.append(f"essential_block_s S={S} not bitwise "
                                f"repeatable")
            e_s.append(check_f(f"essential_block_s S={S} vs #4 B=8", f, f4,
                               dtype, failures))
        if bf16:
            for mode in cv.MODES:
                f, again = (cv.essential_block_variant(q1, q2, positional,
                                                       mode)
                            for _ in range(2))
                torch.cuda.synchronize()
                if not torch.equal(f, again):
                    failures.append(f"essential_block_variant {mode} not "
                                    f"bitwise repeatable")
                e_v.append(check_f(
                    f"essential_block_variant {mode} B=8", f,
                    cv.essential_block_variant_reference(q1, q2, positional,
                                                         mode),
                    dtype, failures))
    launches = (cv.essential_block_s.launches,
                cv.essential_block_variant.launches)
    log(f"[check] #9 launches (s, variant): {launches}")
    if min(launches) <= 0:
        failures.append(f"#9 launch counters {launches}")
    if failures:
        raise SystemExit(f"#9 checks failed: {failures}")
    return max(e_s), max(e_v)


def head_stacked_plain(*args, **kw):
    """``essential_block_head_stacked`` with #8's plain forward in place of
    the kernel, differentiated by autograd: the route's plain version, timed
    only."""
    from rel_pose_tpu_torch.ops import bilinear as tb
    from rel_pose_tpu_torch.ops import essential_block as te
    kernel = te.fused_bilinear_attention
    te.fused_bilinear_attention = tb.bilinear_attention_reference
    try:
        return te.essential_block_head_stacked(*args, **kw)
    finally:
        te.fused_bilinear_attention = kernel


def phase_times_bilinear(device, card, errs):
    """(5e) bf16 CUDA-event times: #8's forward at the eval shapes (G =
    1,536, e = 70) and backward at the training shapes (G = 360), each
    against its plain version and by part (``torch.profiler``: statistics,
    vb_n packing, moments, F-partial sum; statistics, prologue, each pass),
    with the TFLOP/s of each part's executed products and its exp2 floor;
    the head-stacked forward + backward against #4 + #6 and against its
    plain version at B = 60; then the microbenchmark script
    (``scripts/bench_cross_torch.py``, every case) at B = 256 with #9's
    counters set to 0 just before and read just after -- the launches of
    #9's path -- and the plain versions of s2, mxu_sums and bf16_mul beside
    it.  Returns the kernels-line rows of #8 and #9 and #9's launches."""
    import importlib
    from rel_pose_tpu_torch.ops import bilinear as tb
    from rel_pose_tpu_torch.ops import cross_variants as cv
    from rel_pose_tpu_torch.ops import essential_block as te
    bench = importlib.import_module("scripts.bench_cross_torch")
    dtype = torch.bfloat16
    rng = np.random.default_rng(SEED + 16)
    rows, failures = {}, []
    (fwd_err, bwd_err), (s_err, v_err) = errs

    G = 2 * EVAL_BATCH * 3
    q, k, va, vb, _ = bilinear_inputs(rng, G, 70, dtype, device, True)
    f = tb.fused_bilinear_attention(q, k, va, vb, 0.125)
    err = check_f(f"bilinear G={G} F", f, tb.bilinear_attention_reference(
        q, k, va, vb, 0.125), dtype, failures)
    ms = cuda_time_ms(lambda: tb.fused_bilinear_attention(
        q, k, va, vb, 0.125), 3)
    plain_ms = cuda_time_ms(lambda: tb.bilinear_attention_reference(
        q, k, va, vb, 0.125), 3)
    b = bound(moments_fwd_flops(EVAL_BATCH, 576, 3), nbytes(q, k, vb, f),
              dtype)
    rows["bilinear_fwd"] = (max(err, fwd_err), ms, plain_ms, None, b)
    executed = essential_executed(EVAL_BATCH, 576, 70, False, False)
    del executed["qkv GEMM"]
    log_essential_parts(f"bilinear_fwd G={G}", profile_parts_ms(
        lambda: tb.fused_bilinear_attention(q, k, va, vb, 0.125),
        essential_part, once=True), executed, card)
    del q, k, va, vb, f

    G = 2 * TRAIN_BATCH * 3
    q, k, va, vb, df = bilinear_inputs(rng, G, 70, dtype, device, True)
    grads = tb.fused_bilinear_attention_bwd(q, k, va, vb, df, 0.125)
    ref = tb.bilinear_attention_bwd_reference(q, k, va, vb, df, 0.125)
    err = max(check_grad(f"bilinear_bwd {part} G={G}", g, r, dtype, failures)
              for part, g, r in zip(("dq", "dk", "dva", "dvb"), grads, ref))
    del ref
    ms = cuda_time_ms(lambda: tb.fused_bilinear_attention_bwd(
        q, k, va, vb, df, 0.125), 3)
    plain_ms = cuda_time_ms(lambda: tb.bilinear_attention_bwd_reference(
        q, k, va, vb, df, 0.125), 2)
    b = bound(essential_bwd_flops(TRAIN_BATCH, 576, 3),
              2 * nbytes(q, k, vb) + nbytes(df, *grads), dtype)
    rows["bilinear_bwd"] = (max(err, bwd_err), ms, plain_ms, None, b)
    log_essential_parts(f"bilinear_bwd G={G}", profile_parts_ms(
        lambda: tb.fused_bilinear_attention_bwd(q, k, va, vb, df, 0.125),
        essential_part, once=True),
        essential_executed(TRAIN_BATCH, 576, 70, False, True), card)
    del q, k, va, vb, df, grads

    B = TRAIN_BATCH
    xpair, ln, qkvp, positional = essential_inputs(rng, B, dtype, device)
    _, (q1, q2), _ = split_pair(xpair, ln, qkvp)
    del xpair
    pos = positional.to(dtype)
    cot = torch.from_numpy(rng.standard_normal((B, 2, 3, 70, 70)).astype(
        np.float32)).to(device)
    route_ms = {}
    for name, fn in (("head-stacked #8", te.essential_block_head_stacked),
                     ("#4 + #6", te.fused_essential_block),
                     ("head-stacked plain", head_stacked_plain)):
        route_ms[name] = cuda_time_ms(lambda: moments_grads(
            fn, q1, q2, pos, {}, cot), 3)
    b = bound(moments_fwd_flops(B, 576, 3) + essential_bwd_flops(B, 576, 3),
              3 * nbytes(q1, q2, pos) + nbytes(cot), dtype)
    log(f"[time] essential block forward + backward bf16 batch {B}: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in route_ms.items())
        + f", bound {b[0]:.3f} ms ({b[1]}) ({card})")
    del q1, q2, pos, positional, cot

    B = EVAL_BATCH
    inputs = bench.make_inputs(B, device, SEED + 17)
    cv.essential_block_s.launches = cv.essential_block_variant.launches = 0
    times = bench.time_cases(inputs, 5, include_all=True)
    torch.cuda.synchronize()
    launches = {"essential_block_s": cv.essential_block_s.launches,
                "essential_block_variant":
                    cv.essential_block_variant.launches}
    log(f"[time] bench_cross_torch bf16 batch {B}: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
        + f" ({card}); #9 launches {launches}")
    failures += [f"{k} never launched" for k, v in launches.items()
                 if v <= 0]
    a, b_, p = inputs
    f = cv.essential_block_s(a, b_, p, 2)
    err = check_f(f"essential_block_s S=2 B={B}", f,
                  te.essential_block_reference(a, b_, p, 3), dtype, failures)
    plain_ms = cuda_time_ms(
        lambda: te.essential_block_reference(a, b_, p, 3), 3)
    bb = bound(moments_fwd_flops(B, 576, 3), nbytes(a, b_, p, f), dtype)
    rows["essential_block_s"] = (max(err, s_err), times["s2"], plain_ms,
                                 None, bb)
    f = cv.essential_block_variant(a, b_, p, "mxu_sums")
    err = check_f(f"essential_block_variant mxu_sums B={B}", f,
                  cv.essential_block_variant_reference(a, b_, p, "mxu_sums"),
                  dtype, failures)
    plain_ms = cuda_time_ms(lambda: cv.essential_block_variant_reference(
        a, b_, p, "mxu_sums"), 3)
    rows["essential_block_variant"] = (max(err, v_err), times["mxu_sums"],
                                       plain_ms, None, bb)
    f = cv.essential_block_variant(a, b_, p, "bf16_mul")
    check_f(f"essential_block_variant bf16_mul B={B}", f,
            cv.essential_block_variant_reference(a, b_, p, "bf16_mul"),
            dtype, failures)
    plain_ms = cuda_time_ms(lambda: cv.essential_block_variant_reference(
        a, b_, p, "bf16_mul"), 3)
    log(f"[time] essential_block_variant bf16_mul bf16: kernel "
        f"{times['bf16_mul']:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bb[0]:.3f} ms ({bb[1]}) ({card})")
    del inputs, a, b_, p, f
    if failures:
        raise SystemExit(f"#8 / #9 timing checks failed: {failures}")
    for name, (err, ms, plain_ms, _, (b_ms, b_by)) in rows.items():
        log(f"[time] {name} bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms, bound {b_ms:.3f} ms ({b_by}) ({card})")
    return rows, launches


# ------------------------------------------------- the no-fusion baseline --

def phase_nofusion(device, card):
    """(4e) the no-fusion baseline (``ModelConfig(fusion_transformer=
    False)``, the training CLI's default; no hand kernel on its path) at
    full width with seeded weights: ``PosePredictor`` on the card answers
    phase 4's requests, fp32 and bf16, against the same weights run by the
    port on the CPU in fp32 (POSE_ATOL); 3 train steps of 4 pairs per dtype
    on the card, losses finite, the step-1 loss and gradients against the
    CPU's step in the same dtype on the same batch (LOSS_RTOL; LEAF_COS and
    LEAF_RATIO for the pool head and the regressor, TRUNK_LEAF_COS and
    TRUNK_LEAF_RATIO for the trunk); then the eval forward at batch 256
    (256x256, bf16) and the train step at batch 60 (384x512, fp32 and
    bf16) in pairs/s."""
    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.infer import PosePredictor
    from rel_pose_tpu_torch.models.vitess import ViTEss
    from rel_pose_tpu_torch.nn.init import seeded_state_dict
    from rel_pose_tpu_torch.train.step import train_step
    flags = {"fusion_transformer": False}
    cpu = torch.device("cpu")
    sd = seeded_state_dict(ViTEss(ModelConfig(**flags), device="meta"),
                           SEED + 20)
    failures = []

    def model_on(dev, dtype):
        m = ViTEss(ModelConfig(compute_dtype=str(dtype)[6:], **flags),
                   device=dev)
        m.load_state_dict(sd)
        return m

    reqs = requests(np.random.default_rng(SEED + 1))
    cpu32 = model_on(cpu, torch.float32)
    for dtype in DTYPES:
        card_model = model_on(device, dtype)
        for name, images, intr, size in reqs:
            got, want = (PosePredictor(m, intrinsics=intr, batch_size=8,
                                       image_size=size).predict_batch(images)
                         for m in (card_model, cpu32))
            check_poses(f"nofusion {name}", dtype, got, want, len(images),
                        failures, label="nofusion")
        del card_model
    del cpu32

    for dtype in DTYPES:
        rng = np.random.default_rng(SEED + 21)
        batches = [train_batch(rng, SLICE_TRAIN_BATCH, device)
                   for _ in range(3)]
        runs = {}
        for where, dev, steps in (("card", device, 3), ("cpu", cpu, 1)):
            model, opt, sched = train_model(dtype, sd, dev, True, **flags)
            losses, grads1 = [], None
            for step, batch in enumerate(batches[:steps]):
                metrics, poses = train_step(model, opt, sched,
                                            *(t.to(dev) for t in batch))
                losses.append(metrics["loss"].item())
                if step == 0:
                    grads1 = {n: p.grad.detach().to(cpu)
                              for n, p in model.named_parameters()}
            runs[where] = (losses, grads1)
            log(f"[nofusion] train {str(dtype)[6:]} on the {where}: losses "
                f"{[round(v, 6) for v in losses]}")
            if not all(np.isfinite(losses)):
                failures.append(f"nofusion losses {dtype} {where}")
            del model, opt, sched
        (lk, gk), (lp, gp) = runs["card"], runs["cpu"]
        rel = abs(lk[0] - lp[0]) / abs(lp[0])
        ok = rel <= LOSS_RTOL[dtype]
        log(f"[nofusion] train {str(dtype)[6:]} step-1 loss card "
            f"{lk[0]:.6f} cpu {lp[0]:.6f} rel {rel:.3e} (<= "
            f"{LOSS_RTOL[dtype]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"nofusion step-1 loss {dtype}")
        trunk = [n for n in gk if n.startswith(("resnet.",
                                                "extractor_final_conv."))]
        compare_leaves(dtype, {n: gk[n] for n in trunk},
                       {n: gp[n] for n in trunk}, failures,
                       label="nofusion trunk", leaf_cos=TRUNK_LEAF_COS,
                       leaf_ratio=TRUNK_LEAF_RATIO)
        compare_leaves(dtype, {n: g for n, g in gk.items() if n not in trunk},
                       {n: g for n, g in gp.items() if n not in trunk},
                       failures, label="nofusion head")
    if failures:
        raise SystemExit(f"no-fusion checks failed: {failures}")

    rng = np.random.default_rng(SEED + 22)
    B = EVAL_BATCH
    images = torch.from_numpy(rng.integers(
        0, 256, (B, 2, 3, 256, 256), dtype=np.uint8)).to(device)
    intr = torch.full((B, 2, 4), 128.0, device=device)
    model = model_on(device, torch.bfloat16)
    with torch.inference_mode():
        ms = cuda_time_ms(lambda: model(images, intr), 3)
    log(f"[time] nofusion eval forward bf16 batch {B} 256x256 uint8: "
        f"{ms:.3f} ms, {B / ms * 1e3:.2f} pairs/s ({card})")
    del model, images
    batch = train_batch(rng, TRAIN_BATCH, device)
    for dtype in DTYPES:
        model, opt, sched = train_model(dtype, sd, device, True, **flags)
        ms = cuda_time_ms(lambda: train_step(model, opt, sched, *batch), 3)
        log(f"[time] nofusion train step {str(dtype)[6:]} batch "
            f"{TRAIN_BATCH} 384x512 uint8: {ms:.3f} ms, "
            f"{TRAIN_BATCH / ms * 1e3:.2f} pairs/s ({card})")
        del model, opt, sched


# ---------------------------------------------------- the training CLI --

CLI_DIR = OUTPUT_DIR / "chip_smoke_cli"
CLI_PAIRS = 24          # the tree's pairs, 480x640 JPEG
CLI_DEPTH = 6
CLI_THROUGHPUT_STEPS = 15   # at batch 60, 5 of them the timer's warm-up


def write_matterport_tree(root, rng, pairs, entries, images=None):
    """A Matterport-layout tree: ``pairs`` pairs of 480x640 JPEGs (quality
    95; smooth colour fields with noise, so that they compress and decode
    like photographs more than like noise), or a link to the ``images``
    directory of another tree, and a split file of ``entries`` pairs
    cycling through them, random poses (W-first quaternions, as the
    dataset stores them)."""
    import cv2
    yy, xx = np.mgrid[0:480, 0:640].astype(np.float32)
    files = [f"a/b/c/d/e/f/imgs/p{i // 2}_{i % 2}.jpg"
             for i in range(2 * pairs)]
    root.mkdir(parents=True, exist_ok=True)
    if images is not None:
        (root / "imgs").symlink_to(images, target_is_directory=True)
    for i in range(0 if images is not None else 2 * pairs):
        f = rng.uniform(0.5, 3.0, (3, 2))
        ph = rng.uniform(0, 2 * np.pi, (3, 2))
        img = np.stack([np.sin(2 * np.pi * f[c, 0] * xx / 640 + ph[c, 0])
                        * np.cos(2 * np.pi * f[c, 1] * yy / 480 + ph[c, 1])
                        for c in range(3)], axis=-1)
        img = 127.5 + 100 * img + rng.normal(0, 8, img.shape)
        path = root / files[i][len("a/b/c/d/e/f/"):]
        path.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(path), np.clip(img, 0, 255).astype(np.uint8),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
    data = []
    for k in range(entries):
        p = k % pairs
        q = rng.standard_normal(4)
        q[0] = abs(q[0]) + 2.0
        data.append({"0": {"file_name": files[2 * p]},
                     "1": {"file_name": files[2 * p + 1]},
                     "rel_pose": {"position": list(0.5 * rng.standard_normal(
                         3)), "rotation": list(q / np.linalg.norm(q))}})
    (root / "mp3d_planercnn_json").mkdir(parents=True, exist_ok=True)
    for split in ("train", "val", "test"):
        (root / "mp3d_planercnn_json" / f"cached_set_{split}.json"
         ).write_text(json.dumps({"data": data}))


def cli_records(name):
    path = CLI_DIR / "output" / name / "runs" / "metrics.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def phase_cli(device, card, synthetic_ms):
    """(6) the training CLI, ``rel_pose_tpu_torch.cli.train``, as a user
    runs it, on Matterport-layout trees of 480x640 JPEGs under
    ``output/chip_smoke_cli/``: the native host library built and loaded;
    (a) in-process, the flagship at depth 6, bf16, batch 6, 4 steps, a
    checkpoint every 2: #1, #2, #5 and #6 launched during the run, finite
    losses in ``metrics.jsonl``, the checkpoints there; (b) ``python -m``
    in a child process to step 5: it resumes and exits 0; (c) the no-fusion
    default, fp32, 2 steps; (d) the flagship bf16 at batch 60 for
    CLI_THROUGHPUT_STEPS steps: the CLI's steady-state pairs/s and the
    share of the loop's time spent waiting on the data loader, beside
    phase 5b's synthetic step (``synthetic_ms``).  Returns (a)'s launch
    counts."""
    from rel_pose_tpu_torch import native
    from rel_pose_tpu_torch.cli import train as cli
    from rel_pose_tpu_torch.tools import child_env
    if not native.available():
        raise SystemExit(f"native host library: {native.build_error()}")
    log(f"[cli] native host library loaded: {native.library_path()}")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 30)
    t0 = time.perf_counter()
    write_matterport_tree(CLI_DIR / "mp", rng, CLI_PAIRS, CLI_PAIRS)
    write_matterport_tree(CLI_DIR / "mp60", rng, CLI_PAIRS,
                          TRAIN_BATCH * CLI_THROUGHPUT_STEPS,
                          images=CLI_DIR / "mp" / "imgs")
    log(f"[cli] wrote the trees in {time.perf_counter() - t0:.1f} s")
    common = ["--no_ddp", "--num_workers", "4", "--dataset", "matterport"]
    flagship = ["--fusion_transformer", "--transformer_depth",
                str(CLI_DEPTH), "--compute_dtype", "bfloat16"]
    counters = kernel_counters()
    failures = []
    cwd = os.getcwd()
    os.chdir(CLI_DIR)
    try:
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        cli.main(["--name", "flagship", "--datapath", "mp", "--batch", "6",
                  "--steps", "4", "--ckpt_every", "2", "--warmup", "2"]
                 + common + flagship)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        log(f"[cli] flagship bf16 depth {CLI_DEPTH} batch 6, 4 steps in "
            f"{time.perf_counter() - t0:.1f} s; kernel launches during the "
            f"CLI's steps: {launches}")
        failures += [f"{k} never launched in the CLI" for k, v in
                     launches.items() if v <= 0]
        losses = [r["train_geo_loss_tr"] + r["train_geo_loss_rot"]
                  for r in cli_records("flagship")
                  if "train_geo_loss_tr" in r]
        ckpts = sorted(os.listdir("output/flagship/checkpoints"))
        log(f"[cli] flagship losses {losses}, checkpoints {ckpts}")
        if not losses or not np.isfinite(losses).all():
            failures.append(f"CLI losses {losses}")
        if ckpts != ["000002.pth", "000004.pth"]:
            failures.append(f"CLI checkpoints {ckpts}")

        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "rel_pose_tpu_torch.cli.train", "--name",
             "flagship", "--datapath", "mp", "--batch", "6", "--steps", "5",
             "--ckpt_every", "2", "--warmup", "2"] + common + flagship,
            env=child_env(), capture_output=True, text=True, timeout=900)
        resumed = ("loading existing checkpoint "
                   "output/flagship/checkpoints/000004.pth" in r.stdout)
        log(f"[cli] python -m rel_pose_tpu_torch.cli.train --steps 5: exit "
            f"{r.returncode} in {time.perf_counter() - t0:.1f} s, "
            f"{'resumed from step 4' if resumed else 'DID NOT RESUME'}, "
            f"000005.pth "
            f"{os.path.exists('output/flagship/checkpoints/000005.pth')}")
        if r.returncode != 0 or not resumed or not os.path.exists(
                "output/flagship/checkpoints/000005.pth"):
            failures.append("CLI resume")
            log(r.stdout[-3000:] + r.stderr[-3000:])

        cli.main(["--name", "nofusion", "--datapath", "mp", "--batch", "6",
                  "--steps", "2", "--warmup", "1"] + common)
        losses = [r["train_geo_loss_tr"] + r["train_geo_loss_rot"]
                  for r in cli_records("nofusion")
                  if "train_geo_loss_tr" in r]
        log(f"[cli] no-fusion default fp32, 2 steps: losses {losses}")
        if not losses or not np.isfinite(losses).all():
            failures.append(f"CLI no-fusion losses {losses}")

        t0 = time.perf_counter()
        cli.main(["--name", "batch60", "--datapath", "mp60", "--batch",
                  str(TRAIN_BATCH), "--steps", str(CLI_THROUGHPUT_STEPS),
                  "--ckpt_every", "1000000", "--warmup", "2"]
                 + common + flagship)
        rec = next(r for r in cli_records("batch60") if "timed_steps" in r)
        log(f"[time] training CLI bf16 batch {TRAIN_BATCH} 384x512 from "
            f"480x640 JPEGs ({CLI_THROUGHPUT_STEPS} steps in "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{int(rec['timed_steps'])} timed): "
            f"{rec['pairs_per_sec_per_chip']:.2f} pairs/s, waiting on the "
            f"loader {100 * rec['loader_wait_share']:.2f}% of the step; "
            f"phase 5b's synthetic train_step {synthetic_ms:.3f} ms, "
            f"{TRAIN_BATCH / synthetic_ms * 1e3:.2f} pairs/s ({card})")
        log_loader_parts(card)
    finally:
        os.chdir(cwd)
    if failures:
        raise SystemExit(f"training CLI checks failed: {failures}")
    return launches


def log_loader_parts(card, pairs=24, batches=6):
    """The host side of (6d) by part, on the batch-60 tree: one thread's
    milliseconds a pair for the JPEG decode (``image_read`` of both images)
    and for the whole sample (decode, resize, jitter, quantize: the
    dataset's ``__getitem__``), then the CLI's loader alone (4 workers,
    batch 60, no training beside it) in pairs/s."""
    from rel_pose_tpu_torch.data import DataLoader, Matterport
    from rel_pose_tpu_torch.data.base import image_read
    db = Matterport(datapath="mp60", subepoch=0,
                    rng=np.random.default_rng(SEED + 31))
    t0 = time.perf_counter()
    for a, b in db.scene_info["images"][:pairs]:
        image_read(a), image_read(b)
    decode = (time.perf_counter() - t0) / pairs * 1e3
    t0 = time.perf_counter()
    for i in range(pairs):
        db[i]
    sample = (time.perf_counter() - t0) / pairs * 1e3
    it = iter(DataLoader(db, batch_size=TRAIN_BATCH, seed=SEED,
                         num_workers=4))
    next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    rate = batches * TRAIN_BATCH / (time.perf_counter() - t0)
    it.close()
    log(f"[time] host data pipeline, 480x640 JPEG pairs -> 384x512 uint8: "
        f"one thread {decode:.2f} ms a pair decoding, {sample:.2f} ms a "
        f"pair in all (resize, jitter, quantize: {sample - decode:.2f}); "
        f"the loader alone, 4 workers, batch {TRAIN_BATCH}: {rate:.2f} "
        f"pairs/s ({os.cpu_count()} host cores; {card})")


# ------------------------------------------ the eval, demo and epipolar CLIs --

EVAL_DIR = OUTPUT_DIR / "chip_smoke_eval"
EVAL_PAIRS = 8              # distinct 480x640 JPEG pairs
EVAL_ENTRIES = 64           # the Matterport test split, cycling through them
EVAL_INET_PAIRS = 32        # 256x256 PNG pairs
EVAL_CHECK_BATCH = 16
EVAL_THROUGHPUT_BATCH = 64
EVAL_THROUGHPUT_CHUNKS = 10     # 2 of them the pipeline's warm-up
EVAL_DEPTH = 6


def rotation_err_tol(err_deg, atol):
    """The most a rotation error 2 arccos|<q, g>| (degrees) can move when
    the predicted quaternion moves by ``atol`` in each of its 4 elements
    (phase 4's pose tolerance): |<q, g>| moves by at most ||dq|| <= 2 atol,
    and the angle by as much as arccos does over that interval of its
    argument, taken exactly (it is steepest near 0 and 180 degrees)."""
    c = np.cos(np.radians(err_deg) / 2)
    dc = 2 * atol
    lo = 2 * np.arccos(np.clip(c + dc, 0, 1))
    hi = 2 * np.arccos(np.clip(c - dc, 0, 1))
    theta = np.radians(err_deg)
    return np.degrees(np.maximum(theta - lo, hi - theta))


def tran_err_tol(atol):
    """The most a translation error ||g - 5 t|| (metres) can move when t
    moves by ``atol`` in each of its 3 elements: 5 sqrt(3) atol."""
    return 5.0 * np.sqrt(3.0) * atol


def write_viewpoint_tree(root, rng, pairs):
    """An InteriorNet test tree: ``pairs`` pairs of 256x256 PNGs and
    ``metadata/interiornet/test_pair_rotation.npy`` with viewpoints whose
    relative yaw spans 0-115 degrees."""
    import cv2
    split = {}
    for i in range(pairs):
        p1, p2 = f"s/{i}a.png", f"s/{i}b.png"
        for p in (p1, p2):
            path = root / "data" / "interiornet" / p
            path.parent.mkdir(parents=True, exist_ok=True)
            img = rng.normal(127.5, 60, (256, 256, 3))
            cv2.imwrite(str(path), np.clip(img, 0, 255).astype(np.uint8))
        split[i] = {"img1": {"path": p1, "x": rng.uniform(-0.2, 0.2),
                             "y": 0.0},
                    "img2": {"path": p2, "x": rng.uniform(-0.2, 0.2),
                             "y": 2.0 * i / pairs}}
    (root / "metadata" / "interiornet").mkdir(parents=True, exist_ok=True)
    np.save(root / "metadata" / "interiornet" / "test_pair_rotation.npy",
            np.array([split], dtype=object), allow_pickle=True)


def run_quiet(main, argv):
    """``main(argv)`` with its standard output captured -> (exit code,
    output)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    return code, buf.getvalue()


def csv(path):
    return np.loadtxt(path, delimiter=",", ndmin=1)


def check_eval_files(label, ckpt_dir, pth_dir, files, failures):
    """The .ckpt's and the .pth's results.txt and CSVs, byte for byte."""
    same = [f for f in ["results.txt"] + files
            if (ckpt_dir / f).read_bytes() == (pth_dir / f).read_bytes()]
    log(f"[eval-cli] {label}: .ckpt and .pth give byte-identical "
        f"{len(same)} of {1 + len(files)} files")
    if len(same) != 1 + len(files):
        failures.append(f"{label}: .ckpt and .pth files differ")


def check_err_column(label, got, want, tol, failures,
                     what="kernels - plain"):
    """CLI errors (kernels) against the plain path's, row by row, within
    ``tol`` (an array or a number) plus the CSV's %1.5f rounding."""
    gap = np.abs(got - want)
    bad = int((gap > tol + 1e-5).sum())
    log(f"[eval-cli] {label}: {len(got)} rows, max |{what}| "
        f"{gap.max():.3e} (bound {np.min(tol):.3e}-{np.max(tol):.3e} + 1e-5)"
        f" {'ok' if not bad else f'FAIL in {bad} rows'}")
    if bad:
        failures.append(f"{label}: {bad} rows beyond the bound")


def eval_plain_model(sd, dtype, device):
    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.models.vitess import ViTEss
    model = ViTEss(ModelConfig(compute_dtype=str(dtype)[6:],
                               transformer_depth=EVAL_DEPTH),
                   device=device, kernels=False)
    model.load_state_dict(sd)
    return model


def eval_matterport_plain(sd, dtype, device, exp):
    """The Matterport metrics on poses of the plain path for the images
    the CLI decodes, through the CLI's own ``eval_camera``, under
    ``output/<exp>/matterport_test``."""
    from rel_pose_tpu_torch.cli import test_matterport as mp
    from rel_pose_tpu_torch.data.base import image_read
    from rel_pose_tpu_torch.infer import (MATTERPORT_INTRINSICS,
                                          PosePredictor, matterport_eval_pose)
    dset = json.loads(pathlib.Path(
        "mp/mp3d_planercnn_json/cached_set_test.json").read_text())["data"]
    images = np.stack([np.stack([image_read(mp.image_path(
        "mp", e[k]["file_name"])) for k in ("0", "1")]).transpose(0, 3, 1, 2)
        for e in dset])
    pred = PosePredictor(eval_plain_model(sd, dtype, device),
                         intrinsics=MATTERPORT_INTRINSICS,
                         batch_size=EVAL_CHECK_BATCH, image_size=(384, 512))
    poses = matterport_eval_pose(pred.predict_batch(images)[:, 1])
    gts = [mp.ground_truth(e) for e in dset]
    preds = {"camera": {"preds": {"tran": [p[:3] for p in poses],
                                  "rot": [p[3:] for p in poses]},
                        "gts": {"tran": [g[0] for g in gts],
                                "rot": [g[1] for g in gts]}}}
    os.makedirs(f"output/{exp}/matterport_test", exist_ok=True)
    mp.eval_camera(preds, exp, "matterport_test")


def eval_interiornet_plain(sd, dtype, device, exp):
    """The InteriorNet metrics on the plain path's poses, through the
    CLI's ``eval_camera``, under ``output/<exp>/interiornet_test``."""
    from rel_pose_tpu_torch.cli import test_streetlearn_interiornet as insl
    from rel_pose_tpu_torch.data.base import image_read
    from rel_pose_tpu_torch.infer import (INTERIORNET_STREETLEARN_INTRINSICS,
                                          PosePredictor)
    dset = np.load("inet/metadata/interiornet/test_pair_rotation.npy",
                   allow_pickle=True)[0]
    items = sorted(dset.items())[:insl.MAX_PAIRS]
    images = np.stack([np.stack([image_read(
        f"inet/data/interiornet/{rec[k]['path']}") for k in ("img1", "img2")
    ]).transpose(0, 3, 1, 2) for _, rec in items])
    pred = PosePredictor(eval_plain_model(sd, dtype, device),
                         intrinsics=INTERIORNET_STREETLEARN_INTRINSICS,
                         batch_size=EVAL_CHECK_BATCH)
    poses = pred.predict_batch(images)[:, 1]
    preds = {"camera": {"preds": {"tran": [], "rot": [p[3:] for p in poses]},
                        "gts": {"tran": [], "rot": [
                            insl.ground_truth(rec) for _, rec in items]}}}
    out = pathlib.Path(f"output/{exp}/interiornet_test")
    out.mkdir(parents=True, exist_ok=True)
    insl.eval_camera(preds, str(out))


def eval_cli_runs(dev, dtypes, cli, datapath, folder, files, counters,
                  failures, extra=()):
    """The CLI from the .ckpt and the .pth in each of ``dtypes``, #1's and
    #2's counters set to 0 just before each run and read just after; ->
    {"<folder> <dtype>": launches of the .ckpt run}."""
    launches = {}
    for dtype in dtypes:
        name = str(dtype)[6:]
        for ckpt in ("model.ckpt", "model.pth"):
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            code, out = run_quiet(cli.main, [
                "--exp", f"{name}_{ckpt[6:]}", "--datapath", datapath,
                "--ckpt", ckpt, "--batch", str(EVAL_CHECK_BATCH),
                "--device", dev, "--fusion_transformer",
                "--transformer_depth", str(EVAL_DEPTH), "--compute_dtype",
                name] + list(extra))
            if dev == "cuda":
                torch.cuda.synchronize()
            got = {k: counters[k].launches for k in ("vit_stack",
                                                     "essential_block_pair")}
            log(f"[eval-cli] {cli.PROG.split('.')[-1]} {name} from {ckpt}: "
                f"exit {code} in {time.perf_counter() - t0:.1f} s, kernel "
                f"launches {got}; {out.strip().splitlines()[-1]}")
            failures += [f"{folder} {name} {ckpt}: {k} never launched"
                         for k, v in got.items() if v <= 0]
            if code != 0:
                failures.append(f"{folder} {name} {ckpt}: exit {code}")
            launches.setdefault(f"{folder} {name}", got)
        check_eval_files(f"{folder} {name}",
                         pathlib.Path(f"output/{name}_ckpt/{folder}"),
                         pathlib.Path(f"output/{name}_pth/{folder}"), files,
                         failures)
    return launches


def phase_eval_cli(device, card):
    """(7) the eval, demo, epipolar and convert CLIs and
    ``PosePredictor.warmup``, as a user runs them, at full width and depth
    6 with the flagship's seeded weights, on trees written under
    ``output/chip_smoke_eval/`` (removed at the end): (a) ``cli.
    test_matterport`` fp32 and bf16 from a ``.pth`` and from the ``.ckpt``
    that ``cli.convert_checkpoint`` made of it: the same bytes from both,
    the per-pair errors against the plain path's through the CLI's
    ``eval_camera`` within phase 4's pose tolerance carried through the
    metric, #1 and #2 launched; (b) ``cli.test_streetlearn_interiornet``,
    bf16, the same checks; (c) ``cli.demo`` on a ``matterport`` name and
    another: its printed numbers those of ``PosePredictor`` after the
    demo's conventions; (d) ``cli.generate_epipolar_imgs`` on the card
    and on the CPU: both PNGs written, the 9 lines' slopes and intercepts
    within 1e-5 relative, the PNGs compared bit for bit (reported); (e)
    the warm-up and first-request latency of a cold process with and
    without ``warmup()``; (f) the Matterport CLI's steady-state pairs/s and
    decode-wait share at batch 64 beside the forward alone; (g) ``cli.train
    --ckpt`` on the ``.ckpt``, bf16, 2 steps: weights only restored,
    finite losses, #1, #2, #5 and #6 launched."""
    from rel_pose_tpu_torch.cli import convert_checkpoint
    from rel_pose_tpu_torch.cli import generate_epipolar_imgs as epi
    from rel_pose_tpu_torch.cli import test_matterport as mp
    from rel_pose_tpu_torch.cli import test_streetlearn_interiornet as insl
    from rel_pose_tpu_torch.cli import train as train_cli
    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.models.vitess import ViTEss
    from rel_pose_tpu_torch.nn.init import seeded_state_dict
    dev = "cuda" if device.type == "cuda" else "cpu"
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    EVAL_DIR.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 40)
    t_phase = t0 = time.perf_counter()
    write_matterport_tree(EVAL_DIR / "mp", rng, EVAL_PAIRS, EVAL_ENTRIES)
    write_matterport_tree(EVAL_DIR / "mp_many", rng, EVAL_PAIRS,
                          EVAL_THROUGHPUT_BATCH * EVAL_THROUGHPUT_CHUNKS,
                          images=EVAL_DIR / "mp" / "imgs")
    write_viewpoint_tree(EVAL_DIR / "inet", rng, EVAL_INET_PAIRS)
    cfg = ModelConfig(transformer_depth=EVAL_DEPTH)
    sd = seeded_state_dict(ViTEss(cfg, device="meta"), SEED)
    torch.save({"model": sd}, EVAL_DIR / "model.pth")
    log(f"[eval-cli] wrote the trees and model.pth in "
        f"{time.perf_counter() - t0:.1f} s")
    counters = kernel_counters()
    failures = []
    cwd = os.getcwd()
    os.chdir(EVAL_DIR)
    try:
        code, out = run_quiet(convert_checkpoint.main, [
            "--ckpt", "model.pth", "--out", "model.ckpt",
            "--transformer_depth", str(EVAL_DEPTH)])
        log(f"[eval-cli] convert_checkpoint: exit {code}; {out.strip()}")

        # (a) Matterport, fp32 and bf16
        mp_files = ["gt_translation_magnitude_vs_error.csv",
                    "gt_rotation_magnitude_vs_error.csv"]
        launches = eval_cli_runs(dev, DTYPES, mp, "mp", "matterport_test",
                                 mp_files, counters, failures)
        for dtype in DTYPES:
            name = str(dtype)[6:]
            eval_matterport_plain(sd, dtype, device, f"{name}_plain")
            cli_dir = pathlib.Path(f"output/{name}_ckpt/matterport_test")
            plain_dir = pathlib.Path(f"output/{name}_plain/matterport_test")
            t_cli, t_plain = csv(cli_dir / mp_files[0]), csv(
                plain_dir / mp_files[0])
            r_cli, r_plain = csv(cli_dir / mp_files[1]), csv(
                plain_dir / mp_files[1])
            if not (np.array_equal(t_cli[:, 0], t_plain[:, 0])
                    and np.array_equal(r_cli[:, 0], r_plain[:, 0])):
                failures.append(f"matterport {name}: ground truth columns")
            check_err_column(f"matterport {name} translation error (m)",
                             t_cli[:, 1], t_plain[:, 1],
                             tran_err_tol(POSE_ATOL[dtype]), failures)
            check_err_column(f"matterport {name} rotation error (deg)",
                             r_cli[:, 1], r_plain[:, 1],
                             rotation_err_tol(r_plain[:, 1],
                                              POSE_ATOL[dtype]), failures)

        # (b) InteriorNet, bf16
        insl_files = ["all_rotation_err_degrees.csv",
                      "all_gt_rot_degrees.csv"]
        bf16 = torch.bfloat16
        launches.update(eval_cli_runs(
            dev, (bf16,), insl, "inet", "interiornet_test", insl_files,
            counters, failures, ["--dataset", "interiornet"]))
        eval_interiornet_plain(sd, bf16, device, "bfloat16_plain")
        cli_dir = pathlib.Path("output/bfloat16_ckpt/interiornet_test")
        plain_dir = pathlib.Path("output/bfloat16_plain/interiornet_test")
        if not np.array_equal(csv(cli_dir / insl_files[1]),
                              csv(plain_dir / insl_files[1])):
            failures.append("interiornet: ground-truth angles")
        want = csv(plain_dir / insl_files[0])
        check_err_column("interiornet bfloat16 rotation error (deg)",
                         csv(cli_dir / insl_files[0]), want,
                         rotation_err_tol(want, POSE_ATOL[bf16]), failures)

        phase_eval_demo(dev, cfg, failures)
        phase_eval_epipolar(dev, epi, failures)
        phase_eval_warmup(dev, card, failures)

        # (f) the Matterport CLI's throughput, bf16, batch 64
        t0 = time.perf_counter()
        code, out = run_quiet(mp.main, [
            "--exp", "throughput", "--datapath", "mp_many", "--ckpt",
            "model.ckpt", "--batch", str(EVAL_THROUGHPUT_BATCH), "--device",
            dev, "--fusion_transformer", "--transformer_depth",
            str(EVAL_DEPTH), "--compute_dtype", "bfloat16"])
        m = re.search(r"throughput: ([\d.]+) pairs/s .* waiting on decode "
                      r"([\d.]+)%", out)
        forward_ms = eval_forward_ms(sd, device)
        log(f"[time] Matterport eval CLI bf16 batch "
            f"{EVAL_THROUGHPUT_BATCH}, 480x640 JPEGs -> 384x512 "
            f"({EVAL_THROUGHPUT_CHUNKS} chunks in "
            f"{time.perf_counter() - t0:.1f} s, exit {code}): "
            f"{m.group(1) if m else '?'} pairs/s, waiting on decode "
            f"{m.group(2) if m else '?'}% of the loop; the forward alone "
            f"(PosePredictor, uint8 480x640 in) {forward_ms:.3f} ms, "
            f"{EVAL_THROUGHPUT_BATCH / forward_ms * 1e3:.2f} pairs/s "
            f"({os.cpu_count()} host cores; {card})")
        if code != 0 or not m:
            failures.append(f"throughput run: exit {code}")

        # (g) the training CLI from the .ckpt
        keys = list(counters)
        for c in counters.values():
            c.launches = 0
        code, out = run_quiet(train_cli.main, [
            "--name", "from_ckpt", "--datapath", "mp", "--batch", "6",
            "--steps", "2", "--warmup", "1", "--ckpt", "model.ckpt",
            "--no_ddp", "--num_workers", "4", "--dataset", "matterport",
            "--fusion_transformer", "--transformer_depth", str(EVAL_DEPTH),
            "--compute_dtype", "bfloat16", "--device", dev])
        if dev == "cuda":
            torch.cuda.synchronize()
        got = {k: counters[k].launches for k in keys}
        records = [json.loads(line) for line in pathlib.Path(
            "output/from_ckpt/runs/metrics.jsonl").read_text().splitlines()]
        losses = [r["train_geo_loss_tr"] + r["train_geo_loss_rot"]
                  for r in records if "train_geo_loss_tr" in r]
        restored = "restored weights only" in out
        log(f"[eval-cli] train --ckpt model.ckpt bf16 2 steps: exit {code}, "
            f"{'weights only restored' if restored else 'NOT RESTORED'}, "
            f"losses {losses}, kernel launches {got}")
        if code != 0 or not restored or not losses \
                or not np.isfinite(losses).all():
            failures.append("train --ckpt")
        failures += [f"train --ckpt: {k} never launched"
                     for k, v in got.items() if v <= 0]
    finally:
        os.chdir(cwd)
    log(f"[eval-cli] phase 7 in {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise SystemExit(f"eval CLI checks failed: {failures}")
    return launches


def eval_forward_ms(sd, device):
    """The CLI's forward alone: ``PosePredictor`` at batch 64 on uint8
    480x640 pairs, bf16, CUDA events over 3 calls after one."""
    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.infer import MATTERPORT_INTRINSICS, PosePredictor
    from rel_pose_tpu_torch.models.vitess import ViTEss
    if device.type != "cuda":
        return float("nan")
    model = ViTEss(ModelConfig(compute_dtype="bfloat16",
                               transformer_depth=EVAL_DEPTH), device=device)
    model.load_state_dict(sd)
    pred = PosePredictor(model, intrinsics=MATTERPORT_INTRINSICS,
                         batch_size=EVAL_THROUGHPUT_BATCH,
                         image_size=(384, 512))
    images = np.random.default_rng(SEED + 41).integers(
        0, 256, (EVAL_THROUGHPUT_BATCH, 2, 3, 480, 640), dtype=np.uint8)
    return cuda_time_ms(lambda: pred.predict_batch(images), 3)


def phase_eval_demo(dev, cfg, failures):
    """(7c) ``cli.demo`` on a ``.ckpt`` whose name holds ``matterport``
    (a 480x640 pair of the Matterport tree) and on one whose name does not
    (a 256x256 pair of the InteriorNet tree): the header and the 7 or 4
    numbers, equal as printed to ``PosePredictor``'s after the demo's
    conventions."""
    from rel_pose_tpu_torch.cli import demo
    from rel_pose_tpu_torch.data.base import image_read
    from rel_pose_tpu_torch.infer import (INTERIORNET_STREETLEARN_INTRINSICS,
                                          MATTERPORT_INTRINSICS,
                                          PosePredictor, matterport_demo_pose)
    cases = [("matterport_seeded.ckpt", "mp/imgs/p0_0.jpg",
              "mp/imgs/p0_1.jpg", True),
             ("seeded.ckpt", "inet/data/interiornet/s/0a.png",
              "inet/data/interiornet/s/0b.png", False)]
    for ckpt, img1, img2, is_mp in cases:
        shutil.copy("model.ckpt", ckpt)
        code, out = run_quiet(demo.main, [
            "--img1", img1, "--img2", img2, "--ckpt", ckpt, "--device", dev,
            "--transformer_depth", str(EVAL_DEPTH)])
        lines = out.strip().splitlines()
        pred = PosePredictor.from_checkpoint(
            ckpt, cfg, device=dev,
            intrinsics=(MATTERPORT_INTRINSICS if is_mp
                        else INTERIORNET_STREETLEARN_INTRINSICS),
            image_size=(384, 512) if is_mp else None)
        pose = pred.predict(image_read(img1), image_read(img2))[1]
        want = matterport_demo_pose(pose) if is_mp else pose[3:]
        with np.printoptions(suppress=True, precision=5):
            want = str(want)
        header = ("predicted R&t, as quaternion" if is_mp
                  else "predicted R, as quaternion")
        printed = " ".join(lines[2:])
        n = len(printed.replace("[", " ").replace("]", " ").split())
        ok = (code == 0 and lines[1].startswith(header)
              and printed == " ".join(want.splitlines())
              and n == (7 if is_mp else 4))
        log(f"[eval-cli] demo {ckpt}: {lines[1]} {printed} "
            f"({n} numbers; PosePredictor {want}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"demo {ckpt}")


def phase_eval_epipolar(dev, epi, failures):
    """(7d) ``cli.generate_epipolar_imgs`` in scratch working directories
    with ``demo/`` PNGs, on ``dev`` and on the CPU."""
    import cv2
    rng = np.random.default_rng(SEED + 42)
    images = [rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)
              for _ in range(2)]
    outs = {}
    for where in (dev, "cpu"):
        wd = pathlib.Path(f"epipolar_{where}")
        (wd / "demo").mkdir(parents=True, exist_ok=True)
        for i, img in enumerate(images, 1):
            cv2.imwrite(str(wd / "demo" / f"matterport_{i}.png"), img)
        os.chdir(wd)
        try:
            code, _ = run_quiet(epi.main, ["--device", where])
            outs[where] = [cv2.imread(epi.out_path1_points),
                           cv2.imread(epi.out_path2_lines)]
        finally:
            os.chdir("..")
        if code != 0 or any(o is None for o in outs[where]):
            failures.append(f"epipolar on {where}: exit {code}, PNGs "
                            f"{[o is not None for o in outs[where]]}")
            return
    a = np.array(epi.epipolar_lines((480, 640, 3), torch.device(dev)))
    b = np.array(epi.epipolar_lines((480, 640, 3), torch.device("cpu")))
    rel = np.abs(a[:, 2:] - b[:, 2:]) / np.abs(b[:, 2:])
    diff = [int((x != y).any(axis=-1).sum())
            for x, y in zip(outs[dev], outs["cpu"])]
    log(f"[eval-cli] epipolar on {dev}: both PNGs written; the 9 lines' "
        f"slopes and intercepts within {rel.max():.3e} relative of the "
        f"CPU's (bound 1e-5); PNGs against the CPU's: "
        + ", ".join("bit for bit" if d == 0 else f"{d} pixels differ"
                    for d in diff))
    if not rel.max() <= 1e-5:
        failures.append(f"epipolar lines {rel.max():.3e} relative")


def phase_eval_warmup(dev, card, failures):
    """(7e) ``PosePredictor.warmup()`` in a fresh process: bf16, batch 8,
    256x256 InteriorNet-style requests; its seconds, then the first
    requests of 1 and of 8 pairs, against a fresh process without it.  A
    child process each, so that the library load, cuDNN's plans and the
    allocator's first blocks are really cold (in this process phases 1-6
    made them); the kernels' nvcc build is on disk by now, as on a server
    restarted after its first start (phase 2 times the build)."""
    from rel_pose_tpu_torch.tools import child_env
    got = {}
    for mode in ("warm", "cold"):
        r = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--serve-child", mode, str(EVAL_DIR / "model.pth"), dev,
             str(EVAL_DEPTH)],
            env=child_env(), capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            failures.append(f"warm-up child {mode}: exit {r.returncode}")
            log(r.stdout[-2000:] + r.stderr[-2000:])
            return
        got[mode] = json.loads(r.stdout.strip().splitlines()[-1])
    w, c = got["warm"], got["cold"]
    log(f"[time] PosePredictor bf16 batch_size 8, 256x256, a fresh process "
        f"each: warmup() {w['warmup_s']:.3f} s, then the first request of "
        f"1 pair {1e3 * w['first_1_s']:.2f} ms and of 8 pairs "
        f"{1e3 * w['then_8_s']:.2f} ms; without warm-up "
        f"{1e3 * c['first_1_s']:.2f} ms and {1e3 * c['then_8_s']:.2f} ms "
        f"(loading the model {w['load_s']:.2f} / {c['load_s']:.2f} s; "
        f"{card})")


def serve_child(mode, pth, dev, depth):
    """A fresh process of (7e): load the flagship of ``depth`` blocks,
    ``warmup()`` if ``mode`` is ``warm``, then a request of 1 pair and one
    of 8; prints one JSON line of host-clock seconds (each request ends in
    its host copy)."""
    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.infer import (INTERIORNET_STREETLEARN_INTRINSICS,
                                          PosePredictor)
    rng = np.random.default_rng(SEED + 43)
    reqs = [rng.integers(0, 256, (n, 2, 3, 256, 256), dtype=np.uint8)
            for n in (1, 8)]
    t0 = time.perf_counter()
    pred = PosePredictor.from_checkpoint(
        pth, ModelConfig(compute_dtype="bfloat16",
                         transformer_depth=int(depth)), device=dev,
        intrinsics=INTERIORNET_STREETLEARN_INTRINSICS, batch_size=8)
    if dev == "cuda":
        torch.cuda.synchronize()
    out = {"load_s": time.perf_counter() - t0, "warmup_s": None}
    if mode == "warm":
        t0 = time.perf_counter()
        pred.warmup(256, 256)
        out["warmup_s"] = time.perf_counter() - t0
    for key, images in zip(("first_1_s", "then_8_s"), reqs):
        t0 = time.perf_counter()
        poses = pred.predict_batch(images)
        out[key] = time.perf_counter() - t0
        if not np.isfinite(poses).all():
            raise SystemExit(f"{key}: non-finite poses")
    print(json.dumps(out))
    return 0


# ------------------------------------------------- data parallelism (8) --

DDP_DEPTH = 6
DDP_BATCH = 8               # the global batch: 4 pairs a rank
DDP_STEPS = 3
DDP_DIR = OUTPUT_DIR / "chip_smoke_ddp"
# The two-rank step against one process on the union, BatchNorm running
# statistics after step 1, ||ddp - one|| / ||one|| per buffer: fp32 1e-5
# (the same sums split in two, as tests/test_torch_ddp.py's 2.2e-16 in
# float64), bf16 1e-2 (cuDNN may pick other algorithms at 4 pairs than at
# 8, so bf16 conv outputs, and what follows them, flip by an ulp).  The
# parameters after step 3: every element within DDP_STEP_BOUND sum(lr) of
# the single process's -- Adam moves an element by at most lr sqrt(sum_i
# a_i^2 / b_i) a step, a and b its moments' normalized weights (Cauchy-
# Schwarz): 1, 1.0014 and 1.0037 lr in steps 1-3, whatever the gradient,
# so one whose gradient is near 0 can step either way in both runs -- and
# the median leaf's update within DDP_UPDATE_MEDIAN of it in norm: fp32
# 1e-2, as
# tests/test_torch_train.py holds three steps against JAX's; bf16 0.5 --
# Adam's first steps move an element by about lr sign(g), and bf16's
# gradients differ by flips (cosine >= LEAF_COS), so every element whose
# gradient is within that noise steps either way (0.279 on the CPU's plain
# path at depth 2, where fp32 gives 3.8e-4).
DDP_BN_NORMREL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
DDP_UPDATE_MEDIAN = {torch.float32: 1e-2, torch.bfloat16: 0.5}
DDP_STEP_BOUND = 2 * 1.0037


def ddp_batches(device):
    """The 3 global batches of phase 8a, the same in every process."""
    rng = np.random.default_rng(SEED + 50)
    return [train_batch(rng, DDP_BATCH, device) for _ in range(DDP_STEPS)]


def ddp_state_dict():
    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.models.vitess import ViTEss
    from rel_pose_tpu_torch.nn.init import seeded_state_dict
    return seeded_state_dict(ViTEss(ModelConfig(transformer_depth=DDP_DEPTH),
                                    device="meta"), SEED)


def ddp_steps(dtype, sd, device, rank=0, world=1):
    """``DDP_STEPS`` ``train_step``s of the depth-``DDP_DEPTH`` flagship with
    the kernels on rank ``rank``'s contiguous shard of each global batch,
    under DDP when ``world`` > 1; the kernels' counters set to 0 just before
    the steps and read just after.  -> the step-1 loss, post-clip
    gradients and BatchNorm running statistics, the parameters after the
    last step, each step's host milliseconds (synchronized), the warnings
    the steps raised and, under DDP, the digest of the parameters and
    buffers after each step."""
    from rel_pose_tpu_torch import parallel
    from rel_pose_tpu_torch.train.step import train_step
    model, opt, sched = train_model(dtype, sd, device, True,
                                    transformer_depth=DDP_DEPTH)
    run = parallel.wrap_ddp(model, device) if world > 1 else model
    per = DDP_BATCH // world
    counters = kernel_counters()
    out = {"ms": [], "digests": [], "lrs": []}
    batches = ddp_batches(device)
    for c in counters.values():
        c.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for step, batch in enumerate(batches):
            local = tuple(t[rank * per:(rank + 1) * per] for t in batch)
            out["lrs"].append(opt.param_groups[0]["lr"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics, _ = train_step(run, opt, sched, *local)
            loss = metrics["loss"].item()
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            if step == 0:
                out["loss1"] = loss
                out["grads1"] = {n: p.grad.detach().cpu().clone()
                                 for n, p in model.named_parameters()}
                out["bn1"] = {k: v.detach().cpu().clone() for k, v in
                              model.state_dict().items() if "running" in k}
            if world > 1:
                out["digests"].append(parallel.state_digest(model))
    out["warnings"] = sorted({str(w.message) for w in caught})
    torch.cuda.synchronize()
    out["launches"] = {k: c.launches for k, c in counters.items()}
    out["params"] = {n: p.detach().cpu().clone()
                     for n, p in model.named_parameters()}
    return out


def ddp_child(rank, world, port, out_dir):
    """A rank of (8a): joins the gloo world of ``world`` ranks on the card
    (NCCL takes one GPU a rank; this host has one), runs
    :func:`ddp_steps` in fp32 and bf16 and saves what it returns (rank 0
    all of it, the others their loss, digests, launches and times)."""
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank,
                      MASTER_ADDR="localhost", MASTER_PORT=port)
    from rel_pose_tpu_torch import parallel
    device = parallel.init_distributed("cuda", backend="gloo")
    sd = ddp_state_dict()
    res = {}
    for dtype in DTYPES:
        r = ddp_steps(dtype, sd, device, int(rank), int(world))
        if rank != "0":
            r = {k: r[k] for k in ("loss1", "digests", "launches", "ms",
                                   "warnings")}
        res[str(dtype)[6:]] = r
    torch.save(res, pathlib.Path(out_dir) / f"rank{rank}.pt")
    parallel.shutdown()
    return 0


def wait_children(procs, label, timeout=600):
    """Wait for every child; a failing or hanging one fails the phase."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise SystemExit(f"{label}: a child did not end in {timeout} s")
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            log(out[-4000:])
            raise SystemExit(f"{label}: child {i} exit {p.returncode}")
    return outs


def phase_ddp_train(device, card):
    """(8a) two ranks over gloo on the one card, child processes of this
    script (``--ddp-child``), 3 DDP ``train_step``s of the depth-6 flagship
    with the kernels, fp32 and bf16, on 4 pairs a rank of 384x512 uint8
    Matterport-style batches, against this process's ``train_step`` on all
    8 pairs from the same seeded weights: the step-1 global loss
    (LOSS_RTOL), every parameter's step-1 gradient (``compare_leaves``; the
    trunk's leaves at TRUNK_LEAF_COS / TRUNK_LEAF_RATIO, the rest at
    LEAF_COS / LEAF_RATIO), the running statistics after step 1
    (DDP_BN_NORMREL), the parameters after step 3 (DDP_STEP_BOUND and
    DDP_UPDATE_MEDIAN); both ranks' parameters and buffers bit-identical
    after every step; each rank's #1, #2, #5 and #6 launched; no DDP
    stride warning (a gradient whose strides differ from its bucket view's
    would raise one every step).  -> the ranks' launches."""
    from rel_pose_tpu_torch.parallel.dist import free_port
    from rel_pose_tpu_torch.tools import child_env
    shutil.rmtree(DDP_DIR, ignore_errors=True)
    DDP_DIR.mkdir(parents=True)
    sd = ddp_state_dict()
    one = {str(d)[6:]: ddp_steps(d, sd, device) for d in DTYPES}
    torch.cuda.empty_cache()
    port = str(free_port())
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()),
         "--ddp-child", str(r), "2", port, str(DDP_DIR)],
        env=child_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    wait_children(procs, "8a")
    log(f"[ddp] two ranks, fp32 and bf16, {DDP_STEPS} steps each: "
        f"{time.perf_counter() - t0:.1f} s with the processes' start")
    ranks = [torch.load(DDP_DIR / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    failures, launches = [], {}
    for dtype in DTYPES:
        name = str(dtype)[6:]
        a, b, ref = ranks[0][name], ranks[1][name], one[name]
        same = a["digests"] == b["digests"] and len(a["digests"]) == \
            DDP_STEPS and a["loss1"] == b["loss1"]
        log(f"[ddp] {name}: the ranks' parameters and buffers after steps "
            f"1-{DDP_STEPS} {'bit-identical' if same else 'DIFFER'} "
            f"(sha256 {[d[:12] for d in a['digests']]})")
        if not same:
            failures.append(f"{name}: ranks differ")
        for r, res in enumerate((a, b)):
            launches[f"{name} rank {r}"] = res["launches"]
            if res["warnings"]:
                log(f"[ddp] {name} rank {r} warned: {res['warnings']}")
            if any("stride" in w for w in res["warnings"]):
                failures.append(f"{name} rank {r}: DDP's gradient strides")
            failures += [f"{name} rank {r}: {k} never launched"
                         for k, v in res["launches"].items() if v <= 0]
        rel = abs(a["loss1"] - ref["loss1"]) / abs(ref["loss1"])
        ok = rel <= LOSS_RTOL[dtype]
        log(f"[ddp] {name} step-1 global loss two ranks {a['loss1']:.6f} "
            f"one process {ref['loss1']:.6f} rel {rel:.3e} (<= "
            f"{LOSS_RTOL[dtype]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} step-1 loss")
        trunk = [n for n in ref["grads1"] if n.startswith(
            ("resnet.", "extractor_final_conv."))]
        gk, gp = a["grads1"], ref["grads1"]
        compare_leaves(dtype, {n: gk[n] for n in trunk},
                       {n: gp[n] for n in trunk}, failures,
                       label="ddp trunk", leaf_cos=TRUNK_LEAF_COS,
                       leaf_ratio=TRUNK_LEAF_RATIO)
        compare_leaves(dtype, {n: g for n, g in gk.items() if n not in trunk},
                       {n: g for n, g in gp.items() if n not in trunk},
                       failures, label="ddp rest")
        bn = max(normrel(a["bn1"][k], v) for k, v in ref["bn1"].items())
        ok = bn <= DDP_BN_NORMREL[dtype]
        log(f"[ddp] {name} running statistics after step 1, {len(ref['bn1'])}"
            f" buffers: max ||ddp - one|| / ||one|| {bn:.3e} (<= "
            f"{DDP_BN_NORMREL[dtype]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} running statistics")
        lr_sum = sum(ref["lrs"])
        worst, rels = 0.0, []
        for k, p in ref["params"].items():
            worst = max(worst, (a["params"][k] - p).abs().max().item())
            rels.append(normrel(a["params"][k] - sd[k], p - sd[k]))
        bound = DDP_STEP_BOUND * lr_sum
        ok = worst <= bound and np.median(rels) <= DDP_UPDATE_MEDIAN[dtype]
        log(f"[ddp] {name} parameters after step {DDP_STEPS}: max |ddp - "
            f"one| {worst:.3e} (<= {DDP_STEP_BOUND:.4f} sum(lr) = "
            f"{bound:.4e}); the "
            f"updates' ||ddp - one|| / ||one|| median leaf "
            f"{np.median(rels):.3e} (<= {DDP_UPDATE_MEDIAN[dtype]}), largest "
            f"{max(rels):.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} parameters after step {DDP_STEPS}")
        log(f"[time] {name} train_step, flagship depth {DDP_DEPTH}: two "
            f"ranks of 4 pairs on the one card over gloo "
            f"{np.mean(a['ms'][1:]):.1f} / {np.mean(b['ms'][1:]):.1f} ms, "
            f"one process of 8 pairs {np.mean(ref['ms'][1:]):.1f} ms (steps "
            f"2-{DDP_STEPS}, host clock; the ranks share one card and "
            f"all-reduce through host memory: not DDP's speed; {card})")
    shutil.rmtree(DDP_DIR, ignore_errors=True)
    if failures:
        raise SystemExit(f"8a checks failed: {failures}")
    return launches


def same_tree(a, b):
    """Two checkpoint trees equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same_tree, a, b))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def phase_ddp_cli(card):
    """(8b) ``cli.train`` as a world of one over NCCL (torchrun's variables
    set by hand: RANK=0, WORLD_SIZE=1), in this process, on phase 6's
    Matterport tree: the flagship bf16 at depth CLI_DEPTH, 2 steps at batch
    6, #1, #2, #5 and #6 launched; its step-2 checkpoint (weights, Adam,
    schedule) equal bit for bit to the same run's with ``--no_ddp``.  For
    the two runs to see the same batches, the augmentor draws from
    ``default_rng(SEED)`` (the CLI's is unseeded), one loader thread keeps
    its draws in order, and deterministic algorithms are on, as in phase
    4b.  -> the launches."""
    from rel_pose_tpu_torch import parallel
    from rel_pose_tpu_torch.cli import train as cli
    from rel_pose_tpu_torch.data import augmentation
    from rel_pose_tpu_torch.parallel.dist import free_port
    argv = ["--datapath", "mp", "--batch", "6", "--steps", "2",
            "--ckpt_every", "2", "--warmup", "1", "--num_workers", "1",
            "--dataset", "matterport", "--fusion_transformer",
            "--transformer_depth", str(CLI_DEPTH), "--compute_dtype",
            "bfloat16"]
    init = augmentation.RGBDAugmentor.__init__

    def seeded(self, reshape_size, rng=None, **kw):
        init(self, reshape_size, rng=np.random.default_rng(SEED), **kw)

    counters = kernel_counters()
    world = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
             "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
    cwd = os.getcwd()
    os.chdir(CLI_DIR)
    augmentation.RGBDAugmentor.__init__ = seeded
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        os.environ.update(world)
        for c in counters.values():
            c.launches = 0
        code, out = run_quiet(cli.main, ["--name", "world1"] + argv)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        m = re.search(r"devices: 1 \(cuda:\d+ on rank 0, (\w+)\)", out)
        backend = m.group(1) if m else "no group"
        for k in world:
            del os.environ[k]
        left = parallel.joined()
        code2, _ = run_quiet(cli.main, ["--name", "single", "--no_ddp"]
                             + argv)
        a, b = (torch.load(f"output/{n}/checkpoints/000002.pth",
                           weights_only=False) for n in ("world1", "single"))
    finally:
        for k in world:
            os.environ.pop(k, None)
        augmentation.RGBDAugmentor.__init__ = init
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        os.chdir(cwd)
    same = same_tree(a, b)
    log(f"[ddp] cli.train as a world of one over {backend} (RANK=0, "
        f"WORLD_SIZE=1), flagship bf16 depth {CLI_DEPTH}, 2 steps at batch "
        f"6: exit {code}, kernel launches {launches}, the group left "
        f"{not left}; --no_ddp exit {code2}; step-2 checkpoints (weights, "
        f"Adam, schedule) {'bit for bit' if same else 'DIFFER'}")
    failures = [f"8b: {k} never launched" for k, v in launches.items()
                if v <= 0]
    if code or code2 or left or not same or backend != "nccl":
        failures.append("8b: world of one against --no_ddp")
    if failures:
        raise SystemExit(f"8b checks failed: {failures}")
    return launches


def phase_ddp_eval():
    """(8c) ``python -m rel_pose_tpu_torch.cli.test_matterport`` as 2 ranks
    on the one card (torchrun's variables set by hand; the CLI's world is
    gloo), fp32, batch EVAL_CHECK_BATCH, on phase 7's 64 pairs from its
    ``model.ckpt``: the rows come back in rank-major order (pairs 0, 2,
    ..., 62, then 1, 3, ..., 63) and match phase 7's single-process rows
    pair for pair -- the ground-truth columns within 1e-3 (the gather
    carries float32, as the JAX CLI's), the errors within phase 7's fp32
    bounds -- and the metrics within 1e-4 degrees and 1e-4 m."""
    from rel_pose_tpu_torch.parallel.dist import free_port
    from rel_pose_tpu_torch.tools import child_env
    port = str(free_port())
    argv = ["--exp", "ddp2", "--datapath", "mp", "--ckpt", "model.ckpt",
            "--batch", str(EVAL_CHECK_BATCH), "--device", "cuda",
            "--fusion_transformer", "--transformer_depth", str(EVAL_DEPTH),
            "--compute_dtype", "float32"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rel_pose_tpu_torch.cli.test_matterport"]
        + argv, cwd=EVAL_DIR, env=child_env(
            RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
            MASTER_ADDR="localhost", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = wait_children(procs, "8c")
    shards = [next((line for line in out.splitlines()
                    if line.startswith(f"rank {r}/2")), "?")
              for r, out in enumerate(outs)]
    log(f"[ddp] cli.test_matterport as 2 ranks on the card: "
        f"{time.perf_counter() - t0:.1f} s; {shards}")
    failures = []
    one = EVAL_DIR / "output" / "float32_ckpt" / "matterport_test"
    two = EVAL_DIR / "output" / "ddp2" / "matterport_test"
    order = [i for r in range(2) for i in range(EVAL_ENTRIES)[r::2]]
    tol = {"gt_translation_magnitude_vs_error.csv": tran_err_tol(
        POSE_ATOL[torch.float32])}
    for name in ("gt_translation_magnitude_vs_error.csv",
                 "gt_rotation_magnitude_vs_error.csv"):
        want, got = csv(one / name)[order], csv(two / name)
        gt = np.abs(got[:, 0] - want[:, 0]).max()
        log(f"[ddp] 8c {name}: {len(got)} rows in rank-major order, ground "
            f"truth max |two - one| {gt:.3e} (<= 1e-3)")
        if len(got) != EVAL_ENTRIES or gt > 1e-3:
            failures.append(f"8c {name}: rows")
        check_err_column(f"8c {name}", got[:, 1], want[:, 1],
                         tol.get(name, rotation_err_tol(
                             want[:, 1], POSE_ATOL[torch.float32])),
                         failures, what="two ranks - one")
    a = dict(line.rsplit(" ", 1) for line in
             (one / "results.txt").read_text().strip().splitlines())
    b = dict(line.rsplit(" ", 1) for line in
             (two / "results.txt").read_text().strip().splitlines())
    gap = max(abs(float(a[k]) - float(b[k])) for k in a) \
        if a.keys() == b.keys() else float("inf")
    log(f"[ddp] 8c results.txt, {len(a)} metrics: max |two - one| "
        f"{gap:.3e} (<= 1e-4)")
    if gap > 1e-4:
        failures.append("8c metrics")
    if failures:
        raise SystemExit(f"8c checks failed: {failures}")


# ------------------------------------------------------------ the tooling --

TOOL_DIR = OUTPUT_DIR / "chip_smoke_tooling"
# 9e's steps: convergence_run's default of 330 lowered for this phase
# only, so that phase 9 fits its 120 s (the runs are bound by the host's
# loader; 330 steps took 121.5 s on an H100's host).  300 keeps the
# trajectory's four records, the last one the annealed tail's, well below
# the gates' tenth; at 280 fp32's tr came close to it.
CONV_STEPS = 300
CHECK_BATCH = 4             # tools.check_grads' default CHECK_BATCH


def trace_kernel_names(path):
    """The names of the device kernel events of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(
        events, dict) else events
    return {e.get("name", "") for e in events
            if isinstance(e, dict) and e.get("cat") == "kernel"}


def same_checkpoint(a, b):
    """Two checkpoint files hold equal tensors and equal other entries."""
    def eq(x, y):
        if torch.is_tensor(x):
            return (torch.is_tensor(y) and x.dtype == y.dtype
                    and torch.equal(x, y))
        if isinstance(x, dict):
            return (isinstance(y, dict) and list(x) == list(y)
                    and all(eq(x[k], y[k]) for k in x))
        if isinstance(x, (list, tuple)):
            return (isinstance(y, (list, tuple)) and len(x) == len(y)
                    and all(eq(p, q) for p, q in zip(x, y)))
        return x == y
    return eq(torch.load(a, weights_only=True),
              torch.load(b, weights_only=True))


def phase_tooling(device, card, eval_ms, train_bf16_ms):
    """(9) the tooling of ``rel_pose_tpu_torch/utils`` and ``tools``: 9e's
    two convergence runs and 9d's float64 reference start first, as child
    processes, and run beside 9a-9d.

    9a: the FLOPs a pair of the eval forward and the train step
    (``estimate_step_flops``); MFU of phase 5's eval forward (batch 256
    bf16) and of phase 5b's bf16 train step (batch 60); phase 6's CLI
    record at batch 60 carries an ``mfu`` equal to its pairs/s x FLOPs a
    pair / 989e12 within 1e-6 relative; every MFU in (0, 1).
    9b: ``trace(dir)`` around 2 eval forwards: the Chrome trace parses and
    holds device events of #1 (``tc::gemm_fwd_kernel``,
    ``tc::attn_fwd_kernel``) and #2 (``eb_moments_kernel``).
    9c: the flagship bf16 after 2 steps: ``save_checkpoint``, then
    ``AsyncCheckpointer.save`` and 2 more steps at once, then ``close()``:
    both files equal tensor by tensor; the training thread's ms in
    ``save()`` beside the synchronous save's.
    9d: ``tools.check_grads`` in fp32 and bf16 at batch 4 against one
    float64 reference: every leaf within the gates; top 5 leaves printed.
    9e: ``tools.convergence_run`` in fp32 and bf16 (CONV_STEPS steps),
    ``tools.convergence_run.gate`` on each trajectory.
    -> the in-process launches of #1, #2, #5 and #6 (9b-9d)."""
    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.models.vitess import ViTEss
    from rel_pose_tpu_torch.nn.init import seeded_state_dict
    from rel_pose_tpu_torch.tools import (check_grads, child_env,
                                          convergence_run)
    from rel_pose_tpu_torch.train import checkpoint
    from rel_pose_tpu_torch.train.optim import make_optimizer
    from rel_pose_tpu_torch.train.step import train_step
    from rel_pose_tpu_torch.utils.profiling import (H100_BF16_PEAK,
                                                    estimate_step_flops,
                                                    peak_flops, trace)
    t_phase = time.perf_counter()
    shutil.rmtree(TOOL_DIR, ignore_errors=True)
    TOOL_DIR.mkdir(parents=True)
    failures = []
    conv_root = TOOL_DIR / "convergence"
    convergence_run.prepare_tree(str(conv_root))
    conv = {}
    t_conv = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        out = open(TOOL_DIR / f"convergence_{dtype}.log", "w")
        conv[dtype] = (subprocess.Popen(
            [sys.executable, "-m", "rel_pose_tpu_torch.tools.convergence_run",
             "--dtype", dtype, "--root", str(conv_root), "--steps",
             str(CONV_STEPS)], env=child_env(), stdout=out,
            stderr=subprocess.STDOUT), out)
    ref_out = TOOL_DIR / "reference_grads.pt"
    ref_log = open(TOOL_DIR / "reference.log", "w")
    ref = subprocess.Popen(
        check_grads.reference_command(ref_out, CHECK_BATCH, device),
        env=child_env(), stdout=ref_log, stderr=subprocess.STDOUT)
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    try:
        # 9a: FLOPs and MFU
        t0 = time.perf_counter()
        cfg = ModelConfig(compute_dtype="bfloat16")
        eval_pair = estimate_step_flops(cfg, EVAL_BATCH, "eval") / EVAL_BATCH
        train_pair = (estimate_step_flops(cfg, TRAIN_BATCH, "train")
                      / TRAIN_BATCH)
        peak = peak_flops(device, "bfloat16")
        log(f"[tooling] 9a FLOPs a pair (matmul / conv, plain path counted "
            f"on the meta device in {time.perf_counter() - t0:.1f} s): eval "
            f"forward {eval_pair / 1e9:.6f} G, train step "
            f"{train_pair / 1e9:.6f} G; peak_flops() on this card: {peak}")
        mfus = {"eval forward bf16 batch 256 (phase 5)":
                eval_pair * EVAL_BATCH / (eval_ms * 1e-3) / H100_BF16_PEAK,
                "train step bf16 batch 60 (phase 5b)":
                train_pair * TRAIN_BATCH / (train_bf16_ms * 1e-3)
                / H100_BF16_PEAK}
        rec = next(r for r in cli_records("batch60") if "timed_steps" in r)
        want = rec["pairs_per_sec_per_chip"] * train_pair / H100_BF16_PEAK
        got = rec.get("mfu")
        ok = got is not None and abs(got - want) <= 1e-6 * want
        mfus["training CLI bf16 batch 60 (phase 6, logged)"] = got or 0.0
        for name, v in mfus.items():
            log(f"[tooling] 9a MFU {name}: {100 * v:.4f}% of "
                f"{H100_BF16_PEAK / 1e12:.0f} TFLOP/s ({card})")
        log(f"[tooling] 9a the CLI's logged mfu {got} against pairs/s x "
            f"FLOPs a pair / peak {want}: {'ok' if ok else 'FAIL'}")
        if peak != H100_BF16_PEAK or not ok:
            failures.append(f"9a peak {peak}, CLI mfu {got} vs {want}")
        failures += [f"9a MFU {k} = {v}" for k, v in mfus.items()
                     if not 0 < v < 1]

        # 9b: a device trace of 2 eval forwards
        sd = seeded_state_dict(ViTEss(cfg, device="meta"), SEED)
        model = ViTEss(cfg, device=device)
        model.load_state_dict(sd)
        rng = np.random.default_rng(SEED + 90)
        images = torch.from_numpy(rng.integers(
            0, 256, (8, 2, 3, 256, 256), dtype=np.uint8)).to(device)
        intr = torch.full((8, 2, 4), 128.0, device=device)
        with torch.inference_mode():
            model(images, intr)
            with trace(str(TOOL_DIR / "trace")) as prof:
                for _ in range(2):
                    model(images, intr)
        names = trace_kernel_names(prof.trace_path)
        found = {k: sorted(n for n in names if k in n)[:1] for k in (
            "tc::gemm_fwd_kernel", "tc::attn_fwd_kernel",
            "eb_moments_kernel")}
        log(f"[tooling] 9b trace {prof.trace_path} "
            f"({os.path.getsize(prof.trace_path)} bytes), {len(names)} "
            f"kernel names; #1 / #2 events: {found}")
        failures += [f"9b no {k} event" for k, v in found.items() if not v]
        del model, images

        # 9c: the asynchronous checkpoint
        model, opt, sched = train_model(torch.bfloat16, sd, device, True)
        batches = [train_batch(rng, SLICE_TRAIN_BATCH, device)
                   for _ in range(4)]
        for b in batches[:2]:
            train_step(model, opt, sched, *b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(str(TOOL_DIR / "sync.pth"), model, opt,
                                   sched)
        sync_ms = (time.perf_counter() - t0) * 1e3
        with checkpoint.AsyncCheckpointer() as writer:
            t0 = time.perf_counter()
            writer.save(str(TOOL_DIR / "async.pth"), model, opt, sched)
            stall_ms = (time.perf_counter() - t0) * 1e3
            for b in batches[2:]:
                train_step(model, opt, sched, *b)
            torch.cuda.synchronize()
        same = same_checkpoint(TOOL_DIR / "sync.pth", TOOL_DIR / "async.pth")
        size = os.path.getsize(TOOL_DIR / "sync.pth") / 1e6
        log(f"[tooling] 9c {size:.1f} MB checkpoint after 2 bf16 steps, 2 "
            f"more steps taken at once: the asynchronous file "
            f"{'equals' if same else 'DIFFERS FROM'} the synchronous one; "
            f"the training thread waits {stall_ms:.1f} ms in save() "
            f"against {sync_ms:.1f} ms for save_checkpoint ({card})")
        if not same:
            failures.append("9c asynchronous checkpoint")
        del model, opt, sched, batches

        # 9d: gradient triangulation against the float64 reference
        ref.wait(timeout=600)
        ref_log.close()
        grads, label = check_grads.reference_from_child(
            ref.returncode, ref_out, (TOOL_DIR / "reference.log").read_text(),
            CHECK_BATCH, device)
        log(f"[tooling] 9d reference: {label}")
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            ok = check_grads.check(dtype, CHECK_BATCH, device, grads,
                                   log=log)[0]
            log(f"[tooling] 9d {dtype}: {'ok' if ok else 'FAIL'} in "
                f"{time.perf_counter() - t0:.1f} s")
            if not ok:
                failures.append(f"9d triangulation {dtype}")
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        log(f"[tooling] kernel launches in 9b-9d: {launches}")
        failures += [f"{k} never launched in phase 9" for k, v in
                     launches.items() if v <= 0]

        # 9e: convergence through the training CLI
        log(f"[tooling] 9a-9d in {time.perf_counter() - t_phase:.1f} s")
        for dtype, (proc, out) in conv.items():
            proc.wait(timeout=900)
            out.close()
            log(f"[tooling] 9e {dtype} ended "
                f"{time.perf_counter() - t_conv:.1f} s after its start")
            text = (TOOL_DIR / f"convergence_{dtype}.log").read_text()
            if proc.returncode != 0:
                log(text[-4000:])
                failures.append(f"9e {dtype} exit {proc.returncode}")
                continue
            summary = convergence_run.parse_summary(text)
            _, rot, tr = convergence_run.read_trajectory(
                str(conv_root / "output" / f"conv_{dtype}"), "train")
            bad = convergence_run.gate(rot, tr)
            log(f"[tooling] 9e {dtype}, {summary['steps']} steps at batch "
                f"{summary['batch']}: rot {[round(v, 5) for v in rot]}, tr "
                f"{[round(v, 5) for v in tr]}, val rot "
                f"{summary['val_rot_final']} tr {summary['val_tr_final']}: "
                f"{'converged' if not bad else 'FAIL ' + '; '.join(bad)}")
            failures += [f"9e {dtype}: {b}" for b in bad]
    finally:
        for proc, out in list(conv.values()) + [(ref, ref_log)]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    log(f"[tooling] phase 9 in {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise SystemExit(f"tooling checks failed: {failures}")
    return launches


def main():
    if sys.argv[1:2] == ["--serve-child"]:
        return serve_child(*sys.argv[2:6])
    if sys.argv[1:2] == ["--ddp-child"]:
        return ddp_child(*sys.argv[2:6])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    # deterministic cuBLAS for the training slice's bitwise resume check
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = torch.device("cuda:0")
    card = phase_device()
    phase_build()
    phase_kernels(device)
    bwd_errs = phase_kernels_bwd(device)
    phase_kernels_mhsa(device)
    phase_kernels_variants(device)
    *bilinear_errs, bilinear_launches = phase_kernels_bilinear(device)
    variant_errs = phase_kernels_cross_variants(device)
    models, sd = make_models(device)
    eval_launches = phase_slice(device, models)
    launches = phase_train(device, sd)
    rows, eval_ms = phase_times(device, models, card)
    del models
    train_rows, synthetic_ms = phase_times_train(device, sd, card)
    rows.update(train_rows)
    del sd
    phase_nofusion(device, card)
    models, sd = make_models(device, noess=True)
    noess_eval, noess_train = phase_noess(device, models, sd)
    rows.update(phase_times_noess(device, models, sd, card))
    del models
    entry_launches = phase_entry_points(device)
    ablations = phase_ablations(device)
    rows.update(phase_times_variants(device, card))
    bench_rows, bench_launches = phase_times_bilinear(
        device, card, (bilinear_errs, variant_errs))
    rows.update(bench_rows)
    try:
        cli_launches = phase_cli(device, card, synthetic_ms)
        eval_cli_launches = phase_eval_cli(device, card)
        t_phase = time.perf_counter()
        ddp_launches = phase_ddp_train(device, card)
        ddp_launches["cli world of one"] = phase_ddp_cli(card)
        phase_ddp_eval()
        log(f"[ddp] phase 8 in {time.perf_counter() - t_phase:.1f} s")
        tool_launches = phase_tooling(device, card, eval_ms, synthetic_ms)
    finally:
        for d in (CLI_DIR, EVAL_DIR, DDP_DIR, TOOL_DIR):
            shutil.rmtree(d, ignore_errors=True)
    log(f"[check] backward kernels at G=16 / B=8, max |err|: "
        f"{ {f'{k} {str(d)[6:]}': v for (k, d), v in bwd_errs.items()} }")
    log(f"[slice] eval launches {eval_launches}, training launches "
        f"{launches}, the training CLI's launches {cli_launches}, the "
        f"eval CLIs' (per run) {eval_cli_launches}")
    log(f"[noess] eval launches {noess_eval}, training launches "
        f"{noess_train}")
    log(f"[ddp] launches per rank {ddp_launches}")
    log(f"[tooling] launches in phase 9 (9b-9d, in this process) "
        f"{tool_launches}")
    for flag, (serve, train) in ablations.items():
        log(f"[ablation {flag}] eval launches {serve}, training launches "
            f"{train}")
    launches.update({k: noess_train[k] for k in ("mhsa_fwd", "mhsa_bwd")})
    launches.update({k: entry_launches[k] for k in ("essential_block",
                                                    "essential_block_x")})
    launches.update(bilinear_launches)
    launches.update(bench_launches)
    sources = {
        "vit_stack": ("rel_pose_tpu_torch/csrc/vit_stack.cu",
                      "rel_pose_tpu/ops/pallas_vit.py:94"),
        "vit_stack_bwd": ("rel_pose_tpu_torch/csrc/vit_stack.cu",
                          "rel_pose_tpu/ops/pallas_vit_bwd.py:149"),
        "essential_block_pair": (
            "rel_pose_tpu_torch/csrc/essential_block.cu",
            "rel_pose_tpu/ops/pallas_essential_block.py:225"),
        "essential_block_bwd": (
            "rel_pose_tpu_torch/csrc/essential_block_bwd.cu",
            "rel_pose_tpu/ops/pallas_essential_block_bwd.py:35"),
        "mhsa_fwd": ("rel_pose_tpu_torch/csrc/attention_tc.cuh",
                     "rel_pose_tpu/ops/pallas_attention.py:53"),
        "mhsa_bwd": ("rel_pose_tpu_torch/csrc/attention_tc.cuh",
                     "rel_pose_tpu/ops/pallas_attention.py:69"),
        "essential_block": ("rel_pose_tpu_torch/csrc/essential_block.cu",
                            "rel_pose_tpu/ops/pallas_essential_block.py:213"),
        "essential_block_x": (
            "rel_pose_tpu_torch/csrc/essential_block.cu",
            "rel_pose_tpu/ops/pallas_essential_block.py:257"),
        "bilinear_fwd": ("rel_pose_tpu_torch/csrc/bilinear.cu",
                         "rel_pose_tpu/ops/pallas_essential.py:72"),
        "bilinear_bwd": ("rel_pose_tpu_torch/csrc/bilinear_bwd.cu",
                         "rel_pose_tpu/ops/pallas_essential.py:100"),
        "essential_block_s": ("rel_pose_tpu_torch/csrc/cross_variants.cu",
                              "scripts/bench_cross.py:88"),
        "essential_block_variant": (
            "rel_pose_tpu_torch/csrc/cross_variants.cu",
            "scripts/bench_cross.py:35"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        err, ms, plain_ms, lib_ms, (b_ms, b_by) = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms})
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
