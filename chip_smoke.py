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

The line before the last is the card's name and power limit; the last is
``{"ok": true, "device": {...}}``; the one before the card's line is the
``{"kernels": [...]}`` line of all twelve kernels.  Checkpoints go to
``output/`` beside this file.  The run needs no network and starts no
process besides ``nvidia-smi`` and ``nvcc``, which it waits for.
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
    for kernels in (True, False):
        model = models[dtype, kernels]
        with torch.inference_mode():
            ms = cuda_time_ms(lambda: model(images, intr), 3)
        log(f"[time] eval forward bf16 batch {B} 256x256 uint8 "
            f"({'kernels' if kernels else 'plain path'}): {ms:.3f} ms, "
            f"{B / ms * 1e3:.2f} pairs/s ({card})")
    return rows


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


def compare_leaves(dtype, grads, plain, failures, label="train"):
    """Per-parameter cosine and norm ratio of the kernel path's step-1
    gradient against the plain path's."""
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
            if cos < LEAF_COS[dtype] or ratio > LEAF_RATIO[dtype]:
                bad.append(f"{name} cos {cos:.6f} ratio {gn / rn:.4f}")
    log(f"[{label}] {str(dtype)[6:]} step-1 gradients, {len(grads)} "
        f"leaves: min cosine {worst_cos:.6f} (>= {LEAF_COS[dtype]}), max "
        f"|norm ratio - 1| {worst_ratio:.3e} (<= {LEAF_RATIO[dtype]}) "
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
    for dtype in DTYPES:
        for kernels in (True, False):
            model, opt, sched = train_model(dtype, sd, device, kernels)
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_time_ms(lambda: train_step(model, opt, sched, *batch),
                              3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"[time] train step {str(dtype)[6:]} batch {B} 384x512 uint8 "
                f"({'kernels' if kernels else 'plain path'}): {ms:.3f} ms, "
                f"{B / ms * 1e3:.2f} pairs/s, peak {peak:.2f} GiB ({card})")
            del model, opt, sched
    return rows


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


def main():
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
    rows = phase_times(device, models, card)
    del models
    rows.update(phase_times_train(device, sd, card))
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
    log(f"[check] backward kernels at G=16 / B=8, max |err|: "
        f"{ {f'{k} {str(d)[6:]}': v for (k, d), v in bwd_errs.items()} }")
    log(f"[slice] eval launches {eval_launches}, training launches "
        f"{launches}")
    log(f"[noess] eval launches {noess_eval}, training launches "
        f"{noess_train}")
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
