#!/usr/bin/env python3
"""Readings of the essential block's kernels #2 and #6 (or, with
``--bilinear``, #8 and #9) in one tree, to compare two trees on one GPU.

    python3 scripts/ab_essential.py [--tree DIR] [--dtype float32|bfloat16]
                                    [--no-step] [--eval] [--bilinear]

Imports ``rel_pose_tpu_torch`` from ``DIR`` (this checkout by default) and
``chip_smoke.py`` from this checkout, builds DIR's kernels, and in the
dtype (float32 by default) checks and times #2 (``fused_essential_block_
pair``, the flagship's flags) at batch 256, the eval shape, and #6
(``fused_essential_block_bwd``) at batch 60, the training shape, each
beside its plain version and with its bound (operations over 165 TFLOP/s
in fp32, 989 in bf16, or bytes over 3.35 TB/s); then each kernel's parts
from ``torch.profiler`` (``chip_smoke.essential_part``), and #3, #4 and
#9's ``essential_block_s`` (S = 2) on #2's pairs, each checked against
its plain version and timed; then, unless
``--no-step``, the flagship's train step at batch 60 in that dtype with
the kernels and on the plain path (``chip_smoke.time_train_steps``); with
``--eval``, the flagship's eval forward with the kernels at batch 256
(``scripts/ab_vit_stack.eval_forward_ms``).  The parts are those of the
body the tree runs (``chip_smoke.essential_part``): in fp32 since the
TF32 wgmma body the key statistics, the one-walk moments, the qkv GEMM on
``gemm_wgmma_f32.cuh`` and its weight split, then the query and key
statistics, the prologue, the merged rho / gamma pass and the two
gradient passes; in bf16 since its wgmma body the same, the qkv GEMM on
``gemm_wgmma.cuh`` (the single softmax's "query maxima" in place of the
key statistics).  With
``--bilinear`` the kernel readings are #8's instead (the per-head bilinear
op, ``fused_bilinear_attention``: forward at G = 1,536 slices, the eval
shape, backward at G = 360, the training shape, e = 70, va = vb) and #9's
``essential_block_s`` (S = 2) at batch 256, each checked against its plain
version, timed beside it, with its bound and the TFLOP/s of the function's
products, and #8's parts.  Run it in turns on one card, the other tree,
this one, this one, the other.  Needs a CUDA device.
"""

import argparse
import importlib
import importlib.util
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def readings(cs, device, card, dtype):
    """#2 at batch 256 and #6 at batch 60 in ``dtype``: checked against the
    plain versions (chip_smoke's tolerances), timed beside them, by part."""
    from rel_pose_tpu_torch.nn.layers import layernorm
    from rel_pose_tpu_torch.ops import essential_block as te
    name, failures = str(dtype)[6:], []
    B = cs.EVAL_BATCH
    rng = np.random.default_rng(cs.SEED + 20)
    args = cs.essential_inputs(rng, B, dtype, device)
    xpair, ln, qkvp, positional = args
    f = te.fused_essential_block_pair(*args, 3)
    cs.check_f(f"essential_block_pair B={B}", f,
               te.essential_block_pair_reference(*args, 3), dtype, failures)
    ms = cs.cuda_time_ms(lambda: te.fused_essential_block_pair(*args, 3), 3)
    plain = cs.cuda_time_ms(
        lambda: te.essential_block_pair_reference(*args, 3), 3)
    small = sum(t.numel() for t in (*ln, *qkvp, positional))
    b = cs.bound(cs.essential_fwd_flops(B, 576, 192, 3),
                 cs.nbytes(xpair, f) + xpair.element_size() * small, dtype)
    cs.log(f"[ab] essential_block_pair {name} batch {B}: kernel {ms:.3f} "
           f"ms, plain {plain:.3f} ms, bound {b[0]:.3f} ms ({b[1]}) "
           f"({card})")
    cs.log_essential_parts(
        f"essential_block_pair {name} B={B}", cs.profile_parts_ms(
            lambda: te.fused_essential_block_pair(*args, 3),
            cs.essential_part, once=True),
        cs.essential_executed(B, 576, 70, False, False, dtype=dtype), card)
    # #3, #4 and #9's s (S = 2) on the same pairs, each checked and timed
    (x1, x2), (q1, q2), _ = cs.split_pair(xpair, ln, qkvp)
    from rel_pose_tpu_torch.ops import cross_variants as cv
    for label, kernel, plain in (
            ("essential_block_x", lambda: te.fused_essential_block_x(
                x1, x2, qkvp, positional, 3),
             lambda: te.essential_block_x_reference(x1, x2, qkvp,
                                                    positional, 3)),
            ("essential_block", lambda: te.fused_essential_block(
                q1, q2, positional, 3),
             lambda: te.essential_block_reference(q1, q2, positional, 3)),
            ("essential_block_s S=2", lambda: cv.essential_block_s(
                q1, q2, positional, 2),
             lambda: te.essential_block_reference(q1, q2, positional, 3))):
        cs.check_f(f"{label} B={B}", kernel(), plain(), dtype, failures)
        ms = cs.cuda_time_ms(kernel, 3)
        cs.log(f"[ab] {label} {name} batch {B}: kernel {ms:.3f} ms "
               f"({card})")
    del args, f, xpair, x1, x2, q1, q2

    B = cs.TRAIN_BATCH
    xpair, ln, qkvp, pos = cs.essential_inputs(rng, B, dtype, device)
    qkv = te.linear_rounded(layernorm(xpair, *ln), *qkvp)
    pos = pos.to(dtype)
    df = torch.from_numpy((0.1 * rng.standard_normal(
        (B, 2, 3, 70, 70))).astype(np.float32)).to(device)
    dq, dp = te.fused_essential_block_bwd(qkv, pos, df, 3)
    rq, rp = te.essential_block_bwd_reference(qkv, pos, df, 3)
    cs.check_grad(f"essential_block_bwd dqkv B={B}", dq, rq, dtype, failures)
    cs.check_grad(f"essential_block_bwd dpos B={B}", dp, rp, dtype, failures)
    del rq, rp
    ms = cs.cuda_time_ms(lambda: te.fused_essential_block_bwd(qkv, pos, df,
                                                              3), 3)
    plain = cs.cuda_time_ms(
        lambda: te.essential_block_bwd_reference(qkv, pos, df, 3), 2)
    b = cs.bound(cs.essential_bwd_flops(B, 576, 3),
                 2 * cs.nbytes(qkv) + cs.nbytes(pos, df, dp), dtype)
    cs.log(f"[ab] essential_block_bwd {name} batch {B}: kernel {ms:.3f} ms, "
           f"plain {plain:.3f} ms, bound {b[0]:.3f} ms ({b[1]}) ({card})")
    cs.log_essential_parts(
        f"essential_block_bwd {name} B={B}", cs.profile_parts_ms(
            lambda: te.fused_essential_block_bwd(qkv, pos, df, 3),
            cs.essential_part, once=True),
        cs.essential_executed(B, 576, 70, False, True, dtype=dtype), card)
    if failures:
        raise SystemExit(f"ab_essential checks failed: {failures}")


def bilinear_readings(cs, device, card, dtype):
    """#8's forward at G = 1,536 and backward at G = 360, #9's s (S = 2) at
    batch 256, in ``dtype``: checked against the plain versions
    (chip_smoke's tolerances), timed beside them, #8 by part."""
    from rel_pose_tpu_torch.ops import bilinear as tb
    from rel_pose_tpu_torch.ops import cross_variants as cv
    from rel_pose_tpu_torch.ops import essential_block as te
    name, failures = str(dtype)[6:], []
    rng = np.random.default_rng(cs.SEED + 22)

    def reading(label, kernel, plain, flops, nb, plain_iters=3):
        ms = cs.cuda_time_ms(kernel, 3)
        plain_ms = cs.cuda_time_ms(plain, plain_iters)
        b = cs.bound(flops, nb, dtype)
        rate = flops / ms / 1e9
        cs.log(f"[ab] {label} {name}: kernel {ms:.3f} ms, plain "
               f"{plain_ms:.3f} ms, bound {b[0]:.3f} ms ({b[1]}); {rate:.2f} "
               f"TFLOP/s of the function's products, "
               f"{rate * 1e12 / cs.PEAK_FLOPS[dtype]:.1%} of the peak "
               f"({card})")

    B = cs.EVAL_BATCH
    G = 2 * B * 3
    q, k, va, vb, _ = cs.bilinear_inputs(rng, G, 70, dtype, device, True)
    f = tb.fused_bilinear_attention(q, k, va, vb, 0.125)
    cs.check_f(f"bilinear G={G} F", f, tb.bilinear_attention_reference(
        q, k, va, vb, 0.125), dtype, failures)
    reading(f"bilinear_fwd G={G}",
            lambda: tb.fused_bilinear_attention(q, k, va, vb, 0.125),
            lambda: tb.bilinear_attention_reference(q, k, va, vb, 0.125),
            cs.moments_fwd_flops(B, 576, 3), cs.nbytes(q, k, vb, f))
    executed = cs.essential_executed(B, 576, 70, False, False, dtype=dtype)
    del executed["qkv GEMM"]
    cs.log_essential_parts(f"bilinear_fwd {name} G={G}", cs.profile_parts_ms(
        lambda: tb.fused_bilinear_attention(q, k, va, vb, 0.125),
        cs.essential_part, once=True), executed, card)
    del q, k, va, vb, f

    B = cs.TRAIN_BATCH
    G = 2 * B * 3
    q, k, va, vb, df = cs.bilinear_inputs(rng, G, 70, dtype, device, True)
    grads = tb.fused_bilinear_attention_bwd(q, k, va, vb, df, 0.125)
    ref = tb.bilinear_attention_bwd_reference(q, k, va, vb, df, 0.125)
    for part, g, r in zip(("dq", "dk", "dva", "dvb"), grads, ref):
        cs.check_grad(f"bilinear_bwd {part} G={G}", g, r, dtype, failures)
    del ref
    reading(f"bilinear_bwd G={G}",
            lambda: tb.fused_bilinear_attention_bwd(q, k, va, vb, df, 0.125),
            lambda: tb.bilinear_attention_bwd_reference(q, k, va, vb, df,
                                                        0.125),
            cs.essential_bwd_flops(B, 576, 3),
            2 * cs.nbytes(q, k, vb) + cs.nbytes(df, *grads), plain_iters=2)
    cs.log_essential_parts(f"bilinear_bwd {name} G={G}", cs.profile_parts_ms(
        lambda: tb.fused_bilinear_attention_bwd(q, k, va, vb, df, 0.125),
        cs.essential_part, once=True),
        cs.essential_executed(B, 576, 70, False, True, dtype=dtype), card)
    del q, k, va, vb, df, grads

    B = cs.EVAL_BATCH
    bench = importlib.import_module("scripts.bench_cross_torch")
    a, b_, p = (t.to(dtype) for t in bench.make_inputs(B, device,
                                                       cs.SEED + 17))
    f = cv.essential_block_s(a, b_, p, 2)
    cs.check_f(f"essential_block_s S=2 B={B}", f,
               te.essential_block_reference(a, b_, p, 3), dtype, failures)
    reading(f"essential_block_s S=2 batch {B}",
            lambda: cv.essential_block_s(a, b_, p, 2),
            lambda: te.essential_block_reference(a, b_, p, 3),
            cs.moments_fwd_flops(B, 576, 3), cs.nbytes(a, b_, p, f))
    if failures:
        raise SystemExit(f"ab_essential checks failed: {failures}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--no-step", action="store_true")
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--bilinear", action="store_true",
                    help="#8 and #9 in place of #2 and #6")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_essential: no CUDA device", file=sys.stderr)
        return 1
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import rel_pose_tpu_torch
    where = pathlib.Path(rel_pose_tpu_torch.__file__).resolve()
    if tree not in where.parents:
        raise SystemExit(f"rel_pose_tpu_torch from {where}, not {tree}")
    cs.log(f"[ab] tree {tree}")
    dtype = getattr(torch, args.dtype)
    device = torch.device("cuda:0")
    card = cs.phase_device()
    cs.phase_build()
    (bilinear_readings if args.bilinear else readings)(cs, device, card,
                                                        dtype)
    if not args.no_step:
        _, sd = cs.make_models(device)
        cs.time_train_steps(device, sd, card, dtypes=(dtype,))
    if args.eval:
        importlib.import_module("scripts.ab_vit_stack").eval_forward_ms(
            cs, device, dtype, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
