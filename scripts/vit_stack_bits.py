#!/usr/bin/env python3
"""Digests of the ViT stack kernels' outputs and of #2, #3, #4, #6, #7, #8
and #9's, in fp32 and bf16, to compare two trees' bits.

    python3 scripts/vit_stack_bits.py [--tree DIR]

Imports ``rel_pose_tpu_torch`` from ``DIR`` (this checkout by default), runs
kernel #1 (``_launch_forward``, with and without the stash) and #5
(``fused_vit_stack_bwd``) on seeded inputs at the model's widths (G = 16
sequences of 576 tokens, C = 192, 3 heads, depth 5) on one GPU, in fp32 and
bf16, kernel #7 (``fused_mhsa``, ``fused_mhsa_bwd``) in fp32 and bf16 at
G = 24 heads of N = 100 and 576, the essential block's #2
(``fused_essential_block_pair``), #3 (``fused_essential_block_x``), #4
(``fused_essential_block``) and #6
(``fused_essential_block_bwd``) in fp32 and bf16 at B = 4 pairs of N = 576
for each of the 8 flag sets, #8 (``fused_bilinear_attention`` and its
backward) in fp32 and bf16 at G = 24 slices of N = 576 for e in {70, 64}
and both softmaxes, and #9's ``essential_block_s`` (S = 2, 4, B = 4) in
both dtypes and ``essential_block_variant`` (mxu_sums, bf16_mul) in bf16,
and prints one line per (dtype, output) with the sha256 of the output's
bytes.  Where two trees run the same kernels (every kernel here uses no
atomics and sums in a fixed order), they print the same digests on one
card.  A kernel whose sums move changes its digests by design: the fp32
ViT stack's (forward, forward with the stash, backward) moved when its
products went from SIMT FMAs to 3xTF32 on the tensor cores, and fp32 #2,
#4, #6, #7, #8 and #9's when they did; the bf16 ViT stack's and #7's
when their attention moved from mma.sync to wgmma, and the stack's again
when its GEMMs did; fp32 #2, #3, #4 and #6's when they moved to TF32
wgmma (one online-max walk, one rho / gamma pass); bf16 #2, #3, #4, #6
and #9's s and fp32 #9's s when they moved to wgmma (s now gives #4's
bits in both dtypes).
Needs a CUDA device.
"""

import argparse
import hashlib
import pathlib
import sys

import numpy as np
import torch

G, N, C, HEADS, HIDDEN, DEPTH = 16, 576, 192, 3, 768, 5


def inputs(dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(device)
    stacked = {
        "ln1_scale": 1 + t((DEPTH, C), 0.1), "ln1_bias": t((DEPTH, C), 0.1),
        "qkv_w": t((DEPTH, 3 * C, C), C ** -0.5),
        "qkv_b": t((DEPTH, 3 * C), 0.1),
        "proj_w": t((DEPTH, C, C), C ** -0.5), "proj_b": t((DEPTH, C), 0.1),
        "ln2_scale": 1 + t((DEPTH, C), 0.1), "ln2_bias": t((DEPTH, C), 0.1),
        "fc1_w": t((DEPTH, HIDDEN, C), C ** -0.5),
        "fc1_b": t((DEPTH, HIDDEN), 0.1),
        "fc2_w": t((DEPTH, C, HIDDEN), HIDDEN ** -0.5),
        "fc2_b": t((DEPTH, C), 0.1)}
    x = t((G, N, C), 1.0).to(dtype)
    pos = t((1, N, C), 0.02).to(dtype)
    g = t((G, N, C), 1.0).to(dtype)
    return x, {k: v.to(dtype) for k, v in stacked.items()}, pos, g


def digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(
        pathlib.Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vit_stack_bits: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.tree)
    from rel_pose_tpu_torch.ops import vit_stack as tv
    device = torch.device("cuda:0")
    for dtype in (torch.float32, torch.bfloat16):
        x, stacked, pos, g = inputs(dtype, device)
        out = tv._launch_forward(x, stacked, HEADS, pos, stash=False)[0]
        out2, xs = tv._launch_forward(x, stacked, HEADS, pos, stash=True)
        dx, grads = tv.fused_vit_stack_bwd(xs, g, stacked, HEADS)
        torch.cuda.synchronize()
        name = str(dtype)[6:]
        print(f"[bits] {name} forward {digest(out)}")
        print(f"[bits] {name} forward+stash {digest(out2, xs)}")
        print(f"[bits] {name} backward {digest(dx, *grads.values())}")
    from rel_pose_tpu_torch.ops import attention as ta
    for dtype in (torch.float32, torch.bfloat16):
        for n in (100, 576):
            rng = np.random.default_rng(1)
            q, k, v, do = (torch.from_numpy(rng.standard_normal(
                (24, n, 64)).astype(np.float32)).to(device, dtype)
                for _ in range(4))
            o = ta.fused_mhsa(q, k, v, 0.125)
            grads = ta.fused_mhsa_bwd(q, k, v, do, 0.125)
            torch.cuda.synchronize()
            print(f"[bits] {str(dtype)[6:]} mhsa N={n} forward {digest(o)} "
                  f"backward {digest(*grads)}")
    essential_bits(device)
    bilinear_bits(device)
    return 0


def essential_bits(device, B=4):
    """#2, #3 (the pair's raw tokens as its normed input), #4 and #6
    digests for every (positions, cross, single), fp32 and bf16 (the same
    draws, rounded)."""
    from rel_pose_tpu_torch.ops import essential_block as te
    rng = np.random.default_rng(2)

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(device)
    xpair = t((B, 2, N, C))
    ln = (1 + t((C,), 0.1), t((C,), 0.1))
    qkvp = (t((3 * C, C), C ** -0.5), t((3 * C,), 0.1))
    positional = t((B, N, 6))
    qkv = t((B, 2, N, 3 * C))
    dfs = {e: t((B, 2, HEADS, e, e), 0.1) for e in (70, 64)}
    for dtype in (torch.float32, torch.bfloat16):
        x, qk = xpair.to(dtype), qkv.to(dtype)
        q1, q2 = qk[:, 0].contiguous(), qk[:, 1].contiguous()
        x1, x2 = x[:, 0].contiguous(), x[:, 1].contiguous()
        for has_pos in (True, False):
            e = 64 + 6 * has_pos
            pos = positional if has_pos else None
            for cross in (False, True):
                for single in (False, True):
                    kw = {"cross_features": cross,
                          "use_single_softmax": single}
                    f = te.fused_essential_block_pair(x, ln, qkvp, pos,
                                                      HEADS, **kw)
                    f3 = te.fused_essential_block_x(x1, x2, qkvp, pos, HEADS,
                                                    **kw)
                    f4 = te.fused_essential_block(q1, q2, pos, HEADS, **kw)
                    dq, dp = te.fused_essential_block_bwd(qk, pos, dfs[e],
                                                          HEADS, **kw)
                    torch.cuda.synchronize()
                    grads = [dq] if dp is None else [dq, dp]
                    print(f"[bits] {str(dtype)[6:]} essential "
                          f"pos={int(has_pos)} cross={int(cross)} "
                          f"single={int(single)} pair {digest(f)} x "
                          f"{digest(f3)} block {digest(f4)} backward "
                          f"{digest(*grads)}")


def bilinear_bits(device, G=24, B=4):
    """#8 (forward, backward; va != vb) and #9 ``essential_block_s``
    digests in fp32 and bf16 (the same draws, rounded), and #9's bf16
    modes."""
    from rel_pose_tpu_torch.ops import bilinear as tb
    from rel_pose_tpu_torch.ops import cross_variants as cv
    rng = np.random.default_rng(3)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(device)
    draws = {e: (t(G, N, 64), t(G, N, 64), t(G, N, e), t(G, N, e),
                 t(G, e, e, scale=0.1)) for e in (70, 64)}
    pair = t(B, N, 3 * C), t(B, N, 3 * C), t(B, N, 6)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for e, (q, k, va, vb, df) in draws.items():
            q, k, va, vb = (x.to(dtype) for x in (q, k, va, vb))
            for single in (False, True):
                f = tb.fused_bilinear_attention(q, k, va, vb, 0.125, single)
                grads = tb.fused_bilinear_attention_bwd(q, k, va, vb, df,
                                                        0.125, single)
                torch.cuda.synchronize()
                print(f"[bits] {name} bilinear e={e} single={int(single)} "
                      f"forward {digest(f)} backward {digest(*grads)}")
        q1, q2, pos = (x.to(dtype) for x in pair)
        for S in (2, 4):
            f = cv.essential_block_s(q1, q2, pos, S)
            torch.cuda.synchronize()
            print(f"[bits] {name} essential_block_s S={S} {digest(f)}")
    q1, q2, pos = (x.to(torch.bfloat16) for x in pair)
    for mode in ("mxu_sums", "bf16_mul"):
        f = cv.essential_block_variant(q1, q2, pos, mode)
        torch.cuda.synchronize()
        print(f"[bits] bfloat16 essential_block_variant {mode} {digest(f)}")


if __name__ == "__main__":
    sys.exit(main())
