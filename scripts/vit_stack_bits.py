#!/usr/bin/env python3
"""Digests of the ViT stack kernels' outputs, to compare two trees' bits.

    python3 scripts/vit_stack_bits.py [--tree DIR]

Imports ``rel_pose_tpu_torch`` from ``DIR`` (this checkout by default), runs
kernel #1 (``_launch_forward``, with and without the stash) and #5
(``fused_vit_stack_bwd``) on seeded inputs at the model's widths (G = 16
sequences of 576 tokens, C = 192, 3 heads, depth 5) on one GPU, in fp32 and
bf16, and prints one line per (dtype, output) with the sha256 of the
output's bytes.  Where two trees run the same kernels (fp32's SIMT kernels
since the port began), they print the same digests on one card.  Needs a
CUDA device.
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
