#!/usr/bin/env python3
"""Microbenchmark of the essential block's moments kernel variants on one
NVIDIA GPU: the PyTorch port's counterpart of ``scripts/bench_cross.py``.

    python3 scripts/bench_cross_torch.py
    BENCH_BATCH=256 BENCH_ITERS=30 BENCH_ALL=1 \
        python3 scripts/bench_cross_torch.py

Seeded bf16 inputs at the flagship's shapes (``BENCH_BATCH`` pairs, N = 576
tokens, C = 192, 3 heads of 64, a positional table) go through #4,
``fused_essential_block`` (``current(dual)``), and the variants of
``rel_pose_tpu_torch/ops/cross_variants.py``: ``s2`` and ``s4``
(``essential_block_s``, 2 and 4 pairs per CUDA block); with ``BENCH_ALL``
set also ``single_softmax`` (#4 with ``use_single_softmax``), ``mxu_sums``
and ``bf16_mul`` (``essential_block_variant``).  Each case is timed with
CUDA events over ``BENCH_ITERS`` calls after one warm-up; the script prints
one ``name: ms`` line per case, then the card's name and power limit as
``nvidia-smi`` gives them.  No parity check beyond the kernels' own
(``chip_smoke.py`` phase 3f holds them to their plain versions).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

N, C, HEADS = 576, 192, 3


def make_inputs(B, device, seed=0):
    """bf16 qkv1, qkv2 (B, N, 3C) and the (B, N, 6) table, from ``seed``."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device, torch.bfloat16)
        for shape in ((B, N, 3 * C), (B, N, 3 * C), (B, N, 6)))


def cases(include_all):
    """(name, fn(qkv1, qkv2, pos)) of bench_cross.py's cases."""
    from rel_pose_tpu_torch.ops.cross_variants import (essential_block_s,
                                                       essential_block_variant)
    from rel_pose_tpu_torch.ops.essential_block import fused_essential_block
    out = [("current(dual)", lambda a, b, p: fused_essential_block(
               a, b, p, HEADS)),
           ("s2", lambda a, b, p: essential_block_s(a, b, p, 2)),
           ("s4", lambda a, b, p: essential_block_s(a, b, p, 4))]
    if include_all:
        out += [("single_softmax", lambda a, b, p: fused_essential_block(
                    a, b, p, HEADS, use_single_softmax=True)),
                ("mxu_sums", lambda a, b, p: essential_block_variant(
                    a, b, p, "mxu_sums")),
                ("bf16_mul", lambda a, b, p: essential_block_variant(
                    a, b, p, "bf16_mul"))]
    return out


def time_cases(inputs, iters, include_all):
    """{name: mean ms} of every case on ``inputs``, CUDA events over
    ``iters`` calls after one warm-up."""
    out = {}
    with torch.no_grad():
        for name, fn in cases(include_all):
            fn(*inputs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*inputs)
            end.record()
            torch.cuda.synchronize()
            out[name] = start.elapsed_time(end) / iters
    return out


def main():
    if not torch.cuda.is_available():
        print("bench_cross_torch: no CUDA device", file=sys.stderr)
        return 1
    B = int(os.environ.get("BENCH_BATCH", "256"))
    iters = int(os.environ.get("BENCH_ITERS", "30"))
    inputs = make_inputs(B, torch.device("cuda:0"))
    for name, ms in time_cases(inputs, iters,
                               bool(os.environ.get("BENCH_ALL"))).items():
        print(f"{name:>16}: {ms:8.3f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
