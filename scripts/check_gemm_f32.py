#!/usr/bin/env python3
"""The fp32 GEMM body of the ViT stack (#1, #5) in one tree, on one GPU:
its checks and its readings, without the rest of ``chip_smoke.py``.

    python3 scripts/check_gemm_f32.py [--tree DIR]

Imports ``rel_pose_tpu_torch`` and ``chip_smoke.py`` from ``DIR`` (this
checkout by default), builds DIR's kernels and prints the ptxas registers
and spills of ``gemm_f32_kernel``; then ``chip_smoke.phase_gemm`` (5f:
every GEMM of #1 and #5 alone, bf16 and fp32, against its plain version,
fp32 also against float64, timed beside cuBLAS), the fp32 stack against
its plain version (#1 at G = 16, 3 and C = 64; #5 the same, twice for the
same bits), ``chip_smoke.check_vit_f64`` (3b's float64 bar of the fp32
stack at G = 16), and, when those pass, ``chip_smoke.time_vit_stack`` in
fp32: #5 at G = 120, #1 at G = 120 and 512, by part.  Exits non-zero if a
check failed.  To compare a variant of the body (another ``kF32Steps``,
say), point ``--tree`` at a copy of the checkout that has it.  Needs a CUDA
device.
"""

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    tree = pathlib.Path(ap.parse_args().tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("check_gemm_f32: no CUDA device", file=sys.stderr)
        return 1
    from rel_pose_tpu_torch.ops import _build
    from rel_pose_tpu_torch.ops.vit_stack import (fused_vit_stack,
                                                  vit_stack_reference)
    dev = torch.device("cuda:0")
    card = cs.phase_device()
    cs.log(f"[gemm_f32] tree {tree}")
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    cs.log(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    lines = so.with_suffix(".log").read_text().splitlines()
    for i, line in enumerate(lines):
        if "gemm_f32_kernel" in line:
            cs.log(f"[build] {line.strip()}")
            for nxt in lines[i + 1:i + 4]:
                if "Used" in nxt or "spill" in nxt:
                    cs.log(f"[build] {nxt.strip()}")
    failures = []
    try:
        cs.phase_gemm(dev, card)
    except SystemExit as e:
        failures.append(f"5f: {e}")
    rng = np.random.default_rng(cs.SEED)
    shapes = ((16, 192, 768), (3, 192, 768), (3, 64, 256))
    for G, C, hidden in shapes:
        x, stacked, pos = cs.vit_inputs(rng, G, torch.float32, dev, C=C,
                                        hidden=hidden)
        out = fused_vit_stack(x, stacked, C // 64, pos)
        torch.cuda.synchronize()
        cs.check_tokens(f"vit_stack G={G} C={C} depth=5", out,
                        vit_stack_reference(x, stacked, C // 64, pos),
                        torch.float32, failures)
    rng = np.random.default_rng(cs.SEED + 3)
    for G, C, hidden in shapes:
        cs.check_vit_bwd(G, torch.float32, rng, dev, failures, C, hidden)
    cs.check_vit_f64(dev, failures)
    if failures:
        cs.log(f"[gemm_f32] failed: {failures}")
        return 1
    for G, backward in ((120, True), (120, False), (512, False)):
        cs.time_vit_stack(dev, card, G, backward)
    return 0


if __name__ == "__main__":
    sys.exit(main())
