#!/usr/bin/env python3
"""The fp32 essential block (#2, #3, #4 and #6 on TF32 wgmma,
``csrc/essential_wgmma_f32.cuh``) on one GPU, without the rest of
``chip_smoke.py``.

    python3 scripts/check_essential_f32.py [--tree DIR] [--batch 8]
                                           [--calls 3]

Imports ``rel_pose_tpu_torch`` from ``DIR`` (this checkout by default) and
``chip_smoke.py`` from this checkout, builds DIR's kernels and prints what
``ptxas -v`` reported for the fp32 wgmma kernels (``ewg_*``) and the qkv
GEMM (``gemm_f32_kernel``): registers and spill bytes.  Then:

  * ``chip_smoke.check_essential_f64`` (phase 3b) at ``--batch`` pairs of
    N = 576: #2's F and #6's dq, dk, dv and dpos for the 8 (has_pos,
    cross, single) flag sets against float64, each within ``F64_BAR``
    times the fp32 plain version's error;
  * ``chip_smoke.check_essential_main`` (phase 3d): #2 at the eval batch
    and #6 at the training batch for the 8 flag sets, ``--calls`` calls
    each the same bits, against the plain versions.

To compare two versions of the kernels (a partial depth, a pass), run it
on copies of the tree in turns on one card.  Needs a CUDA device.
"""

import argparse
import importlib.util
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def ptxas_report(build):
    """The build log's registers and spills of the fp32 wgmma kernels."""
    so = build.build()
    name = None
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1]
        elif name and ("ewg_" in name or "gemm_f32_kernel" in name) and (
                "Used" in line or "spill" in line):
            print(f"[ptxas] {name[:72]}: {line.strip()}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("check_essential_f32: no CUDA device", file=sys.stderr)
        return 1
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import rel_pose_tpu_torch
    from rel_pose_tpu_torch.ops import _build
    where = pathlib.Path(rel_pose_tpu_torch.__file__).resolve()
    if tree not in where.parents:
        raise SystemExit(f"rel_pose_tpu_torch from {where}, not {tree}")
    cs.log(f"[check] tree {tree}")
    device = torch.device("cuda:0")
    cs.phase_device()
    ptxas_report(_build)
    failures = []
    cs.check_essential_f64(device, failures, B=args.batch)
    cs.check_essential_main(device, failures, args.calls)
    if failures:
        raise SystemExit(f"check_essential_f32 failed: {failures}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
