#!/usr/bin/env python3
"""The essential block's wgmma bodies (#2, #3, #4 and #6: bf16
``csrc/essential_wgmma.cuh``, fp32 3xTF32 ``csrc/essential_wgmma_f32.cuh``)
and #9's ``s`` on one GPU, without the rest of ``chip_smoke.py``.

    python3 scripts/check_essential.py [--tree DIR] [--batch 8] [--calls 3]
                                       [--dtype float32|bfloat16|both]

Imports ``rel_pose_tpu_torch`` from ``DIR`` (this checkout by default) and
``chip_smoke.py`` from this checkout, builds DIR's kernels and prints what
``ptxas -v`` reported for the wgmma kernels (``ewg_*`` fp32, ``ewb_*``
bf16) and the qkv GEMMs (``gemm_f32_kernel``, ``gemm_wgmma_kernel``):
registers and spill bytes.  Then, in the dtypes asked for:

  * fp32: ``chip_smoke.check_essential_f64`` (phase 3b) at ``--batch``
    pairs of N = 576: #2's F and #6's dq, dk, dv and dpos for the 8
    (has_pos, cross, single) flag sets against float64, each within
    ``F64_BAR`` times the fp32 plain version's error;
  * ``chip_smoke.check_essential_main`` (phase 3d's main grids): #2 at the
    eval batch and #6 at the training batch for the 8 flag sets,
    ``--calls`` calls each the same bits, against the plain versions;
  * with ``--dtype both``: phase 3d whole (``phase_kernels_variants``: B =
    8, the ragged N = 100, #3, #4) and phase 3f
    (``phase_kernels_cross_variants``: #9's s against #4's bits).

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
    """The build log's registers and spills of the wgmma essential kernels
    and the GEMMs."""
    so = build.build()
    name = None
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line:
            name = line.split("'")[1]
        elif name and any(k in name for k in (
                "ewg_", "ewb_", "gemm_f32_kernel", "gemm_wgmma_kernel")) \
                and ("Used" in line or "spill" in line):
            print(f"[ptxas] {name[:72]}: {line.strip()}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--dtype", default="both",
                    choices=("float32", "bfloat16", "both"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("check_essential: no CUDA device", file=sys.stderr)
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
    dtypes = cs.DTYPES if args.dtype == "both" else (
        getattr(torch, args.dtype),)
    failures = []
    if torch.float32 in dtypes:
        cs.check_essential_f64(device, failures, B=args.batch)
    if args.dtype == "both":
        cs.phase_kernels_variants(device)
        cs.phase_kernels_cross_variants(device)
    else:
        cs.check_essential_main(device, failures, args.calls, dtypes)
    if failures:
        raise SystemExit(f"check_essential failed: {failures}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
