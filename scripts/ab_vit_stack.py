#!/usr/bin/env python3
"""Readings of the ViT stack kernels #1 and #5 in one tree, to compare two
trees on one GPU.

    python3 scripts/ab_vit_stack.py [--tree DIR] [--dtype float32|bfloat16]
                                    [--no-step] [--eval]

Imports ``rel_pose_tpu_torch`` from ``DIR`` (this checkout by default) and
``chip_smoke.py`` from this checkout, builds DIR's kernels, and runs
``chip_smoke.time_vit_stack`` in the dtype (float32 by default): #1 at
G = 512 (the eval shape, batch 256) and G = 120 (the training shape, batch
60), #5 at G = 120, each checked against its plain version and timed
beside it, the library stack in that dtype and one SDPA call, with the
bound; then, unless ``--no-step``, the flagship's train step at batch 60
in that dtype with the kernels and on the plain path
(``chip_smoke.time_train_steps``); with ``--eval``, the flagship's eval
forward with the kernels in that dtype at batch 256 on 256x256 uint8
pairs (CUDA events over 3 calls after one, as ``chip_smoke.py`` 5).  Run it in turns on one card, the other
tree, this one, this one, the other (``scripts/ab_chip_smoke.sh`` runs
the whole of ``chip_smoke.py`` so).  Needs a CUDA device.
"""

import argparse
import importlib.util
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--no-step", action="store_true")
    ap.add_argument("--eval", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_vit_stack: no CUDA device", file=sys.stderr)
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
    cs.time_vit_stack(device, card, 2 * cs.EVAL_BATCH, False, dtype)
    cs.time_vit_stack(device, card, 2 * cs.TRAIN_BATCH, False, dtype)
    cs.time_vit_stack(device, card, 2 * cs.TRAIN_BATCH, True, dtype)
    if not args.no_step:
        _, sd = cs.make_models(device)
        cs.time_train_steps(device, sd, card, dtypes=(dtype,))
    if args.eval:
        eval_forward_ms(cs, device, dtype, card)
    return 0


def eval_forward_ms(cs, device, dtype, card):
    """The flagship's eval forward with the kernels at batch
    ``cs.EVAL_BATCH`` (seeded weights, 256x256 uint8 pairs)."""
    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.models.vitess import ViTEss
    from rel_pose_tpu_torch.nn.init import seeded_state_dict
    model = ViTEss(ModelConfig(compute_dtype=str(dtype)[6:]), device=device,
                   kernels=True)
    model.load_state_dict(seeded_state_dict(model, cs.SEED))
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    B = cs.EVAL_BATCH
    images = torch.randint(0, 256, (B, 2, 3, 256, 256), generator=gen,
                           device=device, dtype=torch.uint8)
    intr = torch.full((B, 2, 4), 128.0, device=device)
    with torch.inference_mode():
        ms = cs.cuda_time_ms(lambda: model(images, intr), 3)
    cs.log(f"[time] eval forward {str(dtype)[6:]} batch {B} 256x256 uint8 "
           f"(kernels): {ms:.3f} ms, {B / ms * 1e3:.2f} pairs/s ({card})")
    return ms


if __name__ == "__main__":
    sys.exit(main())
