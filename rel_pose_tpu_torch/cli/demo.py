"""Relative pose of one image pair.

    python -m rel_pose_tpu_torch.cli.demo --img1 a.png --img2 b.png \\
        --ckpt matterport.ckpt

Counterpart of the JAX package's ``demo.py`` with the same flags plus
``--device`` (``cuda``, the default, or ``cpu``); ``--fusion_transformer``
is forced on.  A checkpoint (``.pth`` or ``.ckpt``) whose name contains
``matterport`` takes the Matterport branch: its intrinsics, the 384x512
resize and ``infer.matterport_demo_pose`` (translation times
``DEPTH_SCALE``, the ``[4, 5, 3, 6]`` quaternion reorder), printing the
7 numbers; any other takes the 256x256 InteriorNet / StreetLearn
intrinsics at the native resolution and prints the quaternion.  The output
is the JAX script's, to 5 decimals.
"""

import argparse
import sys

import numpy as np

from ..config import add_model_flags, model_config_from_args
from ..data.base import image_read
from ..infer import (INTERIORNET_STREETLEARN_INTRINSICS, MATTERPORT_INTRINSICS,
                     PosePredictor, matterport_demo_pose)
from ._eval import add_device_flag, resolve_device

PROG = "python -m rel_pose_tpu_torch.cli.demo"


def build_parser():
    parser = argparse.ArgumentParser(prog=PROG)
    parser.add_argument("--datapath")
    parser.add_argument("--weights")
    parser.add_argument("--image_size", default=[384, 512])
    parser.add_argument("--img1", required=True)
    parser.add_argument("--img2", required=True)
    parser.add_argument("--ckpt", required=True,
                        help="a .pth or a .ckpt checkpoint")
    add_device_flag(parser)
    add_model_flags(parser)
    return parser


def predict(args, device):
    """-> (is_matterport, the 7 numbers after the branch's convention)."""
    args.fusion_transformer = True  # forced, as in demo.py:46
    cfg = model_config_from_args(args)
    is_matterport = "matterport" in args.ckpt
    predictor = PosePredictor.from_checkpoint(
        args.ckpt, cfg, device=device,
        intrinsics=(MATTERPORT_INTRINSICS if is_matterport
                    else INTERIORNET_STREETLEARN_INTRINSICS),
        image_size=(384, 512) if is_matterport else None)
    pose = predictor.predict(image_read(args.img1), image_read(args.img2))[1]
    return is_matterport, (matterport_demo_pose(pose) if is_matterport
                           else pose)


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device, PROG)
    print("predicting pose on %s and %s using model %s"
          % (args.img1, args.img2, args.ckpt))
    is_matterport, preds = predict(args, device)
    with np.printoptions(suppress=True, precision=5):
        if is_matterport:
            print("predicted R&t, as quaternion, in format "
                  "x,y,z,qx,qy,qz,qw:")
            print(preds)
        else:
            print("predicted R, as quaternion in format qx,qy,qz,qw")
            print(preds[3:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
