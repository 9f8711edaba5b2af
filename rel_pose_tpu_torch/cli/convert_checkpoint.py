"""Convert a reference PyTorch ``.pth`` checkpoint to a ``.ckpt``.

    python -m rel_pose_tpu_torch.cli.convert_checkpoint \\
        --ckpt pretrained_models/matterport.pth --out matterport.ckpt \\
        --transformer_depth 6

Counterpart of the JAX package's ``convert_checkpoint.py``, with the same
flags (``--fusion_transformer`` on by default): the file holds
``{params, bn_state, opt_state: {}, step: 0}`` in flax's msgpack format
(``train.checkpoint.save_ckpt``), which both packages' eval and demo CLIs
load and both training CLIs take as a ``--ckpt`` warm start (weights only,
a fresh optimizer).  It runs on the CPU.
"""

import argparse
import sys

from ..config import add_model_flags, model_config_from_args
from ..infer import load_checkpoint_state_dict
from ..models.vitess import ViTEss
from ..train.checkpoint import save_ckpt


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m rel_pose_tpu_torch.cli.convert_checkpoint")
    parser.add_argument("--ckpt", required=True, help="input .pth")
    parser.add_argument("--out", required=True, help="output .ckpt")
    add_model_flags(parser, fusion_default=True)
    args = parser.parse_args(argv)
    if not args.ckpt.endswith(".pth"):
        raise SystemExit(f"--ckpt {args.ckpt}: expected a .pth checkpoint")

    cfg = model_config_from_args(args)
    model = ViTEss(cfg, device="cpu")
    model.load_state_dict(load_checkpoint_state_dict(args.ckpt, cfg))
    save_ckpt(args.out, model, step=0)
    n = sum(p.numel() for p in model.parameters())
    print(f"converted {args.ckpt} -> {args.out} ({n:,} parameters)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
