"""The flagship's eval forward timed by stage on the card.

    python -m rel_pose_tpu_torch.tools.bench_stages
    python -m rel_pose_tpu_torch.tools.bench_stages --dtype float32 \\
        --batch 64 --iters 20

Counterpart of ``scripts/bench_stages.py`` with its defaults: the flagship
``ViTEss`` at full width (depth 6, 576 tokens of 192 channels, 3 heads)
with seeded weights, batch 256 of 256x256 uint8 pairs with the
InteriorNet intrinsics, bf16.  The stages are the model's own
(``ViTEss.stages``), which its ``forward`` applies in order:

  pre        reshape, nearest resize to 224, cast, mean subtraction
  stem       the normalization folded into conv1, conv1 + BN, ReLU,
             max-pool
  layer1     ResNet layer1
  layer2     ResNet layer2
  extractor  the k=5 residual block
  tokens     (2B, C, 24, 24) -> (2B, 576, C)
  vit        the 5 ViT blocks (kernel #1)
  cross      the essential cross block (#2), its projection, norm2 and
             MLP, the final LayerNorm
  regress    the fp32 pose regressor and ``normalize_preds``

The JAX script times nested prefixes in compiled loops and takes
differences; PyTorch runs eagerly, so each stage is timed directly between
CUDA events recorded at its boundaries, and the whole ``model(images,
intr)`` is timed on its own, in the same iteration; each time is the
median over the iterations.  Both are printed, with the share of the whole
that the stages' sum accounts for (the events themselves cost a little).
The space-to-depth stem of the JAX script is a TPU rewrite that the port
does not have.

The last line is one JSON object: ``stages_ms`` (median ms a forward by
stage), ``stages_sum_ms``, ``forward_ms``, ``sum_share``,
``pairs_per_sec`` (from ``forward_ms``), the run's settings and the card
(``nvidia-smi``'s name and power limit).  ``--device cpu`` (with
``--depth`` to shorten the stack) rehearses it on the CPU, where the
numbers are the host clock's.
"""

import argparse
import json
import sys

import numpy as np
import torch

from . import Clock, card_line

PROG = "python -m rel_pose_tpu_torch.tools.bench_stages"


def run_stages(staged, images, clock):
    """Apply ``staged`` to ``images`` -> (each stage's output, a mark
    before each stage and after the last)."""
    acts, marks = [], [clock.mark()]
    x = images
    for _, fn in staged:
        x = fn(x)
        marks.append(clock.mark())
        acts.append(x)
    return acts, marks


def seeded_model(dtype, depth, device, seed=0):
    """The flagship at full width, ``depth`` blocks, with numpy-seeded
    weights (``nn.init.seeded_state_dict``)."""
    from ..config import ModelConfig
    from ..models.vitess import ViTEss
    from ..nn.init import seeded_state_dict
    cfg = ModelConfig(compute_dtype=dtype, transformer_depth=depth)
    sd = seeded_state_dict(ViTEss(cfg, device="meta"), seed)
    model = ViTEss(cfg, device=device)
    model.load_state_dict(sd)
    return model


def measure(model, batch, iters, device, hw=(256, 256), warmup=1):
    """The eval forward of ``model`` at ``batch`` pairs of ``hw`` uint8
    images: median ms a forward by stage and of the whole -> dict.  Each
    iteration runs the staged forward and then the whole forward, each
    from an idle card, so that a slow spell of the host or the card falls
    on both and not on one of them."""
    from ..infer import INTERIORNET_STREETLEARN_INTRINSICS
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(
        0, 256, (batch, 2, 3) + tuple(hw), dtype=np.uint8)).to(device)
    intr = torch.from_numpy(INTERIORNET_STREETLEARN_INTRINSICS).to(
        device).repeat(batch, 2, 1)
    staged = model.stages(images.shape, intr)
    clock = Clock(device)
    stages, whole = [], []
    with torch.inference_mode():
        for i in range(warmup + iters):
            clock.sync()
            marks = run_stages(staged, images, clock)[1]
            clock.sync()
            start = clock.mark()
            model(images, intr)
            end = clock.mark()
            clock.sync()
            if i >= warmup:
                stages.append([clock.ms(a, b)
                               for a, b in zip(marks, marks[1:])])
                whole.append(clock.ms(start, end))
    forward = float(np.median(whole))
    per_stage = {name: float(ms) for (name, _), ms in zip(
        staged, np.median(stages, axis=0))}
    total = float(sum(per_stage.values()))
    return {"stages_ms": per_stage, "stages_sum_ms": total,
            "forward_ms": forward, "sum_share": total / forward,
            "pairs_per_sec": batch / (forward * 1e-3)}


def main(argv=None):
    from ..cli._eval import resolve_device
    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--depth", type=int, default=6,
                    help="transformer depth (the ViT stack has depth - 1 "
                         "blocks)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device, PROG)
    model = seeded_model(args.dtype, args.depth, device)
    res = measure(model, args.batch, args.iters, device)
    card = card_line() if device.type == "cuda" else "cpu (host clock)"
    print(f"batch={args.batch} iters={args.iters} dtype={args.dtype} "
          f"({card})")
    for name, ms in res["stages_ms"].items():
        print(f"  {name:>10}: {ms:9.3f} ms")
    print(f"  stages' sum {res['stages_sum_ms']:.3f} ms; the whole forward "
          f"alone {res['forward_ms']:.3f} ms ({100 * res['sum_share']:.2f}%"
          f"); {res['pairs_per_sec']:.2f} pairs/s")
    print(json.dumps(dict(res, metric="eval_forward_stages", batch=args.batch,
                          iters=args.iters, dtype=args.dtype,
                          depth=args.depth, device=str(device), card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
