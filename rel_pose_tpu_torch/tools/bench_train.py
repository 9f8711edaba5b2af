"""Train-step time and pairs/s on the card.

    python -m rel_pose_tpu_torch.tools.bench_train
    python -m rel_pose_tpu_torch.tools.bench_train --dtype bfloat16 \\
        --mode grad --batch 60 --iters 20

Counterpart of ``scripts/bench_train.py`` with its defaults and
environment: ``BENCH_BATCH`` (60), ``BENCH_ITERS`` (20), ``BENCH_DTYPE``
(float32), ``BENCH_MODE`` (step) and ``BENCH_REMAT`` (any value but the
empty string: the forward rematerialized in the backward), or the flags of
the same names.  The flagship at full width (depth 6) with seeded weights,
384x512 uint8 pairs, the JAX script's poses (identity, then a translation
of 0.3 along x) and the Matterport intrinsics.  Modes (``--remat`` passes
``remat=True`` to the step or the loss of the first two):

  step  ``train.step.train_step``: the loss, backward, clip 2.5, Adam and
        the OneCycle step (``train.optim.make_optimizer``'s defaults);
  grad  the training forward, the loss and the backward, no optimizer;
  fwd   the training-mode forward and the loss, without autograd.

Two steps of warm-up (the kernels' build, cuDNN's plans), then CUDA events
over ``--iters`` chained steps.  The last line is one JSON object with the
JAX script's keys ``metric`` (``train_<mode>_ms``), ``value``, ``unit``,
``dtype``, ``batch``, ``remat`` and ``pairs_per_sec``, and ``iters``,
``depth``, ``device`` and the card (``nvidia-smi``'s name and power
limit).  ``--device cpu`` (with ``--depth``) rehearses it on the CPU (host
clock).
"""

import argparse
import json
import os
import sys

import torch

from . import Clock, card_line
from .bench_stages import seeded_model
from .bench_stages_bwd import train_batch

PROG = "python -m rel_pose_tpu_torch.tools.bench_train"
MODES = ("step", "grad", "fwd")


def step_fn(mode, model, batch, remat=False):
    """The work of one iteration of ``mode`` on ``batch`` (images, poses,
    intrinsics), the forward rematerialized in the backward when
    ``remat``."""
    from ..train.optim import make_optimizer
    from ..train.step import loss_fn, train_step
    model.train()
    if mode == "step":
        opt, sched = make_optimizer(model)
        return lambda: train_step(model, opt, sched, *batch, remat=remat)
    if mode == "grad":
        def grad():
            model.zero_grad(set_to_none=True)
            loss_fn(model, *batch, remat=remat)[0].backward()
        return grad

    def fwd():
        with torch.no_grad():
            loss_fn(model, *batch)
    return fwd


def measure(mode, model, batch, iters, device, warmup=2, remat=False):
    """Mean ms an iteration of ``mode`` over ``iters`` chained ones."""
    fn = step_fn(mode, model, batch, remat)
    clock = Clock(device)
    for _ in range(warmup):
        fn()
    start = clock.mark()
    for _ in range(iters):
        fn()
    end = clock.mark()
    clock.sync()
    return clock.ms(start, end) / iters


def main(argv=None):
    from ..cli._eval import resolve_device
    env = os.environ.get
    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument("--mode", default=env("BENCH_MODE", "step"),
                    choices=MODES)
    ap.add_argument("--batch", type=int, default=int(env("BENCH_BATCH", 60)))
    ap.add_argument("--iters", type=int, default=int(env("BENCH_ITERS", 20)))
    ap.add_argument("--dtype", default=env("BENCH_DTYPE", "float32"),
                    choices=("float32", "bfloat16"))
    ap.add_argument("--remat", action="store_true",
                    default=bool(env("BENCH_REMAT")),
                    help="rematerialize the forward in the backward")
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device, PROG)
    model = seeded_model(args.dtype, args.depth, device)
    ms = measure(args.mode, model, train_batch(args.batch, device),
                 args.iters, device, remat=args.remat)
    card = card_line() if device.type == "cuda" else "cpu (host clock)"
    print(json.dumps({
        "metric": f"train_{args.mode}_ms", "value": ms, "unit": "ms",
        "dtype": args.dtype, "batch": args.batch, "remat": args.remat,
        "pairs_per_sec": args.batch / (ms * 1e-3), "iters": args.iters,
        "depth": args.depth, "device": str(device), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
