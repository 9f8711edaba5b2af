"""The flagship's training forward and backward timed by stage on the card.

    python -m rel_pose_tpu_torch.tools.bench_stages_bwd
    python -m rel_pose_tpu_torch.tools.bench_stages_bwd --dtype bfloat16

Counterpart of ``scripts/bench_stages_bwd.py`` with its defaults: the
flagship at full width (depth 6) with seeded weights in training mode
(BatchNorm on batch statistics), batch 60 of 384x512 uint8 pairs with the
Matterport intrinsics, float32.  The stages are the model's own
(``ViTEss.stages``, as ``bench_stages`` times them), then
``loss``: the geodesic loss of ``train.step.loss_fn`` (w 10 / 10) against
the JAX script's poses (identity, then a translation of 0.3 along x).

The JAX script differentiates nested prefixes and takes differences; here
one forward and one backward are timed by stage directly.  A CUDA event
is recorded at each stage boundary of the forward, and a hook on each
boundary activation records one when its gradient arrives: a stage's
backward is the gap between the hook on its output and the hook on its
input (from the backward's start for ``loss``, to its end for ``stem``,
whose input carries no gradient; ``pre`` has no backward).  The ``vit``
stage's backward is kernel #5, by recompute from the stash; ``cross``'s
includes #6.  The hooks return nothing, so no gradient changes
(``tests/test_torch_bench_tools.py`` holds them bit for bit against plain
autograd), and every parameter belongs to one stage
(:func:`stage_parameters`).  A forward and backward of ``loss_fn`` without
hooks or events is timed on its own for comparison, in the same iteration;
each time is the median over the iterations.

The last line is one JSON object: ``forward_ms`` and ``backward_ms`` (median
ms by stage), their sums, ``step_ms`` (the plain forward and backward),
``sum_share``, each iteration's readings and the allocator's counts
(:func:`measure`), the settings and the card.  ``--device cpu`` rehearses it
on the CPU (host clock).
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import Clock, card_line
from .bench_stages import run_stages, seeded_model

PROG = "python -m rel_pose_tpu_torch.tools.bench_stages_bwd"
# each stage's parameters by name prefix; pre, tokens and loss have none
STAGE_PREFIXES = {
    "stem": ("resnet.conv1.", "resnet.bn1."),
    "layer1": ("resnet.layer1.",),
    "layer2": ("resnet.layer2.",),
    "extractor": ("extractor_final_conv.",),
    "regress": ("pose_regressor.",),
}


def stage_parameters(model):
    """{stage: [parameter name]}: the ViT stack's blocks and the positional
    embedding are ``vit``'s, the cross block and the final norm
    ``cross``'s."""
    depth = model.cfg.transformer_depth
    vit = ("fusion_transformer.pos_embed",) + tuple(
        f"fusion_transformer.blocks.{i}." for i in range(depth - 1))
    cross = (f"fusion_transformer.blocks.{depth - 1}.",
             "fusion_transformer.norm.")
    prefixes = dict(STAGE_PREFIXES, vit=vit, cross=cross)
    return {stage: [n for n, _ in model.named_parameters()
                    if n.startswith(p)] for stage, p in prefixes.items()}


def train_batch(batch, device, hw=(384, 512)):
    """The JAX script's batch: uint8 images, pose 1 a translation of 0.3
    along x, Matterport intrinsics."""
    from ..infer import MATTERPORT_INTRINSICS
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (batch, 2, 3) + tuple(hw), dtype=np.uint8)
    poses = np.zeros((batch, 2, 7), np.float32)
    poses[..., 6] = 1.0
    poses[:, 1, 0] = 0.3
    intr = np.tile(MATTERPORT_INTRINSICS, (batch, 2, 1))
    return tuple(torch.from_numpy(a).to(device)
                 for a in (images, poses, intr))


def training_stages(model, images, poses, intr):
    """``ViTEss.stages`` and the loss, ``[(name, fn)]``."""
    from ..geom.losses import geodesic_loss

    def loss(poses_est):
        tr, rot, _ = geodesic_loss(poses, poses_est, "train")
        return 10.0 * tr + 10.0 * rot

    return model.stages(images.shape, intr) + [("loss", loss)]


def staged_step(staged, images, clock):
    """One forward through ``staged`` and its backward, hooks on every
    boundary -> (forward marks, backward marks): ``bwd[i]`` is when the
    gradient of stage i's output arrived, then the backward's start and
    end under ``"start"`` and ``"end"``."""
    acts, marks = run_stages(staged, images, clock)
    bwd = {}
    for i, a in enumerate(acts[:-1]):
        if a.requires_grad:
            a.register_hook(lambda g, i=i: bwd.__setitem__(i, clock.mark()))
    bwd["start"] = clock.mark()
    acts[-1].backward()
    bwd["end"] = clock.mark()
    return marks, bwd


def backward_ms(names, bwd, clock):
    """{stage: ms} from the marks of :func:`staged_step`: stage i's
    backward runs from the gradient of its output to that of its input."""
    out, last = {}, len(names) - 1
    for i, name in enumerate(names):
        start = bwd["start"] if i == last else bwd.get(i)
        end = bwd.get(i - 1, bwd["end"]) if i > 0 else None
        out[name] = (None if start is None or end is None
                     else clock.ms(start, end))
    return out


def measure(model, batch, iters, device, warmup=1):
    """-> dict of the training forward's and backward's median ms by stage
    and of the plain forward and backward.  Each iteration runs the staged
    step and the plain one, each from an idle card, so that a slow spell
    of the host or the card falls on both and not on one of them, and the
    two take turns at going first, so that a drift of the host's speed
    over the iterations (the step is partly bound by the host enqueuing it)
    falls on both alike.  Beside the medians: each iteration's staged step
    end to end (``staged_ms_each``), its plain step (``step_ms_each``) and
    the host's ms to enqueue that plain step (``host_ms_each``, the host
    clock from its start until ``backward()`` returns), and on the card
    the caching allocator's retries (``alloc_retries``: frees of cached
    blocks after a failed ``cudaMalloc``) and ``cudaMalloc`` calls
    (``device_allocs``) over the timed iterations."""
    from ..train.step import loss_fn
    images, poses, intr = train_batch(batch, device)
    model.train()
    staged = training_stages(model, images, poses, intr)
    names = [n for n, _ in staged]
    clock = Clock(device)

    def run_staged():
        clock.sync()
        model.zero_grad(set_to_none=True)
        return staged_step(staged, images, clock)

    def run_plain():
        clock.sync()
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        start = clock.mark()
        loss_fn(model, images, poses, intr)[0].backward()
        end = clock.mark()
        return start, end, (time.perf_counter() - t0) * 1e3

    fwd, bwd, steps, staged_each, host_each = [], [], [], [], []
    for i in range(warmup + iters):
        if i == warmup:
            before = allocator_counts(device)
        if i % 2:
            start, end, host = run_plain()
            marks, bmarks = run_staged()
        else:
            marks, bmarks = run_staged()
            start, end, host = run_plain()
        clock.sync()
        if i < warmup:
            continue
        fwd.append([clock.ms(a, b) for a, b in zip(marks, marks[1:])])
        bwd.append(backward_ms(names, bmarks, clock))
        steps.append(clock.ms(start, end))
        staged_each.append(clock.ms(marks[0], bmarks["end"]))
        host_each.append(host)
    after = allocator_counts(device)
    fwd = {n: float(ms) for n, ms in zip(names, np.median(fwd, axis=0))}
    bwd = {n: None if bwd[0][n] is None
           else float(np.median([b[n] for b in bwd])) for n in names}
    step = float(np.median(steps))
    fsum, bsum = sum(fwd.values()), sum(v for v in bwd.values() if v)
    return {"forward_ms": fwd, "backward_ms": bwd, "forward_sum_ms": fsum,
            "backward_sum_ms": bsum, "step_ms": step,
            "sum_share": (fsum + bsum) / step,
            "staged_ms_each": [float(v) for v in staged_each],
            "step_ms_each": [float(v) for v in steps],
            "host_ms_each": host_each,
            **{k: after[k] - before[k] for k in after}}


def allocator_counts(device):
    """The caching allocator's counts of retries and ``cudaMalloc`` calls
    so far on ``device`` (zeros on the CPU)."""
    if torch.device(device).type != "cuda":
        return {"alloc_retries": 0, "device_allocs": 0}
    stats = torch.cuda.memory_stats(device)
    return {"alloc_retries": stats.get("num_alloc_retries", 0),
            "device_allocs": stats.get("num_device_alloc", 0)}


def main(argv=None):
    from ..cli._eval import resolve_device
    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument("--batch", type=int, default=60)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device, PROG)
    model = seeded_model(args.dtype, args.depth, device)
    res = measure(model, args.batch, args.iters, device)
    card = card_line() if device.type == "cuda" else "cpu (host clock)"
    print(f"batch={args.batch} iters={args.iters} dtype={args.dtype} "
          f"(forward / backward by stage; {card})")
    for name, f in res["forward_ms"].items():
        b = res["backward_ms"][name]
        print(f"  {name:>10}: {f:9.3f} ms / "
              f"{'-' if b is None else f'{b:.3f}'} ms")
    print(f"  sums {res['forward_sum_ms']:.3f} / {res['backward_sum_ms']:.3f}"
          f" ms; forward and backward alone {res['step_ms']:.3f} ms "
          f"({100 * res['sum_share']:.2f}%)")
    print(json.dumps(dict(res, metric="train_fwd_bwd_stages",
                          batch=args.batch, iters=args.iters,
                          dtype=args.dtype, depth=args.depth,
                          device=str(device), card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
