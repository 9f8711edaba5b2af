"""The host data pipeline's pairs/s: disk, decode, augment, batch, upload.

    python -m rel_pose_tpu_torch.tools.bench_loader
    LOADER_N=256 LOADER_WORKERS=8 LOADER_BATCH=60 \\
        python -m rel_pose_tpu_torch.tools.bench_loader

Counterpart of ``scripts/bench_loader.py`` with its environment and
defaults: ``LOADER_N`` pairs (64), ``LOADER_WORKERS`` (the host's cores),
``LOADER_BATCH`` (8), or the flags ``--n``, ``--workers``, ``--batch``.
It writes a synthetic Matterport tree of ``LOADER_N`` random-noise 480x640
PNG pairs in a temporary directory (``convergence_run.build_tree`` with
distinct poses), then reads it through the port's training path:
``data.dataset_factory(["matterport"])`` (decode, the 384x512 resize, the
native photometric jitter) and ``data.DataLoader`` (threads, collation).
Each batch is copied to ``--device`` from pinned memory, as the training
CLI's prefetch does (nothing is copied with ``--device cpu``).  One batch
of warm-up, then the rest of the epoch on the host clock.  One JSON line:
``metric`` ``loader_pairs_per_sec``, ``value``, ``unit``, ``pairs``,
``workers``, ``native`` (whether the C++ host library ran) and the card
(``nvidia-smi``'s name and power limit).
"""

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from . import card_line

PROG = "python -m rel_pose_tpu_torch.tools.bench_loader"


def measure(root, n, workers, batch, device):
    """Write the tree under ``root`` and read it -> (pairs, seconds)."""
    from .. import data
    from .convergence_run import build_tree
    dp = os.path.join(root, "matterport")
    t0 = time.perf_counter()
    build_tree(dp, n_pairs=n, hw=(480, 640), distinct=True)
    print(f"wrote {n} pairs in {time.perf_counter() - t0:.1f} s",
          flush=True)
    db = data.dataset_factory(["matterport"], datapath=dp, subepoch=0,
                              is_training=True)
    loader = data.DataLoader(db, batch_size=batch, shuffle=True,
                             num_workers=workers)

    def upload(arrays):
        if device.type == "cuda":
            return [torch.from_numpy(a).pin_memory().to(device,
                                                        non_blocking=True)
                    for a in arrays]
        return arrays

    it = iter(loader)
    upload(next(it))    # warm-up: thread start, cv2's first decode
    t0 = time.perf_counter()
    seen = 0
    for arrays in it:
        upload(arrays)
        seen += arrays[0].shape[0]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return seen, time.perf_counter() - t0


def main(argv=None):
    from .. import native
    from ..cli._eval import resolve_device
    env = os.environ.get
    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument("--n", type=int, default=int(env("LOADER_N", 64)))
    ap.add_argument("--workers", type=int, default=int(env(
        "LOADER_WORKERS", os.cpu_count() or 1)))
    ap.add_argument("--batch", type=int, default=int(env("LOADER_BATCH", 8)))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device, PROG)
    if args.n < 2 * args.batch:
        raise SystemExit(f"{PROG}: --n {args.n} gives no timed batch after "
                         f"the warm-up one at --batch {args.batch}")
    with tempfile.TemporaryDirectory() as root:
        seen, dt = measure(root, args.n, args.workers, args.batch, device)
    card = card_line() if device.type == "cuda" else "cpu"
    print(json.dumps({
        "metric": "loader_pairs_per_sec", "value": seen / dt,
        "unit": "pairs/s", "pairs": seen, "workers": args.workers,
        "batch": args.batch, "native": native.available(),
        "device": str(device), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
