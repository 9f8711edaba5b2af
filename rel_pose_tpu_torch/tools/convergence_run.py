"""Training-convergence protocol through the port's training CLI, in
either dtype.

    python -m rel_pose_tpu_torch.tools.convergence_run --dtype float32
    python -m rel_pose_tpu_torch.tools.convergence_run --dtype bfloat16

Counterpart of ``scripts/convergence_run.py`` with its protocol and
defaults: a synthetic Matterport tree of 4 random-noise 480x640 PNG pairs
sharing one real-geometry pose (``--distinct``: each pair its own random
unit-quaternion pose, a harder protocol that needs more steps), batch 4,
330 steps, lr 1e-4, warm-up 33, depth 6, ``--fusion_transformer``, one
loader worker, ``--no_ddp``; the model overfits to near-zero geodesic
error through ``python -m rel_pose_tpu_torch.cli.train`` in a child
process (``--device``, default cuda).  Per-step gradient checks cannot
show that bf16 training converges: rounding compounds over a trajectory.

The tree persists under ``--root`` (default ``output/convergence``) so
that both dtypes train on the same data; a ``DISTINCT`` marker records
its protocol, and a tree built under the other protocol is refused.  Each
run starts from a clean run directory.  It prints the trajectory of the
CLI's ``runs/metrics.jsonl`` records (means of 100 logger pushes) and one
line ``CONVERGENCE_SUMMARY {json}``; :func:`gate` applies
``tests/test_convergence.py``'s gates to a trajectory.

Not ported: ``--real-photos``, which trains on the reference's demo
photographs; they are not in the repository.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

from . import child_env


def build_tree(root, n_pairs=4, hw=(480, 640), seed=0, distinct=False):
    """Matterport tree for the overfit protocols: ``n_pairs`` random-noise
    image pairs, either sharing one real-geometry pose or, with
    ``distinct``, each carrying its own random unit-quaternion pose
    (metadata quaternion W-first, positions at the DEPTH_SCALE-divided
    magnitude real Matterport metadata carries).  The same seed writes the
    same tree as ``scripts/convergence_run.py``."""
    import cv2
    import numpy as np
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(n_pairs):
        files = []
        for j in range(2):
            rel = f"imgs/s{i}_{j}.png"
            full = os.path.join(root, rel)
            os.makedirs(os.path.dirname(full), exist_ok=True)
            cv2.imwrite(full, rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
            files.append("a/b/c/d/e/f/" + rel)
        if distinct:
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            if q[0] < 0:
                q = -q
            pose = {"position": list(rng.normal(size=3) * 0.1),
                    "rotation": list(q)}
        else:
            pose = {"position": [0.5, 0.1, -0.2],
                    "rotation": [0.9, 0.1, 0.2, 0.38]}
        entries.append({"0": {"file_name": files[0]},
                        "1": {"file_name": files[1]}, "rel_pose": pose})
    meta = os.path.join(root, "mp3d_planercnn_json")
    os.makedirs(meta, exist_ok=True)
    for split in ("train", "val", "test"):
        with open(os.path.join(meta, f"cached_set_{split}.json"), "w") as f:
            json.dump({"data": entries}, f)


def prepare_tree(root, distinct=False):
    """Build ``<root>/matterport`` with its protocol marker, or check that
    the tree there was built under the same protocol (SystemExit if
    not)."""
    protocol = "distinct" if distinct else "shared"
    os.makedirs(root, exist_ok=True)
    tree = os.path.join(root, "matterport")
    marker = os.path.join(tree, "DISTINCT")
    if not os.path.exists(os.path.join(tree, "mp3d_planercnn_json",
                                       "cached_set_train.json")):
        build_tree(tree, distinct=distinct)
        with open(marker, "w") as f:
            f.write(protocol)
        print(f"built tree at {tree} (protocol={protocol})", flush=True)
        return
    # legacy markers spelled the --distinct bool
    raw = open(marker).read().strip() if os.path.exists(marker) else ""
    built = {"True": "distinct", "False": "shared"}.get(raw, raw)
    if built != protocol:
        sys.exit(f"ERROR: tree at {tree} was built with protocol="
                 f"{built or 'unknown'} (distinct={built == 'distinct'}); "
                 f"rerun with a fresh --root or matching flags")


def read_trajectory(run_dir, prefix):
    """(steps, rot, tr) of the ``<prefix>_geo_loss_*`` records in
    ``run_dir/runs/metrics.jsonl``.  Each record is a running mean of 100
    logger pushes; its ``step`` counts train and val pushes, so it runs
    slightly ahead of the optimizer's step count."""
    rot, tr, steps = [], [], []
    with open(os.path.join(run_dir, "runs", "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            k = prefix + "_geo_loss_rot"
            if k in rec:
                steps.append(rec.get("step", len(steps)))
                rot.append(rec[k])
                tr.append(rec[prefix + "_geo_loss_tr"])
    return steps, rot, tr


def gate(rot, tr):
    """``tests/test_convergence.py:77-88``'s gates -> the failures: rot and
    tr each end below a tenth of the largest of their first 5 records, rot
    ends at most 1.5x its minimum, no NaN."""
    import math
    failures = []
    if not rot or any(math.isnan(v) for v in rot + tr):
        return [f"NaN or no records: rot {rot}, tr {tr}"]
    for name, v in (("rot", rot), ("tr", tr)):
        if not v[-1] < max(v[:5]) / 10:
            failures.append(f"{name} {max(v[:5]):.5f} -> {v[-1]:.5f}: "
                            "not below a tenth")
    if not rot[-1] <= min(rot) * 1.5:
        failures.append(f"rot ends at {rot[-1]:.5f}, above 1.5x its "
                        f"minimum {min(rot):.5f}")
    return failures


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m rel_pose_tpu_torch.tools.convergence_run")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--root", default=os.path.join("output", "convergence"))
    ap.add_argument("--steps", type=int, default=330)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup", type=int, default=33)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--distinct", action="store_true",
                    help="per-pair random poses (harder; needs more steps)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    protocol = "distinct" if args.distinct else "shared"
    prepare_tree(args.root, args.distinct)
    name = f"conv_{args.dtype}"
    # the logger appends to metrics.jsonl: a rerun with the same --root and
    # --dtype would interleave two trajectories, so start clean
    run_dir = os.path.join(args.root, "output", name)
    if os.path.exists(run_dir):
        shutil.rmtree(run_dir)
        print(f"cleared previous run dir {run_dir}", flush=True)
    cmd = [sys.executable, "-m", "rel_pose_tpu_torch.cli.train",
           "--name", name, "--datapath", "matterport",
           "--dataset", "matterport", "--batch", str(args.batch),
           "--no_ddp", "--steps", str(args.steps),
           "--ckpt_every", str(10 * args.steps),
           "--warmup", str(args.warmup), "--lr", str(args.lr),
           "--num_workers", "1", "--fusion_transformer",
           "--transformer_depth", str(args.depth),
           "--compute_dtype", args.dtype, "--device", args.device]
    print("running:", " ".join(cmd), flush=True)
    r = subprocess.run(cmd, cwd=args.root, env=child_env())
    if r.returncode != 0:
        sys.exit(r.returncode)

    steps, rot, tr = read_trajectory(run_dir, "train")
    _, vrot, vtr = read_trajectory(run_dir, "val")
    for i in range(0, len(steps), max(1, len(steps) // 12)):
        print(f"  step {steps[i]:4d}  rot {rot[i]:.5f}  tr {tr[i]:.5f}",
              flush=True)
    print(f"  step {steps[-1]:4d}  rot {rot[-1]:.5f}  tr {tr[-1]:.5f}")
    summary = {
        "dtype": args.dtype, "steps": args.steps, "batch": args.batch,
        "protocol": protocol,
        "rot_first": rot[0], "rot_final": rot[-1],
        "tr_first": tr[0], "tr_final": tr[-1],
        "val_rot_final": vrot[-1] if vrot else None,
        "val_tr_final": vtr[-1] if vtr else None,
    }
    print("CONVERGENCE_SUMMARY " + json.dumps(summary), flush=True)
    return 0


def parse_summary(stdout):
    """The ``CONVERGENCE_SUMMARY`` dict of a run's standard output."""
    for line in reversed(stdout.splitlines()):
        if line.startswith("CONVERGENCE_SUMMARY "):
            return json.loads(line[len("CONVERGENCE_SUMMARY "):])
    raise ValueError("no CONVERGENCE_SUMMARY line")


if __name__ == "__main__":
    sys.exit(main())
