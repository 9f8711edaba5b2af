#!/usr/bin/env python3
"""Profile the PyTorch port's training step on one NVIDIA GPU.

    python3 scripts/profile_torch_train.py [--batch 60] [--steps 3]
    python3 scripts/profile_torch_train.py --eval [--batch 256]

The flagship ``ViTEss`` (depth 6, seeded weights) with the hand kernels
takes ``--steps`` ``train_step``s on Matterport-style 384x512 uint8 batches
(bench.py's train protocol, made by ``chip_smoke.train_batch``) in fp32 and then bf16, after two warm-up steps,
under ``torch.profiler`` (CPU and CUDA).  For each dtype it prints the step
time (CUDA events), the device-busy time per step (the sum of kernel times
on the one stream) and its share of the step, and the kernels by device
time per step.  It writes each trace to
``output/profile_train_<dtype>.json``.  With ``--eval`` it profiles the bf16
eval forward instead (``--steps`` forwards of 256x256 uint8 pairs under
``torch.inference_mode``, as ``chip_smoke.py`` phase 5 times it; trace
``output/profile_eval_bfloat16.json``).  fp32 runs at the port's default
precision (``RELPOSE_MATMUL_PRECISION``, full fp32).  Needs a CUDA device.
"""

import argparse
import pathlib
import subprocess
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def profile(dtype, B, steps, device, out_dir, evaluate=False):
    from torch.profiler import ProfilerActivity
    from chip_smoke import train_batch
    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.models.vitess import ViTEss
    from rel_pose_tpu_torch.nn.init import seeded_state_dict
    from rel_pose_tpu_torch.train.optim import make_optimizer
    from rel_pose_tpu_torch.train.step import train_step
    model = ViTEss(ModelConfig(compute_dtype=dtype), device=device)
    model.load_state_dict(seeded_state_dict(model, 0))
    if evaluate:
        rng = np.random.default_rng(0)
        images = torch.from_numpy(rng.integers(
            0, 256, (B, 2, 3, 256, 256), dtype=np.uint8)).to(device)
        intr = torch.full((B, 2, 4), 128.0, device=device)

        def train_step(*_):
            with torch.inference_mode():
                model(images, intr)
        opt = sched = data = ()
        what = "eval"
    else:
        opt, sched = make_optimizer(model, lr=5e-4, steps=1000, warmup=100)
        data = train_batch(np.random.default_rng(0), B, device)
        what = "train"
    for _ in range(2):
        train_step(model, opt, sched, *data)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(steps):
            train_step(model, opt, sched, *data)
        end.record()
        torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / steps
    kernels = {}
    for ev in prof.key_averages():
        t = ev.self_device_time_total
        if ev.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + t / 1e3 / steps
    busy = sum(kernels.values())
    print(f"[profile] {what} {dtype} batch {B}: step {step_ms:.3f} ms, "
          f"{B / step_ms * 1e3:.2f} pairs/s; device busy {busy:.3f} ms per "
          f"step, {100 * busy / step_ms:.2f}% of the step", flush=True)
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:30]:
        print(f"[profile] {dtype}   {ms:9.3f} ms  {100 * ms / busy:5.1f}%  "
              f"{name[:110]}", flush=True)
    out_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out_dir / f"profile_{what}_{dtype}.json"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="60 for the train step, 256 with --eval")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--eval", action="store_true",
                    help="profile the bf16 eval forward")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"[profile] {card}", flush=True)
    if args.eval:
        profile("bfloat16", args.batch or 256, args.steps,
                torch.device("cuda:0"), REPO / "output", evaluate=True)
        return 0
    for dtype in ("float32", "bfloat16"):
        profile(dtype, args.batch or 60, args.steps, torch.device("cuda:0"),
                REPO / "output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
