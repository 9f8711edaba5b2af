#!/usr/bin/env python3
"""Profile the PyTorch port's training step on one NVIDIA GPU.

    python3 scripts/profile_torch_train.py [--batch 60] [--steps 3]

The flagship ``ViTEss`` (depth 6, seeded weights) with the hand kernels
takes ``--steps`` ``train_step``s on Matterport-style 384x512 uint8 batches
(bench.py's train protocol, made by ``chip_smoke.train_batch``) in fp32 and then bf16, after two warm-up steps,
under ``torch.profiler`` (CPU and CUDA).  For each dtype it prints the step
time (CUDA events), the device-busy time per step (the sum of kernel times
on the one stream) and its share of the step, and the kernels by device
time per step.  It writes each trace to
``output/profile_train_<dtype>.json``.  Needs a CUDA device.
"""

import argparse
import pathlib
import subprocess
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def profile(dtype, B, steps, device, out_dir):
    from torch.profiler import ProfilerActivity
    from chip_smoke import train_batch
    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.models.vitess import ViTEss
    from rel_pose_tpu_torch.nn.init import seeded_state_dict
    from rel_pose_tpu_torch.train.optim import make_optimizer
    from rel_pose_tpu_torch.train.step import train_step
    model = ViTEss(ModelConfig(compute_dtype=dtype), device=device)
    model.load_state_dict(seeded_state_dict(model, 0))
    opt, sched = make_optimizer(model, lr=5e-4, steps=1000, warmup=100)
    data = train_batch(np.random.default_rng(0), B, device)
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
    print(f"[profile] {dtype} batch {B}: step {step_ms:.3f} ms, "
          f"{B / step_ms * 1e3:.2f} pairs/s; device busy {busy:.3f} ms per "
          f"step, {100 * busy / step_ms:.2f}% of the step", flush=True)
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:30]:
        print(f"[profile] {dtype}   {ms:9.3f} ms  {100 * ms / busy:5.1f}%  "
              f"{name[:110]}", flush=True)
    out_dir.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out_dir / f"profile_train_{dtype}.json"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=60)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"[profile] {card}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in ("float32", "bfloat16"):
        profile(dtype, args.batch, args.steps, torch.device("cuda:0"),
                REPO / "output")
    return 0


if __name__ == "__main__":
    sys.exit(main())
