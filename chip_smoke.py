#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):

  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
     TF32 off for matmuls and cuDNN convs, so fp32 means fp32;
  2. build the hand-written CUDA kernels from ``rel_pose_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version on the card, fp32 and
     bf16 (ViT stack at G=16 sequences, essential block at B=8 pairs);
  4. the slice: ``PosePredictor`` over the flagship ``ViTEss`` (depth 6,
     seeded random weights) answers InteriorNet-style 256x256 requests of
     1, 5 and 8 pairs and a Matterport-style 480x640 request resized to
     384x512, in fp32 and bf16, at batch_size 8.  Poses must be finite,
     (B, 2, 7), pose 0 the identity, unit quaternions (or the 0.01-floor
     case), agree with the plain path on the card, and every kernel's launch
     counter must have risen during this phase;
  5. times (CUDA events, after warm-up): each kernel and its plain version
     at the eval shapes of batch 256 in bf16, and the eval forward in
     pairs/s at batch 256, 256x256 uint8, bf16, preprocessing included.

The line before the last is the card's name and power limit; the last is
``{"ok": true, "device": {...}}``.  The run needs no network and starts no
process besides ``nvidia-smi`` and ``nvcc``, which it waits for.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
EVAL_BATCH = 256        # bench.py's eval protocol
NVSMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]
# (fp32, bf16) tolerances, each against the plain PyTorch version on the
# card.  Tokens: |err| <= atol + rtol * max|ref| -- the kernels sum in
# another order, and in bf16 a sum-order flip moves a rounding by one ulp
# (2^-8 relative: 0.0625 at |x| in [8, 16)), which later blocks carry on; the
# bf16 bound is 2e-2 * max|ref|, about 4 ulps of the largest token (2 ulps
# measured on an H100).  F: |err| <= rtol * max|F|.  Poses: |err| <= atol
# (quaternion entries are at most 1; bf16 flips upstream reach the fp32
# regressor).
TOKEN_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (3e-2, 2e-2)}
F_RTOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
POSE_ATOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
DTYPES = (torch.float32, torch.bfloat16)


def log(*args):
    print(*args, flush=True)


def cuda_time_ms(fn, iters, warmup=1):
    """Mean milliseconds of ``fn()`` between CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- inputs --

def vit_inputs(rng, G, dtype, device, depth=5, C=192, hidden=768):
    """Tokens, (1, N, C) pos and stacked block params at the model's
    widths, drawn from ``rng``; weights scaled like PyTorch's init."""
    def t(shape, scale):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)
        ).to(device)
    stacked = {
        "ln1_scale": 1 + t((depth, C), 0.1), "ln1_bias": t((depth, C), 0.1),
        "qkv_w": t((depth, 3 * C, C), C ** -0.5),
        "qkv_b": t((depth, 3 * C), 0.1),
        "proj_w": t((depth, C, C), C ** -0.5), "proj_b": t((depth, C), 0.1),
        "ln2_scale": 1 + t((depth, C), 0.1), "ln2_bias": t((depth, C), 0.1),
        "fc1_w": t((depth, hidden, C), C ** -0.5),
        "fc1_b": t((depth, hidden), 0.1),
        "fc2_w": t((depth, C, hidden), hidden ** -0.5),
        "fc2_b": t((depth, C), 0.1)}
    x = t((G, 576, C), 1.0).to(dtype)
    pos = t((1, 576, C), 0.02).to(dtype)
    return x, {k: v.to(dtype) for k, v in stacked.items()}, pos


def essential_inputs(rng, B, dtype, device, C=192):
    def t(shape, scale):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)
        ).to(device)
    xpair = t((B, 2, 576, C), 1.0).to(dtype)
    ln = (1 + t((C,), 0.1), t((C,), 0.1))
    qkv = (t((3 * C, C), C ** -0.5), t((3 * C,), 0.1))
    positional = t((B, 576, 6), 1.0)
    return xpair, ln, qkv, positional


# ---------------------------------------------------------------- phases --

def phase_device():
    smi = subprocess.run(NVSMI_QUERY, capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip()
    log(f"[device] nvidia-smi: {card}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[device] cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return card


def phase_build():
    from rel_pose_tpu_torch.ops import _build
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def check_tokens(name, out, ref, dtype, failures):
    atol, rtol = TOKEN_TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    scale = ref.float().abs().max().item()
    tol = atol + rtol * scale
    ok = bool(np.isfinite(err)) and err <= tol
    log(f"[check] {name} {str(dtype)[6:]}: max_abs_err={err:.3e} "
        f"mean_abs_err={diff.mean().item():.3e} max|ref|={scale:.3f} "
        f"tol={tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name} {dtype}")
    return err


def check_f(name, out, ref, dtype, failures):
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    ok = bool(np.isfinite(err)) and err <= F_RTOL[dtype] * scale
    log(f"[check] {name} {str(dtype)[6:]}: max_abs_err={err:.3e} "
        f"max|ref|={scale:.3f} rel={err / scale:.3e} "
        f"rtol={F_RTOL[dtype]:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name} {dtype}")
    return err


def phase_kernels(device):
    from rel_pose_tpu_torch.ops.essential_block import (
        essential_block_pair_reference, fused_essential_block_pair)
    from rel_pose_tpu_torch.ops.vit_stack import (fused_vit_stack,
                                                  vit_stack_reference)
    failures = []
    for dtype in DTYPES:
        rng = np.random.default_rng(SEED)
        x, stacked, pos = vit_inputs(rng, 16, dtype, device)
        out = fused_vit_stack(x, stacked, 3, pos)
        torch.cuda.synchronize()
        check_tokens("vit_stack G=16 depth=5", out,
                     vit_stack_reference(x, stacked, 3, pos), dtype,
                     failures)
        args = essential_inputs(rng, 8, dtype, device)
        f = fused_essential_block_pair(*args, 3)
        torch.cuda.synchronize()
        check_f("essential_block B=8", f,
                essential_block_pair_reference(*args, 3), dtype, failures)
    if failures:
        raise SystemExit(f"kernel checks failed: {failures}")


def make_models(device):
    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.models.vitess import ViTEss
    from rel_pose_tpu_torch.nn.init import seeded_state_dict
    models = {}
    sd = None
    for dtype in DTYPES:
        cfg = ModelConfig(compute_dtype=str(dtype)[6:])   # depth 6
        for kernels in (True, False):
            m = ViTEss(cfg, device=device, kernels=kernels)
            if sd is None:
                sd = seeded_state_dict(m, SEED)
            m.load_state_dict(sd)
            models[dtype, kernels] = m
    return models


def requests(rng):
    """(name, images, intrinsics, image_size) request mix."""
    from rel_pose_tpu_torch.infer import (INTERIORNET_STREETLEARN_INTRINSICS,
                                          MATTERPORT_INTRINSICS)
    out = [(f"interiornet n={n}",
            rng.integers(0, 256, (n, 2, 3, 256, 256), dtype=np.uint8),
            INTERIORNET_STREETLEARN_INTRINSICS, None) for n in (1, 5, 8)]
    out.append(("matterport n=3",
                rng.integers(0, 256, (3, 2, 3, 480, 640), dtype=np.uint8),
                MATTERPORT_INTRINSICS, (384, 512)))
    return out


def check_poses(name, dtype, poses, plain, n, failures):
    problems = []
    if poses.shape != (n, 2, 7):
        problems.append(f"shape {poses.shape}")
    if not np.isfinite(poses).all():
        problems.append("non-finite")
    ident = np.array([0, 0, 0, 0, 0, 0, 1], np.float32)
    if not (poses[:, 0] == ident).all():
        problems.append("pose 0 is not the identity")
    qn = np.linalg.norm(poses[:, 1, 3:], axis=-1)
    qn_plain = np.linalg.norm(plain[:, 1, 3:], axis=-1)
    unit = np.abs(qn - 1) < 1e-3
    floor = (qn < 1) & (qn_plain < 0.99)    # |q_raw| < 0.01: q / 0.01
    if not (unit | floor).all():
        problems.append(f"quaternion norms {qn}")
    err = float(np.abs(poses - plain).max())
    if not err <= POSE_ATOL[dtype]:
        problems.append(f"vs plain {err:.3e} > {POSE_ATOL[dtype]:.0e}")
    log(f"[slice] {name} {str(dtype)[6:]}: shape {poses.shape} "
        f"|q| in [{qn.min():.6f}, {qn.max():.6f}] "
        f"max_abs_err_vs_plain={err:.3e} "
        f"{'ok' if not problems else 'FAIL ' + '; '.join(problems)}")
    if problems:
        failures.append(f"{name} {dtype}")


def phase_slice(device, models):
    from rel_pose_tpu_torch.infer import PosePredictor
    from rel_pose_tpu_torch.ops.essential_block import \
        fused_essential_block_pair
    from rel_pose_tpu_torch.ops.vit_stack import fused_vit_stack
    reqs = requests(np.random.default_rng(SEED + 1))

    def serve(kernels):
        out = {}
        for dtype in DTYPES:
            for name, images, intr, size in reqs:
                pred = PosePredictor(models[dtype, kernels], intrinsics=intr,
                                     batch_size=8, image_size=size)
                out[name, dtype] = pred.predict_batch(images)
        return out

    fused_vit_stack.launches = 0
    fused_essential_block_pair.launches = 0
    got = serve(kernels=True)
    torch.cuda.synchronize()
    launches = {"vit_stack": fused_vit_stack.launches,
                "essential_block": fused_essential_block_pair.launches}
    log(f"[slice] kernel launches during the slice: {launches}")
    plain = serve(kernels=False)
    failures = [f"{k} never launched" for k, v in launches.items()
                if v <= 0]
    for (name, dtype), poses in got.items():
        n = next(len(r[1]) for r in reqs if r[0] == name)
        check_poses(name, dtype, poses, plain[name, dtype], n, failures)
    if failures:
        raise SystemExit(f"slice checks failed: {failures}")
    return launches


def phase_times(device, models, card):
    from rel_pose_tpu_torch.ops.essential_block import (
        essential_block_pair_reference, fused_essential_block_pair)
    from rel_pose_tpu_torch.ops.vit_stack import (fused_vit_stack,
                                                  vit_stack_reference)
    B = EVAL_BATCH
    dtype = torch.bfloat16
    rng = np.random.default_rng(SEED + 2)
    rows = {}
    failures = []

    x, stacked, pos = vit_inputs(rng, 2 * B, dtype, device)
    out = fused_vit_stack(x, stacked, 3, pos)
    ref = vit_stack_reference(x, stacked, 3, pos)
    err = check_tokens(f"vit_stack G={2 * B} depth=5", out, ref, dtype,
                       failures)
    del out, ref
    ms = cuda_time_ms(lambda: fused_vit_stack(x, stacked, 3, pos), 3)
    plain_ms = cuda_time_ms(lambda: vit_stack_reference(x, stacked, 3, pos),
                            3)
    rows["vit_stack"] = (err, ms, plain_ms)
    del x, stacked, pos

    args = essential_inputs(rng, B, dtype, device)
    f = fused_essential_block_pair(*args, 3)
    err = check_f(f"essential_block B={B}", f,
                  essential_block_pair_reference(*args, 3), dtype, failures)
    del f
    ms = cuda_time_ms(lambda: fused_essential_block_pair(*args, 3), 3)
    plain_ms = cuda_time_ms(
        lambda: essential_block_pair_reference(*args, 3), 3)
    rows["essential_block"] = (err, ms, plain_ms)
    del args
    if failures:
        raise SystemExit(f"batch-256 kernel checks failed: {failures}")
    for name, (err, ms, plain_ms) in rows.items():
        log(f"[time] {name} bf16 batch {B}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms ({card})")

    images = torch.from_numpy(rng.integers(
        0, 256, (B, 2, 3, 256, 256), dtype=np.uint8)).to(device)
    intr = torch.full((B, 2, 4), 128.0, device=device)
    for kernels in (True, False):
        model = models[dtype, kernels]
        ms = cuda_time_ms(lambda: model(images, intr), 3)
        log(f"[time] eval forward bf16 batch {B} 256x256 uint8 "
            f"({'kernels' if kernels else 'plain path'}): {ms:.3f} ms, "
            f"{B / ms * 1e3:.2f} pairs/s ({card})")
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    device = torch.device("cuda:0")
    card = phase_device()
    phase_build()
    phase_kernels(device)
    models = make_models(device)
    launches = phase_slice(device, models)
    rows = phase_times(device, models, card)
    sources = {
        "vit_stack": ("rel_pose_tpu_torch/csrc/vit_stack.cu",
                      "rel_pose_tpu/ops/pallas_vit.py:94"),
        "essential_block": ("rel_pose_tpu_torch/csrc/essential_block.cu",
                            "rel_pose_tpu/ops/pallas_essential_block.py:225"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": rows[name][0], "ms": rows[name][1],
                "plain_ms": rows[name][2]}
               for name, (src, rep) in sources.items()]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
