"""Gradient check on the card: the hand kernels' training gradient against
the plain path's, triangulated against a float64 reference.

    python -m rel_pose_tpu_torch.tools.check_grads
    CHECK_DTYPE=bfloat16 CHECK_BATCH=4 \
        python -m rel_pose_tpu_torch.tools.check_grads

Counterpart of ``scripts/check_grads_hw.py`` with its defaults:
``CHECK_DTYPE`` (float32 or bfloat16, default float32), ``CHECK_BATCH``
(default 4); the flagship at full width, depth 6 (``--depth``), 384x512
float images, the train loss (w 10 / 10) of one batch, BatchNorm on batch
statistics.  Three gradients of every parameter, from the same weights
(PyTorch's default initializers under ``torch.manual_seed(0)``) and the
same seeded batch:

  * fused: the model with its hand kernels;
  * stock: the plain path (``kernels=False``) at the same dtype;
  * reference: the plain path in float64 -- every fp32 cast made float64,
    as ``tests/test_torch_train.py``'s float64 check makes it -- in a child
    process on the same device, since the casts are patched globally.  If
    that child fails, the plain fp32 path with TF32 off is the reference
    instead, and the report says which ran.

``utils.gradcheck.triangulate`` gates each leaf with the JAX script's
gates: headroom 3; fp32 normrel 5e-3, cosine 0.999; bf16 5e-2, 0.99.  It
prints the top 5 leaves of each path and exits 1 if a leaf fails.

The fc3 bias is conditioned as ``check_grads_hw.py:44-52`` does: at random
initialization the predicted quaternions sit near the max(|q|, 0.01)
floor, where a 1e-3 difference in the forward flips the branch and makes
raw gradient differences meaningless; a bias of 1 on the two quaternion W
entries puts the loss in its smooth regime.
"""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from . import child_env

HEADROOM = 3.0
GATES = {"float32": (5e-3, 0.999), "bfloat16": (5e-2, 0.99)}


def model_config(dtype, depth=6):
    from ..config import ModelConfig
    return ModelConfig(compute_dtype=dtype, transformer_depth=depth)


def conditioned_state_dict(cfg):
    """PyTorch's default initializers under ``torch.manual_seed(0)`` (the
    training CLI's weights), fc3's bias at 1 on the quaternion W entries
    (regressor outputs 6 and 13)."""
    from ..cli.train import build_model
    sd = build_model(cfg, "cpu").state_dict()
    sd["pose_regressor.4.bias"][6] = 1.0
    sd["pose_regressor.4.bias"][13] = 1.0
    return sd


def check_batch(batch):
    """The JAX script's batch as numpy: images uniform in [0, 255) float32
    (B, 2, 3, 384, 512), pose 1 a rotation about x of 0.2 / 0.98 and a
    translation of 0.3 along x, Matterport intrinsics."""
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (batch, 2, 3, 384, 512)).astype(np.float32)
    poses = np.zeros((batch, 2, 7), np.float32)
    poses[..., 6] = 1.0
    poses[:, 1, 0] = 0.3
    poses[:, 1, 4] = 0.2
    poses[:, 1, 6] = np.sqrt(1 - 0.04)
    intr = np.tile(np.array([[517.97, 517.97, 320, 240]], np.float32),
                   (batch, 2, 1))
    return images, poses, intr


def gradients(cfg, sd, arrays, device, kernels, dtype=None):
    """{parameter name: gradient on the host} of the train loss of one
    batch; ``dtype`` casts the model and the batch (float64)."""
    from ..models.vitess import ViTEss
    from ..train.step import loss_fn
    model = ViTEss(cfg, device=device, kernels=kernels)
    model.load_state_dict(sd)
    if dtype is not None:
        model.to(dtype)
    model.train()
    batch = [torch.from_numpy(a).to(device) for a in arrays]
    if dtype is not None:
        batch = [t.to(dtype) for t in batch]
    loss, _, _ = loss_fn(model, *batch)
    loss.backward()
    return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def reference_command(out, batch, device, depth=6):
    """argv of the float64 reference's child process, which writes its
    gradients to ``out``."""
    return [sys.executable, "-m", "rel_pose_tpu_torch.tools.check_grads",
            "--reference-child", str(out), "--batch", str(batch),
            "--device", str(device), "--depth", str(depth)]


def reference_child(out, batch, device, depth):
    """In this (child) process: every fp32 cast made float64 (the dtype
    object, ``Tensor.float`` and the model's compute dtype), then the plain
    path's gradients saved to ``out``."""
    from ..models import vitess
    cfg = model_config("float32", depth)
    sd = conditioned_state_dict(cfg)
    torch.float32 = torch.float64
    torch.Tensor.float = lambda self, *a, **k: self.double()
    vitess.ViTEss.compute_dtype = property(lambda self: torch.float64)
    grads = gradients(cfg, sd, check_batch(batch), device, False,
                      torch.float64)
    torch.save(grads, out)


def reference_from_child(returncode, out, output, batch, device,
                         depth=6):
    """(gradients, label): the float64 child's file ``out``, or, when the
    child failed (its ``output`` printed), the plain fp32 path with TF32
    off (``RELPOSE_MATMUL_PRECISION=highest`` while it runs)."""
    if returncode == 0 and os.path.exists(out):
        return torch.load(out, weights_only=True), "float64 plain path"
    print(f"float64 reference failed (exit {returncode}): "
          f"{output[-2000:]}", flush=True)
    from ..utils import precision
    cfg = model_config("float32", depth)
    prev = os.environ.get(precision.ENV)
    os.environ[precision.ENV] = "highest"
    try:
        grads = gradients(cfg, conditioned_state_dict(cfg),
                          check_batch(batch), device, False)
    finally:
        if prev is None:
            os.environ.pop(precision.ENV)
        else:
            os.environ[precision.ENV] = prev
        precision.apply_matmul_precision()
    return grads, "fp32 plain path, TF32 off (float64 failed)"


def reference(batch, device, depth=6):
    """(gradients, label) of :func:`reference_from_child`, the child run
    here."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "reference.pt")
        r = subprocess.run(reference_command(out, batch, device, depth),
                           env=child_env(), capture_output=True, text=True,
                           timeout=900)
        return reference_from_child(r.returncode, out, r.stdout + r.stderr,
                                    batch, device, depth)


def check(dtype, batch, device, ref, depth=6, log=print):
    """Triangulate the fused and stock gradients at ``dtype`` against
    ``ref``; prints the report, returns ``triangulate``'s tuple."""
    from ..utils.gradcheck import report, triangulate
    cfg = model_config(dtype, depth)
    sd = conditioned_state_dict(cfg)
    arrays = check_batch(batch)
    fused = gradients(cfg, sd, arrays, device, True)
    stock = gradients(cfg, sd, arrays, device, False)
    normrel_tol, cos_min = GATES[dtype]
    ok, failures, fused_rows, stock_rows = triangulate(
        fused, stock, ref, headroom=HEADROOM, normrel_tol=normrel_tol,
        cos_min=cos_min)
    log(f"dtype={dtype} batch={batch} depth={depth}: per-leaf "
        f"triangulation, {len(fused)} leaves")
    report("fused kernel path", fused_rows, log=log)
    report("plain path at the same dtype (noise yardstick)", stock_rows,
           log=log)
    log(f"{'OK' if ok else 'FAIL'}: gates normrel <= max({HEADROOM:g}x "
        f"stock same-leaf, {normrel_tol}) and cos >= {cos_min} on every "
        f"leaf")
    for f in failures:
        log(f"  FAILED {f}")
    return ok, failures, fused_rows, stock_rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m rel_pose_tpu_torch.tools.check_grads")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--batch", type=int,
                    default=int(os.environ.get("CHECK_BATCH", "4")))
    ap.add_argument("--reference-child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.reference_child:
        reference_child(args.reference_child, args.batch, args.device,
                        args.depth)
        return 0
    dtype = os.environ.get("CHECK_DTYPE", "float32")
    if dtype not in GATES:
        raise SystemExit(f"CHECK_DTYPE={dtype}: float32 or bfloat16")
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("check_grads: no CUDA device (pass --device cpu "
                         "to rehearse on the CPU)")
    ref, label = reference(args.batch, args.device, args.depth)
    print(f"reference: {label}", flush=True)
    ok = check(dtype, args.batch, args.device, ref, args.depth)[0]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
