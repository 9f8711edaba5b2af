"""rel_pose_tpu_torch -- the PyTorch + CUDA (Hopper) port of rel_pose_tpu.

A second package beside the JAX one, which stays the reference.  It holds
the eval forward served by ``PosePredictor`` and the single-GPU training
step of the flagship and the --noess configurations; it imports ``torch`` and never ``jax``, nor anything of the
JAX package (``config.ModelConfig`` is a pinned copy of the JAX one).

Layer map (bottom-up), each module named after its JAX counterpart:
  config    ModelConfig
  csrc/     hand-written CUDA kernels for sm_90a (ViT stack, essential
            block and the --noess attention, forward and backward)
  geom/     SE(3) compose / inverse / log and the geodesic loss
  nn/       layers (eval-folded and training BatchNorm), ResNet-18 trunk,
            extractor block, ViT block
  ops/      image preprocessing, positional encoding, the kernel wrappers
            (autograd Functions) with their plain PyTorch versions, and the
            nvcc build
  models/   ViTEss: image pair -> (B, 2, 7) poses
  train/    train_step / eval_step, Adam + OneCycle, .pth checkpoints
  utils/    weights from the JAX package or a reference .pth
  infer     PosePredictor, the serving entry point
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: importing the package pulls in neither torch nor the kernels
    if name == "ModelConfig":
        from .config import ModelConfig
        return ModelConfig
    if name in ("ViTEss", "normalize_preds"):
        from .models import vitess
        return getattr(vitess, name)
    if name == "PosePredictor":
        from .infer import PosePredictor
        return PosePredictor
    raise AttributeError(
        f"module 'rel_pose_tpu_torch' has no attribute {name!r}")
