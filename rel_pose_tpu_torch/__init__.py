"""rel_pose_tpu_torch -- the PyTorch + CUDA (Hopper) port of rel_pose_tpu.

A second package beside the JAX one, which stays the reference.  This slice
is the flagship eval forward served by ``PosePredictor`` on one GPU; it
imports ``torch`` and never ``jax``, nor anything of the JAX package
(``config.ModelConfig`` is a pinned copy of the JAX one).

Layer map (bottom-up), each module named after its JAX counterpart:
  config    ModelConfig
  csrc/     hand-written CUDA kernels for sm_90a (ViT stack, essential block)
  nn/       eval-mode layers, ResNet-18 trunk, extractor block, ViT block
  ops/      image preprocessing, positional encoding, the kernel wrappers
            with their plain PyTorch versions, and the nvcc build
  models/   ViTEss: image pair -> (B, 2, 7) poses
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
