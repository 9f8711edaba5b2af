"""rel_pose_tpu_torch -- the PyTorch + CUDA (Hopper) port of rel_pose_tpu.

A second package beside the JAX one, which stays the reference.  It holds
the eval forward served by ``PosePredictor``, the single-GPU training step,
the training CLI (``python -m rel_pose_tpu_torch.cli.train``) and the eval,
demo, epipolar and conversion CLIs of every configuration; it imports ``torch`` and never ``jax``, nor anything of the
JAX package (``config`` is a pinned copy of the JAX one, ``data`` and
``native`` are copies of the JAX package's).

Layer map (bottom-up), each module named after its JAX counterpart:
  config    ModelConfig
  csrc/     hand-written CUDA kernels for sm_90a (ViT stack, essential
            block and the --noess attention, forward and backward)
  geom/     SE(3) compose / inverse / log, the geodesic loss, quaternion
            matrices and the epipolar geometry
  nn/       layers (eval-folded and training BatchNorm), ResNet-18 trunk,
            extractor block, ViT block
  ops/      image preprocessing, positional encoding, the kernel wrappers
            (autograd Functions) with their plain PyTorch versions, and the
            nvcc build
  models/   ViTEss: image pair -> (B, 2, 7) poses
  train/    train_step / eval_step, Adam + OneCycle, .pth checkpoints
            and the JAX package's .ckpt, the logger
  data/     dataset readers, augmentation, the threaded loader
  native/   the host pipeline's C++ (built with make at first use)
  utils/    weights from the JAX package, a reference .pth or torchvision,
            flax's msgpack format, the precision knob, StepTimer
  infer     PosePredictor, the serving entry point
  cli/      train, the eval CLIs, demo, the epipolar tool and the
            checkpoint converter
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
