"""The precision of fp32 matrix products and convolutions on the GPU.

Counterpart of the JAX package's ``RELPOSE_MATMUL_PRECISION``
(``rel_pose_tpu/utils/platform.py``): one knob, read from the same
environment variable, that the port's entry points apply
(``ViTEss`` construction, ``PosePredictor``, ``train_step``), so that an fp32
result does not depend on the caller's global torch flags.

  * ``"highest"`` (the default): full fp32.  cuBLAS matmuls and cuDNN
    convolutions both run without TF32.
  * ``"high"``: TF32 for both, about three decimal digits of mantissa.

PyTorch's own defaults disagree with each other: cuBLAS fp32 matmuls run
in full fp32, cuDNN fp32 convolutions in TF32.  The knob sets both flags.
bf16 activations are not affected.
"""

import os

import torch

ENV = "RELPOSE_MATMUL_PRECISION"
DEFAULT = "highest"
# value -> allow_tf32 for cuBLAS matmuls and cuDNN convolutions
_TF32 = {"highest": False, "high": True}


def apply_matmul_precision():
    """Set ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` for ``$RELPOSE_MATMUL_PRECISION``
    (``"highest"`` when unset); returns the value applied.  Raises
    ``ValueError`` on another value."""
    value = os.environ.get(ENV) or DEFAULT
    if value not in _TF32:
        raise ValueError(f"{ENV}={value!r}: expected one of {sorted(_TF32)}")
    torch.backends.cuda.matmul.allow_tf32 = _TF32[value]
    torch.backends.cudnn.allow_tf32 = _TF32[value]
    return value
