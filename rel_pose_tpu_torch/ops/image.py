"""Image preprocessing on tensors.

Counterpart of ``rel_pose_tpu/ops/image.py:82-95,144-153``.  The reference
resizes with torch's legacy nearest mode, whose source index is
``floor(i * in / out)``; ``F.interpolate`` computes it through a float
scale, so here it is the exact integer gather ``(arange(out) * in) // out``.
"""

import torch

# ImageNet statistics (reference src/model.py:116-117)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def nearest_resize(x, size):
    """Resize the last two (H, W) axes, nearest, torch semantics.  Any
    dtype, uint8 included; ``size`` is an int or (out_h, out_w)."""
    if isinstance(size, int):
        size = (size, size)
    for axis, n_out in ((-2, size[0]), (-1, size[1])):
        n_in = x.shape[axis]
        if n_in != n_out:
            idx = torch.arange(n_out, device=x.device) * n_in // n_out
            x = x.index_select(axis, idx)
    return x


def scale_intrinsics(intrinsics, input_hw, grid_hw=(24, 24)):
    """Rescale ``(..., 4) = [fx, fy, cx, cy]`` from the input resolution
    (the last two entries of ``input_hw``) to the feature grid."""
    sizey, sizex = grid_hw
    scalex = sizex / input_hw[-1]
    scaley = sizey / input_hw[-2]
    scale = torch.tensor([scalex, scaley, scalex, scaley],
                         dtype=intrinsics.dtype, device=intrinsics.device)
    return intrinsics * scale


def normalization_constants(dtype, device):
    """The stem's folded input normalization (``models/vitess.py:143-175``
    of the JAX package): the BGR mean times 255, subtracted from the raw
    0-255 BGR image in ``dtype``, shape (3, 1, 1); and 1 / (255 * std) in
    BGR order, shape (1, 3, 1, 1), multiplied into conv1's channel-flipped
    fp32 weight.  conv(x - mean, w.flip(1) * inv_std) equals the reference's
    conv of the normalized RGB image, zero padding included."""
    mean = torch.tensor([255.0 * m for m in IMAGENET_MEAN[::-1]],
                        dtype=dtype, device=device).reshape(3, 1, 1)
    inv_std = torch.tensor([1.0 / (255.0 * s) for s in IMAGENET_STD[::-1]],
                           dtype=torch.float32,
                           device=device).reshape(1, 3, 1, 1)
    return mean, inv_std
