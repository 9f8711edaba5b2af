"""Quadratic positional encoding of the Essential Matrix Module.

Counterpart of ``rel_pose_tpu/ops/posenc.py:29-102`` (reference
``vision_transformer.py:90-158``) with the reference's quirks kept:

  * tokens are ordered column-major, ``t = k*w + j`` with k over the width
    and j over the height;
  * only frame-0 intrinsics are used;
  * the principal point is taken as the image center: hpix = 2*cy,
    wpix = 2*cx.

The intrinsics arrive already scaled to the feature grid.  Output
``(B, N, 6)`` fp32 with columns ``(y^2, x^2, x*y, y, x, 1)``.  On a square
grid the unprojection overwrites every entry of the reference's initial
tables, so only the unprojected values are formed.
"""

import torch


def _grid_side(num_patches):
    r = round(num_patches ** 0.5)
    if r * r != num_patches:
        raise ValueError("intrinsics-unprojected positional encodings are "
                         f"defined for square grids only (N={num_patches})")
    return r


def quadratic_positional_encoding(num_patches, intrinsics):
    """``intrinsics (B, 2, 4)`` grid-scaled [fx, fy, cx, cy] -> (B, N, 6)."""
    n = _grid_side(num_patches)
    intr = intrinsics.float()
    ys = torch.linspace(-1.0, 1.0, n, dtype=intr.dtype, device=intr.device)
    xs = ys
    fx, fy, cx, cy = intr[:, 0].unbind(-1)
    wpix, hpix = cx * 2.0, cy * 2.0
    fx_n = (fx / wpix) * 2.0
    cx_n = (cx / wpix) * 2.0 - 1.0
    fy_n = (fy / hpix) * 2.0
    cy_n = (cy / hpix) * 2.0 - 1.0
    u2 = (ys[None, :] - cy_n[:, None]) / fy_n[:, None]    # (B, h): y
    u1 = (xs[None, :] - cx_n[:, None]) / fx_n[:, None]    # (B, w): x
    B = intr.shape[0]
    p3 = u2[:, None, :].expand(B, n, n).reshape(B, -1)    # p3[k*w + j] = u2[j]
    p4 = u1[:, :, None].expand(B, n, n).reshape(B, -1)    # p4[k*w + j] = u1[k]
    return torch.stack([p3 * p3, p4 * p4, p3 * p4, p3, p4,
                        torch.ones_like(p3)], dim=-1)
