"""Positional encodings of the Essential Matrix Module.

Counterpart of ``rel_pose_tpu/ops/posenc.py`` (reference
``vision_transformer.py:37-158``) with the reference's quirks kept:

  * tokens are ordered column-major, ``t = k*w + j`` with k over the width
    and j over the height;
  * only frame-0 intrinsics are used;
  * the principal point is taken as the image center: hpix = 2*cy,
    wpix = 2*cx.

The intrinsics arrive already scaled to the feature grid.  Output
``(B, N, 6)`` fp32: columns ``(y^2, x^2, x*y, y, x, 1)`` for the quadratic
table, ``(1, 1, 1, y, x, 1)`` for the L1 table (``l1_pos_encoding``).  On a
square grid the unprojection overwrites every entry of the reference's
initial tables, so only the unprojected values are formed.  Without
intrinsics the tables are those initial ones, ``y[t] = ys[t % h]`` and
``x[t] = xs[t // h]``: the unprojection with the identity, and of batch 1
unless ``batch`` is given.
"""

import torch


def _grid_side(num_patches):
    r = round(num_patches ** 0.5)
    if r * r != num_patches:
        raise ValueError("intrinsics-unprojected positional encodings are "
                         f"defined for square grids only (N={num_patches})")
    return r


def _coords(num_patches, intrinsics, batch, device):
    """(y, x) coordinate tables, each ``(B, N)``."""
    n = _grid_side(num_patches)
    if intrinsics is None:
        ys = torch.linspace(-1.0, 1.0, n, device=device)
        u2 = u1 = ys[None]
        B = 1 if batch is None else batch
    else:
        intr = intrinsics.float()
        ys = torch.linspace(-1.0, 1.0, n, dtype=intr.dtype,
                            device=intr.device)
        fx, fy, cx, cy = intr[:, 0].unbind(-1)
        wpix, hpix = cx * 2.0, cy * 2.0
        fx_n = (fx / wpix) * 2.0
        cx_n = (cx / wpix) * 2.0 - 1.0
        fy_n = (fy / hpix) * 2.0
        cy_n = (cy / hpix) * 2.0 - 1.0
        u2 = (ys[None, :] - cy_n[:, None]) / fy_n[:, None]   # (B, h): y
        u1 = (ys[None, :] - cx_n[:, None]) / fx_n[:, None]   # (B, w): x
        B = intr.shape[0]
    p3 = u2[:, None, :].expand(B, n, n).reshape(B, -1)    # p3[k*w + j] = u2[j]
    p4 = u1[:, :, None].expand(B, n, n).reshape(B, -1)    # p4[k*w + j] = u1[k]
    return p3, p4


def quadratic_positional_encoding(num_patches, intrinsics=None, batch=None,
                                  device=None):
    """``intrinsics (B, 2, 4)`` grid-scaled [fx, fy, cx, cy], or None ->
    (B, N, 6) ``(y^2, x^2, xy, y, x, 1)``."""
    p3, p4 = _coords(num_patches, intrinsics, batch, device)
    return torch.stack([p3 * p3, p4 * p4, p3 * p4, p3, p4,
                        torch.ones_like(p3)], dim=-1)


def l1_positional_encoding(num_patches, intrinsics=None, batch=None,
                           device=None):
    """The same grid as (B, N, 6) ``(1, 1, 1, y, x, 1)``
    (``rel_pose_tpu/ops/posenc.py:105-113``; the reference comments the
    quadratic terms out)."""
    p3, p4 = _coords(num_patches, intrinsics, batch, device)
    ones = torch.ones_like(p3)
    return torch.stack([ones, ones, ones, p3, p4, ones], dim=-1)
