"""Epipolar geometry of a relative pose, in torch.

Counterpart of ``rel_pose_tpu/geom/epipolar.py:17-63``: the essential
matrix E = [t]x R of a pose ``[t, q]`` (W-last quaternion), the
fundamental matrix F = K2^-T E K1^-1, and the epipolar lines in image 2 of
points of image 1.  Every function keeps its input's dtype and device.
"""

import torch

from .quaternion import quat_to_matrix


def skew(t):
    """Cross-product matrix [t]x of ``(..., 3)`` -> ``(..., 3, 3)``."""
    x, y, z = t.unbind(-1)
    zeros = torch.zeros_like(x)
    m = torch.stack([zeros, -z, y,
                     z, zeros, -x,
                     -y, x, zeros], dim=-1)
    return m.reshape(t.shape[:-1] + (3, 3))


def essential_from_pose(pose):
    """E = [t]x R from a pose ``(..., 7) = [t, q]``."""
    return torch.matmul(skew(pose[..., :3]), quat_to_matrix(pose[..., 3:]))


def fundamental_from_essential(E, K1, K2):
    """F = K2^-T E K1^-1."""
    k2_inv_t = torch.linalg.inv(K2).transpose(-1, -2)
    return torch.matmul(torch.matmul(k2_inv_t, E), torch.linalg.inv(K1))


def compute_correspond_epilines(points_h, F):
    """Epipolar lines in image 2 of homogeneous points ``(..., N, 3)`` of
    image 1: ``(..., N, 3)`` coefficients (a, b, c) of a x + b y + c = 0,
    scaled so that (a, b) has unit length (lines with a = b = 0 are left
    as they are)."""
    lines = torch.einsum("...ij,...nj->...ni", F, points_h)
    a, b = lines[..., 0], lines[..., 1]
    nu = a * a + b * b
    nu = torch.where(nu > 0.0,
                     1.0 / torch.sqrt(torch.clamp(nu, min=1e-30)),
                     torch.ones_like(nu))
    return lines * nu[..., None]


def epiline_slope_intercept(line):
    """(a, b, c) -> the slope and intercept (m, b) of y = m x + b."""
    m = -line[..., 0] / line[..., 1]
    b = -line[..., 2] / line[..., 1]
    return m, b
