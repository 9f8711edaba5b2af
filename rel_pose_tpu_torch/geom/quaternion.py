"""Quaternion products on tensors, W-last ``[qx, qy, qz, qw]``.

Counterpart of ``rel_pose_tpu/geom/quaternion.py:27-58``: only what
``geom.lie`` needs.  Every function is batched over leading dimensions and
differentiable by autograd.
"""

import torch


def quat_multiply(q1, q2):
    """Hamilton product q1 * q2, both ``(..., 4)`` W-last."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    x = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2
    y = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2
    z = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2
    w = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2
    return torch.stack([x, y, z, w], dim=-1)


def quat_conjugate(q):
    """Conjugate (the inverse of a unit quaternion), ``(..., 4)`` W-last."""
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def quat_rotate(q, v):
    """Rotate ``v (..., 3)`` by unit quaternions ``q (..., 4)``:
    v' = v + 2 (w (u x v) + u x (u x v)), u the vector part."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)
