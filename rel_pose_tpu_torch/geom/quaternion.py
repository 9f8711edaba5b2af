"""Quaternions, W-last ``[qx, qy, qz, qw]``.

Counterpart of ``rel_pose_tpu/geom/quaternion.py``: the products on tensors
that ``geom.lie`` needs (``:27-58``), batched over leading dimensions and
differentiable by autograd, with ``quat_to_matrix`` and
``geodesic_angle_from_matrices`` (``:60,156``), which keep their input's
dtype, for the eval CLIs' metrics and the epipolar tool; and, in numpy
float32 as the JAX versions
compute, the rotation helpers the InteriorNet / StreetLearn readers need
(``:74-153``): ``matrix_to_quat``, ``rotation_from_viewpoint`` and
``relative_rotation_from_viewpoints``.
"""

import numpy as np
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


def quat_to_matrix(q):
    """Unit quaternions ``(..., 4)`` W-last -> rotation matrices
    ``(..., 3, 3)``."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def geodesic_angle_from_matrices(m1, m2):
    """Geodesic angle (radians) between rotation matrices ``(..., 3, 3)``:
    arccos((tr(m1 m2^T) - 1) / 2), the cosine clipped to [-1, 1]."""
    m = torch.matmul(m1, m2.transpose(-1, -2))
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


# ------------------------------------------------ numpy, for the datasets --

def matrix_to_quat(m):
    """Rotation matrices ``(..., 3, 3)`` -> unit quaternions ``(..., 4)``
    W-last, float32: Shepperd's method (the largest of the four candidate
    decodings), sign-normalized to w >= 0, then renormalized."""
    m = np.asarray(m, np.float32)
    one, two, quarter = np.float32(1), np.float32(2), np.float32(0.25)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw2 = one + (m00 + m11 + m22)
    qx2 = one + m00 - m11 - m22
    qy2 = one - m00 + m11 - m22
    qz2 = one - m00 - m11 + m22

    def s(v):
        return two * np.sqrt(np.maximum(v, np.float32(1e-24)))

    sw, sx, sy, sz = s(qw2), s(qx2), s(qy2), s(qz2)
    cands = np.stack([
        np.stack([sx * quarter, (m01 + m10) / sx, (m02 + m20) / sx,
                  (m21 - m12) / sx], axis=-1),
        np.stack([(m01 + m10) / sy, sy * quarter, (m12 + m21) / sy,
                  (m02 - m20) / sy], axis=-1),
        np.stack([(m02 + m20) / sz, (m12 + m21) / sz, sz * quarter,
                  (m10 - m01) / sz], axis=-1),
        np.stack([(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw,
                  sw * quarter], axis=-1)], axis=-2)
    best = np.argmax(np.stack([qx2, qy2, qz2, qw2], axis=-1), axis=-1)
    q = np.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    q = q * np.where(q[..., 3:4] < 0, np.float32(-1), np.float32(1))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def rotation_from_viewpoint(rotation_x, rotation_y):
    """``(..., 3, 3)`` float32 rotation from (pitch x, yaw y) viewpoint
    angles: the reference's ``compute_rotation_matrix_from_viewpoint``
    (``src/data_readers/interiornet.py:27-43``)."""
    rotax = np.asarray(rotation_x, np.float32)
    rotay = -np.asarray(rotation_y, np.float32)
    c1, s1 = np.cos(rotax), np.sin(rotax)
    c2, s2 = np.cos(rotay), np.sin(rotay)
    zeros = np.zeros_like(c1)
    return np.stack([np.stack([c2, s1 * s2, c1 * s2], axis=-1),
                     np.stack([zeros, c1, -s1], axis=-1),
                     np.stack([-s2, s1 * c2, c1 * c2], axis=-1)], axis=-2)


def relative_rotation_from_viewpoints(x1, y1, x2, y2):
    """The ground-truth relative rotation R2 R1^T of two viewpoints
    (``compute_gt_rmat``, ``src/data_readers/interiornet.py:45-49``)."""
    m1 = rotation_from_viewpoint(x1, y1)
    m2 = rotation_from_viewpoint(x2, y2)
    return np.matmul(m2, np.swapaxes(m1, -1, -2))
