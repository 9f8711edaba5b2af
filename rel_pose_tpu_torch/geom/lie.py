"""SE(3) / SO(3) group operations on 7-D pose tensors.

Counterpart of ``rel_pose_tpu/geom/lie.py:43-146`` (which replaced the
reference's lietorch): compose, inverse and the log map, all that the
geodesic loss needs.  Pose layout ``(..., 7) = [tx, ty, tz, qx, qy, qz, qw]``
(W-last unit quaternion); tangent layout ``(..., 6) = [tau, phi]``.

Small angles take Taylor branches.  ``torch.where`` has the same gradient
pitfall as ``jnp.where``: the branch not taken is still differentiated, and
a NaN or inf there poisons the gradient.  So each branch is fed a safe
argument (the double-``where`` idiom), as in the JAX package.
"""

import torch

from .quaternion import quat_conjugate, quat_multiply, quat_rotate

_SMALL = 1e-8  # squared-angle cutoff for the Taylor branches (fp32-safe)


def se3_compose(a, b):
    """Group product a * b: (t_a + R(q_a) t_b, q_a q_b)."""
    t = a[..., :3] + quat_rotate(a[..., 3:], b[..., :3])
    q = quat_multiply(a[..., 3:], b[..., 3:])
    return torch.cat([t, q], dim=-1)


def se3_inverse(a):
    """Group inverse: (-R(q)^-1 t, q^-1)."""
    qinv = quat_conjugate(a[..., 3:])
    t = -quat_rotate(qinv, a[..., :3])
    return torch.cat([t, qinv], dim=-1)


def so3_log(q):
    """Unit quaternion ``(..., 4)`` W-last -> ``(..., 3)``:
    phi = 2 atan2(|v|, w) / |v| * v, Taylor 2/w - 2|v|^2 / (3 w^3) near
    |v| = 0."""
    v = q[..., :3]
    w = q[..., 3:4]
    n2 = (v * v).sum(-1, keepdim=True)
    small = n2 < _SMALL
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    general = 2.0 * torch.atan2(n, w) / n
    # the dead branch is guarded too: w ~ 0 at 180 degrees
    ws = torch.where(small, w, torch.ones_like(w))
    taylor = 2.0 / ws - 2.0 * n2 / (3.0 * ws ** 3)
    return torch.where(small, taylor, general) * v


def _hat(phi):
    """Skew-symmetric matrix of ``(..., 3)`` -> ``(..., 3, 3)``."""
    x, y, z = phi.unbind(-1)
    zeros = torch.zeros_like(x)
    m = torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros], dim=-1)
    return m.reshape(phi.shape[:-1] + (3, 3))


def _V_inverse(phi):
    """Inverse left Jacobian V^-1 = I - Phi/2 + c Phi^2 with
    c = (1 - t cos(t/2) / (2 sin(t/2))) / t^2, c -> 1/12 + t^2/720."""
    theta2 = (phi * phi).sum(-1)[..., None, None]
    small = theta2 < _SMALL
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2s)
    half = 0.5 * theta
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - half * torch.cos(half) / torch.sin(half)) / t2s)
    Phi = _hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye - 0.5 * Phi + c * torch.matmul(Phi, Phi)


def se3_log(pose):
    """``(..., 7)`` pose -> ``(..., 6) = [tau, phi]``."""
    phi = so3_log(pose[..., 3:])
    tau = torch.matmul(_V_inverse(phi), pose[..., :3, None])[..., 0]
    return torch.cat([tau, phi], dim=-1)
