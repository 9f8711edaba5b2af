"""SE(3) / SO(3) group operations on 7-D pose tensors.

Counterpart of ``rel_pose_tpu/geom/lie.py`` (which replaced the
reference's lietorch): the identity, compose, inverse, the log map the
geodesic loss needs, the exp maps and the quaternion re-normalization.
Pose layout ``(..., 7) = [tx, ty, tz, qx, qy, qz, qw]`` (W-last unit
quaternion); tangent layout ``(..., 6) = [tau, phi]``.

Small angles take Taylor branches.  ``torch.where`` has the same gradient
pitfall as ``jnp.where``: the branch not taken is still differentiated, and
a NaN or inf there poisons the gradient.  So each branch is fed a safe
argument (the double-``where`` idiom), as in the JAX package.
"""

import torch

from .quaternion import quat_conjugate, quat_multiply, quat_rotate

_SMALL = 1e-8  # squared-angle cutoff for the Taylor branches (fp32-safe)


def se3_identity(shape=(), dtype=torch.float32, device=None):
    """Identity pose(s) of shape ``shape + (7,)``."""
    data = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    data[..., 6] = 1.0
    return data


def se3_identity_like(pose):
    """Identity poses of ``pose``'s batch shape, dtype and device
    (lietorch's ``SE3.IdentityLike``)."""
    return se3_identity(pose.shape[:-1], pose.dtype, pose.device)


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


def so3_exp(phi):
    """``(..., 3)`` -> unit quaternion ``(..., 4)`` W-last:
    [sin(t/2) / t * phi, cos(t/2)], Taylor 1/2 - t^2/48 and 1 - t^2/8 near
    t = 0."""
    theta2 = (phi * phi).sum(-1, keepdim=True)
    small = theta2 < _SMALL
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    half = 0.5 * theta
    imag = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    real = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([imag * phi, real], dim=-1)


def _hat(phi):
    """Skew-symmetric matrix of ``(..., 3)`` -> ``(..., 3, 3)``."""
    x, y, z = phi.unbind(-1)
    zeros = torch.zeros_like(x)
    m = torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros], dim=-1)
    return m.reshape(phi.shape[:-1] + (3, 3))


def _V_matrix(phi):
    """Left Jacobian V = I + a Phi + b Phi^2 with a = (1 - cos t) / t^2,
    b = (t - sin t) / t^3; a -> 1/2 - t^2/24, b -> 1/6 - t^2/120."""
    theta2 = (phi * phi).sum(-1)[..., None, None]
    small = theta2 < _SMALL
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2s)
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / t2s)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (t2s * theta))
    Phi = _hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a * Phi + b * torch.matmul(Phi, Phi)


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


def se3_exp(xi):
    """``(..., 6) = [tau, phi]`` -> ``(..., 7)`` pose."""
    tau, phi = xi[..., :3], xi[..., 3:]
    t = torch.matmul(_V_matrix(phi), tau[..., None])[..., 0]
    return torch.cat([t, so3_exp(phi)], dim=-1)


def se3_normalize_quat(pose, eps=0.01):
    """The quaternion block divided by max(|q|, eps), as
    ``models.vitess.normalize_preds`` does (the reference's
    ``src/model.py:148-151``)."""
    q = pose[..., 3:]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(eps)
    return torch.cat([pose[..., :3], q], dim=-1)
