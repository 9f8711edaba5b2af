"""PyTorch port vs the JAX package: SE(3) geometry and the geodesic loss.

``rel_pose_tpu_torch.geom`` against ``rel_pose_tpu.geom`` on the same poses
drawn from a numpy seed, values and gradients (``jax.grad`` against
autograd), fp32 on the CPU.

Tolerances: values 1e-6 absolute (poses of unit scale through a few dozen
fp32 operations in the same order); gradients 1e-5 of the largest entry --
the log map's atan2 and the 3x3 products round differently in the two
frameworks, and its derivative divides by the rotation angle.  At a zero
residual both gradients must be exactly zero.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rel_pose_tpu.geom import lie as jlie
from rel_pose_tpu.geom.losses import geodesic_loss as jgeodesic_loss
from rel_pose_tpu_torch.geom import lie
from rel_pose_tpu_torch.geom.losses import geodesic_loss

RNG = np.random.default_rng(41)


def poses(B, angle=1.0, translate=0.5):
    """(B, 2, 7): pose 0 the identity, pose 1 a random rotation of about
    ``angle`` radians and a translation of about ``translate``."""
    out = np.zeros((B, 2, 7), np.float32)
    out[..., 6] = 1.0
    axis = RNG.standard_normal((B, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    half = 0.5 * angle * RNG.uniform(0.5, 1.0, (B, 1))
    out[:, 1, 3:6] = axis * np.sin(half)
    out[:, 1, 6] = np.cos(half[:, 0])
    out[:, 1, :3] = translate * RNG.standard_normal((B, 3))
    return out


def _loss_and_grad_jax(Ps, Gs):
    def f(g):
        lt, lr, _ = jgeodesic_loss(jnp.asarray(Ps), g)
        return 10.0 * lt + 10.0 * lr
    val, grad = jax.value_and_grad(f)(jnp.asarray(Gs))
    return float(val), np.asarray(grad)


def _loss_and_grad_torch(Ps, Gs):
    g = torch.from_numpy(Gs).requires_grad_()
    lt, lr, metrics = geodesic_loss(torch.from_numpy(Ps), g)
    loss = 10.0 * lt + 10.0 * lr
    loss.backward()
    assert set(metrics) == {"train_geo_loss_tr", "train_geo_loss_rot"}
    return loss.item(), g.grad.numpy()


def _cases():
    Ps = poses(4)
    generic = poses(4)
    # near identity: a rotation residual of ~1e-5 rad, |v|^2 below the
    # 1e-8 Taylor cutoff of so3_log
    near = Ps.copy()
    near[:, 1, 3:6] += 5e-6 * RNG.standard_normal((4, 3)).astype(np.float32)
    near[:, 1, 3:] /= np.linalg.norm(near[:, 1, 3:], axis=-1, keepdims=True)
    near[:, 1, :3] += 1e-3
    return {"generic": (Ps, generic), "near_identity": (Ps, near)}


@pytest.mark.parametrize("case", ["generic", "near_identity"])
def test_geodesic_loss_and_gradient_match_jax(case):
    Ps, Gs = _cases()[case]
    want, wgrad = _loss_and_grad_jax(Ps, Gs)
    got, ggrad = _loss_and_grad_torch(Ps, Gs)
    assert np.isfinite(ggrad).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ggrad, wgrad, rtol=0,
                               atol=1e-5 * np.abs(wgrad).max())


def test_zero_residual_gradient_is_zero():
    """Prediction equal to a translation-only ground truth: the residual
    is exactly zero, and both packages give a finite zero gradient (the
    safe norm's subgradient, not NaN)."""
    Ps = poses(3, angle=0.0)
    want, wgrad = _loss_and_grad_jax(Ps, Ps.copy())
    got, ggrad = _loss_and_grad_torch(Ps, Ps.copy())
    assert got == want == 0.0
    assert np.isfinite(ggrad).all() and np.isfinite(wgrad).all()
    assert not ggrad.any() and not wgrad.any()


@pytest.mark.parametrize("angle", [1e-5, 0.3, 3.0])
def test_se3_ops_match_jax(angle):
    """compose, inverse and log (through the Taylor branch at 1e-5 rad,
    the general one above, and near pi)."""
    a = poses(6, angle)[:, 1]
    b = poses(6, angle)[:, 1]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for got, want in ((lie.se3_compose(ta, tb), jlie.se3_compose(ja, jb)),
                      (lie.se3_inverse(ta), jlie.se3_inverse(ja)),
                      (lie.se3_log(ta), jlie.se3_log(ja))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


def test_log_gradient_finite_at_identity():
    """The double-where idiom: the gradient of se3_log at the identity
    goes through the Taylor branches and is finite, as in JAX."""
    x = np.zeros((2, 7), np.float32)
    x[:, 6] = 1.0
    t = torch.from_numpy(x).requires_grad_()
    lie.se3_log(t).sum().backward()
    want = jax.grad(lambda p: jlie.se3_log(p).sum())(jnp.asarray(x))
    assert np.isfinite(t.grad.numpy()).all()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-6)


def _tangents(B, angle):
    """(B, 6) = [tau, phi]: |tau| about 0.5, |phi| = ``angle`` times a
    uniform [0.5, 1) factor; angle 1e-5 puts theta^2 below the Taylor
    cutoff (1e-8)."""
    phi = RNG.standard_normal((B, 3))
    phi *= angle * RNG.uniform(0.5, 1.0, (B, 1)) / np.linalg.norm(
        phi, axis=-1, keepdims=True)
    return np.concatenate([0.5 * RNG.standard_normal((B, 3)), phi],
                          -1).astype(np.float32)


@pytest.mark.parametrize("angle", [1e-5, 0.3, 3.0])
def test_exp_maps_match_jax(angle):
    """so3_exp, _V_matrix and se3_exp through the Taylor branches (1e-5
    rad) and the general ones (0.3, near pi), values and the gradient of
    se3_exp; fp32 tolerances as above (values 1e-6, gradients 1e-5 of the
    largest entry)."""
    xi = _tangents(6, angle)
    t, j = torch.from_numpy(xi), jnp.asarray(xi)
    for got, want in ((lie.so3_exp(t[:, 3:]), jlie.so3_exp(j[:, 3:])),
                      (lie._V_matrix(t[:, 3:]), jlie._V_matrix(j[:, 3:])),
                      (lie.se3_exp(t), jlie.se3_exp(j))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    w = RNG.standard_normal((6, 7)).astype(np.float32)
    tg = t.clone().requires_grad_()
    (lie.se3_exp(tg) * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda x: (jlie.se3_exp(x) * w).sum())(j)
    assert np.isfinite(tg.grad.numpy()).all()
    np.testing.assert_allclose(tg.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


def test_exp_inverts_log():
    """se3_log(se3_exp(xi)) = xi and se3_exp(se3_log(p)) = p, fp32 (2e-6
    absolute: one exp and one log of unit-scale poses)."""
    xi = torch.from_numpy(_tangents(8, 1.0))
    np.testing.assert_allclose(lie.se3_log(lie.se3_exp(xi)).numpy(),
                               xi.numpy(), rtol=0, atol=2e-6)
    p = torch.from_numpy(poses(8)[:, 1])
    np.testing.assert_allclose(lie.se3_exp(lie.se3_log(p)).numpy(),
                               p.numpy(), rtol=0, atol=2e-6)


def test_identity_and_normalize_quat_match_jax():
    """se3_identity (shape, dtype), se3_identity_like (batch shape, dtype,
    device), and se3_normalize_quat on unit, long and nearly-zero
    quaternions (the 0.01 floor) against JAX's, 1e-6 absolute."""
    ident = lie.se3_identity((2, 3), torch.float64)
    np.testing.assert_array_equal(
        ident.numpy(), np.asarray(jlie.se3_identity((2, 3), jnp.float32)))
    assert ident.dtype == torch.float64 and ident.shape == (2, 3, 7)
    p = torch.from_numpy(poses(5)[:, 1])
    like = lie.se3_identity_like(p)
    assert like.dtype == p.dtype and like.device == p.device
    np.testing.assert_array_equal(
        like.numpy(), np.asarray(jlie.se3_identity_like(jnp.asarray(p))))
    x = RNG.standard_normal((5, 7)).astype(np.float32)
    x[1, 3:] *= 10.0
    x[2, 3:] *= 1e-4                   # |q| below the floor
    np.testing.assert_allclose(
        lie.se3_normalize_quat(torch.from_numpy(x)).numpy(),
        np.asarray(jlie.se3_normalize_quat(jnp.asarray(x))), rtol=0,
        atol=1e-6)


def test_geom_exports_are_the_jax_packages():
    import rel_pose_tpu.geom as jgeom
    import rel_pose_tpu_torch.geom as tgeom
    assert tgeom.__all__ == jgeom.__all__
    assert all(callable(getattr(tgeom, n)) for n in tgeom.__all__)
