"""PyTorch port vs the JAX package: the --noess attention (Pallas kernel #7).

The same numpy-seeded ``(G, N, 64)`` q, k, v and cotangent go through the
Pallas ``_fwd_call`` / ``_bwd_call`` in interpret mode (as
tests/test_pallas.py runs them) and the port's plain versions, in fp32 and
bf16, G = 4, N in {64, 576}.  On the CPU ``fused_mhsa`` takes those plain
versions; ``csrc/mhsa.cu`` is held to them on the card by chip_smoke.py.

Tolerances, ||port - pallas|| / ||pallas||, with their reasons (measured
values in brackets):

  * forward fp32 1e-5 [5e-7]: ``mhsa_reference`` is exp and a normalized
    softmax before ``p @ v``, the kernel exp2 and a division after it;
  * forward bf16 2e-2 [4.9e-3]: ``mhsa_reference`` (as the JAX package's)
    rounds the scores to bf16 before the softmax, the kernel keeps them
    fp32; a bf16 score is off by up to 2^-9 of itself, which moves its
    weight by that times |s|;
  * backward fp32 1e-5 [4.2e-7], bf16 1e-3 [1.1e-4]: ``mhsa_bwd_reference``
    repeats ``_bwd_kernel``'s rounding points, so only the sum order
    differs, and in bf16 that flips a rounding of e or ds by one ulp (2^-8)
    here and there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rel_pose_tpu.ops.pallas_attention import _bwd_call, _fwd_call
from rel_pose_tpu_torch.ops.attention import (fused_mhsa, fused_mhsa_bwd,
                                              mhsa_bwd_reference,
                                              mhsa_reference)

RNG = np.random.default_rng(41)
SCALE = 64 ** -0.5
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
CASES = [(n, dt) for n in (64, 576) for dt in ("float32", "bfloat16")]


def _inputs(N, dtype, n=4):
    arrs = [RNG.standard_normal((4, N, 64)).astype(np.float32)
            for _ in range(n)]
    j = [jnp.asarray(a, dtype) for a in arrs]
    t = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        getattr(torch, dtype)) for x in j]
    return j, t


def _normrel(got, want):
    got = got.double().numpy()
    want = np.asarray(want.astype(jnp.float32), np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("N,dtype", CASES)
def test_forward_matches_pallas(N, dtype):
    (q, k, v), tq = _inputs(N, dtype, 3)
    want = _fwd_call(q, k, v, SCALE, interpret=True)
    got = mhsa_reference(*tq, SCALE)
    assert got.dtype == getattr(torch, dtype) and got.shape == (4, N, 64)
    assert _normrel(got.float(), want) <= FWD_TOL[dtype]
    torch.testing.assert_close(fused_mhsa(*tq, SCALE), got, rtol=0, atol=0)


@pytest.mark.parametrize("N,dtype", CASES)
def test_backward_matches_pallas(N, dtype):
    (q, k, v, do), tq = _inputs(N, dtype)
    want = _bwd_call(q, k, v, do, SCALE, interpret=True)
    got = mhsa_bwd_reference(*tq, SCALE)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == getattr(torch, dtype), name
        assert _normrel(g.float(), w) <= BWD_TOL[dtype], name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_takes_the_plain_backward_on_cpu(dtype):
    """Under autograd ``fused_mhsa`` is the custom VJP: its gradients are
    ``mhsa_bwd_reference``'s bit for bit, and in fp32 they agree with
    autograd through ``mhsa_reference`` (1e-5, fp32 sum order)."""
    _, (q, k, v, do) = _inputs(64, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fused_mhsa(*leaves, SCALE)
    torch.testing.assert_close(out.detach(), mhsa_reference(q, k, v, SCALE),
                               rtol=0, atol=0)
    grads = torch.autograd.grad(out, leaves, do)
    for g, want in zip(grads, fused_mhsa_bwd(q, k, v, do, SCALE)):
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    if dtype == "float32":
        plain = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = torch.autograd.grad(mhsa_reference(*plain, SCALE), plain, do)
        for g, want in zip(grads, ref):
            rel = (g - want).norm() / want.norm()
            assert rel <= 1e-5, rel


def test_wrappers_refuse_other_devices():
    """Off the CPU the wrappers launch the kernel or raise: a meta tensor
    has no kernel."""
    q = torch.empty((2, 8, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_mhsa(q, q, q, SCALE)
    with pytest.raises(ValueError, match="no kernel"):
        fused_mhsa_bwd(q, q, q, q, SCALE)
