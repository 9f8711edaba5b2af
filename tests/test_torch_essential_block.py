"""PyTorch port vs the JAX package: the Essential Matrix Module pair block.

The JAX Pallas pair kernel ``_essential_block_pair_call`` runs in interpret
mode, as its own tests run it on the CPU (tests/test_essential_block.py);
the port's side is its plain version ``essential_block_pair_reference``,
which the CUDA kernels are held against on the GPU.  Inputs come from a
numpy seed; positions are on, as in the flagship model.

Tolerances, relative to max|F|: fp32 1e-5 (the same fp32 arithmetic in
another summation order); bf16 1e-2 (both round P, vb / lc and av to bf16
at the same points, but the Pallas bf16 LN takes a single-pass variance,
which can move a token's rounding by an ulp, 2^-8 relative).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rel_pose_tpu.ops.essential import essential_cross_attention_pair as jcap
from rel_pose_tpu.ops.pallas_essential_block import (
    _essential_block_pair_call, fused_essential_block_pair as jfused)
from rel_pose_tpu_torch.ops import essential_block as te
from rel_pose_tpu_torch.ops.essential import essential_cross_attention_pair

RNG = np.random.default_rng(5)
B, N, H, D = 2, 64, 3, 16
C = H * D


def _params():
    n = lambda *s, scale=1.0: (RNG.standard_normal(s) * scale).astype(
        np.float32)
    return {"xp": n(B, 2, N, C), "lns": 1 + n(C, scale=0.1),
            "lnb": n(C, scale=0.1), "w": n(3 * C, C, scale=C ** -0.5 * 1.5),
            "b": n(3 * C, scale=0.1), "pos": n(B, N, 6)}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
def test_reference_matches_pallas_pair_kernel(dtype, tol):
    p = _params()
    want = np.asarray(_essential_block_pair_call(
        jnp.asarray(p["xp"]).astype(dtype), jnp.asarray(p["lns"]),
        jnp.asarray(p["lnb"]), jnp.asarray(p["w"].T).astype(dtype),
        jnp.asarray(p["b"]), jnp.asarray(p["pos"]).astype(dtype), H,
        False, False, True, interpret=True))
    tdt = getattr(torch, dtype)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = te.essential_block_pair_reference(
        t["xp"].to(tdt), (t["lns"], t["lnb"]), (t["w"], t["b"]), t["pos"], H)
    assert got.dtype == torch.float32
    assert got.shape == (B, 2, H, D + 6, D + 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_reference_matches_jax_plain_path():
    """The JAX package's off-TPU path (LN + rounded qkv + the einsum
    reference with natural-exp softmaxes), fp32."""
    p = _params()
    want = np.asarray(jfused(
        jnp.asarray(p["xp"]), {"scale": jnp.asarray(p["lns"]),
                               "bias": jnp.asarray(p["lnb"])},
        {"w": jnp.asarray(p["w"].T), "b": jnp.asarray(p["b"])},
        jnp.asarray(p["pos"]), H))
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = te.essential_block_pair_reference(
        t["xp"], (t["lns"], t["lnb"]), (t["w"], t["b"]), t["pos"], H)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2 ** -8 * 4)])
def test_cross_attention_pair_end_to_end(dtype, tol):
    """Pair block -> head-major reshape -> proj_fundamental -> the flip,
    against the JAX ``essential_cross_attention_pair`` (bf16: a few ulps
    of the output's magnitude, the outputs being rounded bf16 sums)."""
    p = _params()
    pw = (RNG.standard_normal((C, H * (D + 6))) * 0.1).astype(np.float32)
    pb = (RNG.standard_normal(C) * 0.1).astype(np.float32)
    jparams = {"qkv": {"w": jnp.asarray(p["w"].T), "b": jnp.asarray(p["b"])},
               "proj_fundamental": {"w": jnp.asarray(pw.T),
                                    "b": jnp.asarray(pb)}}
    w1, w2 = jcap(jparams, {"scale": jnp.asarray(p["lns"]),
                            "bias": jnp.asarray(p["lnb"])},
                  jnp.asarray(p["xp"]).astype(dtype),
                  jnp.asarray(p["pos"]), H)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    g1, g2 = essential_cross_attention_pair(
        t["xp"].to(getattr(torch, dtype)), (t["lns"], t["lnb"]),
        (t["w"], t["b"]), (torch.from_numpy(pw), torch.from_numpy(pb)),
        t["pos"], H)
    for got, want in ((g1, w1), (g2, w2)):
        want = np.asarray(want, np.float32)
        assert got.shape == (B, D + 6, C)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())


def test_direction_convention():
    """Direction 0 attends image 2's queries over image 1 (va = vb = v of
    image 1): swapping the images swaps the two directions."""
    p = _params()
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    args = ((t["lns"], t["lnb"]), (t["w"], t["b"]), t["pos"], H)
    f = te.essential_block_pair_reference(t["xp"], *args)
    g = te.essential_block_pair_reference(t["xp"].flip(1), *args)
    torch.testing.assert_close(f[:, 0], g[:, 1])
    torch.testing.assert_close(f[:, 1], g[:, 0])


def test_cpu_tensor_dispatches_to_plain_version():
    p = _params()
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    args = ((t["lns"], t["lnb"]), (t["w"], t["b"]), t["pos"], H)
    before = te.fused_essential_block_pair.launches
    torch.testing.assert_close(
        te.fused_essential_block_pair(t["xp"], *args),
        te.essential_block_pair_reference(t["xp"], *args), rtol=0, atol=0)
    assert te.fused_essential_block_pair.launches == before


def test_launch_checks():
    """The CUDA route's argument checks, exercised on CPU tensors.  Inputs
    that require grad are accepted (the block is an autograd Function); the
    shape, dtype and head_dim checks still raise."""
    Bc, Nc, Cc = 2, 8, 192
    xp = torch.zeros(Bc, 2, Nc, Cc)
    params = (torch.ones(Cc), torch.zeros(Cc), torch.zeros(3 * Cc, Cc),
              torch.zeros(3 * Cc), torch.zeros(Bc, Nc, 6))
    te._check_inputs(xp, params, 3)                        # accepted
    te._check_inputs(xp.clone().requires_grad_(), params, 3)
    with pytest.raises(TypeError):
        te._check_inputs(xp.double(), params, 3)
    with pytest.raises(ValueError, match="head_dim 64"):
        te._check_inputs(torch.zeros(Bc, 2, Nc, 96), params, 3)
    with pytest.raises(ValueError, match="contiguous"):
        te._check_inputs(xp.transpose(0, 2), params, 3)
    with pytest.raises(ValueError, match="expected"):
        te._check_inputs(xp, params[:4] + (torch.zeros(Bc, Nc, 5),), 3)
    with pytest.raises(ValueError, match="no kernel"):
        te.fused_essential_block_pair(xp.to("meta"), params[:2], params[2:4],
                                      params[4], 3)
    with pytest.raises(ValueError, match="no kernel"):
        te.fused_essential_block_bwd(
            torch.zeros(Bc, 2, Nc, 3 * Cc, device="meta"), params[4],
            torch.zeros(Bc, 2, 3, 70, 70), 3)
