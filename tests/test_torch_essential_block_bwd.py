"""PyTorch port vs the JAX package: the Essential Matrix Module's backward.

The Pallas backward kernel ``essential_block_bwd_call`` runs in interpret
mode, as tests/test_essential_block_bwd.py runs it; the port's side is its
plain version ``essential_block_bwd_reference``, which the CUDA kernel is
held to on the GPU.  The slice's case: positions on, dual softmax, no
cross features; B = 2 pairs, N = 64, 3 heads of 16 (e = 22), inputs from a
numpy seed.

Tolerances, as ||err|| / ||ref|| per output: fp32 1e-5 (the same fp32
arithmetic summed in another order); bf16 1e-2 (both round A, dF, va dF
and ds to bf16 at the same points, but a sum-order difference can flip one
of those roundings by an ulp, 2^-8 relative; the Pallas kernel also rounds
each of the six positional partial sums to bf16, the port sums them in
fp32).  The autograd Function against autograd through the plain forward:
1e-5 in fp32.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rel_pose_tpu.ops.pallas_essential_block_bwd import \
    essential_block_bwd_call
from rel_pose_tpu_torch.ops import essential_block as te

RNG = np.random.default_rng(61)
B, N, H, D = 2, 64, 3, 16
C = H * D
E = D + 6
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _normrel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _inputs():
    n = lambda *s, scale=1.0: (RNG.standard_normal(s) * scale).astype(
        np.float32)
    # qkv of unit-scale tokens through a C -> 3C Linear, as in the model
    return n(B, 2, N, 3 * C, scale=1.5), n(B, N, 6), n(B, 2, H, E, E,
                                                          scale=0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_pallas(dtype):
    qkv, pos, df = _inputs()
    jq = jnp.asarray(qkv).astype(dtype)
    want1, want2, want_pos = essential_block_bwd_call(
        jq[:, 0], jq[:, 1], jnp.asarray(pos).astype(dtype), jnp.asarray(df),
        H, False, False, True, interpret=True)
    tdt = getattr(torch, dtype)
    dqkv, dpos_part = te.essential_block_bwd_reference(
        torch.from_numpy(qkv).to(tdt), torch.from_numpy(pos),
        torch.from_numpy(df), H)
    assert dqkv.dtype == tdt and dqkv.shape == (B, 2, N, 3 * C)
    assert dpos_part.dtype == torch.float32
    assert dpos_part.shape == (B, 2, H, N, 6)
    for img, want in ((0, want1), (1, want2)):
        for slot in range(3):          # q, k, v columns of each image
            sl = slice(slot * C, (slot + 1) * C)
            got = dqkv[:, img, :, sl].float()
            assert _normrel(got, np.asarray(want, np.float32)[..., sl]) \
                <= TOL[dtype], (img, slot)
    assert _normrel(te.sum_dpos(dpos_part),
                    np.asarray(want_pos, np.float32)) <= TOL[dtype]


def test_function_matches_autograd_of_plain_forward():
    """fp32: the pair block's autograd Function (CPU route: the plain
    forward, then LN / Linear recompute, the plain backward, and the chain
    through the Linear and the LN VJP) against autograd through
    ``essential_block_pair_reference``, for every input."""
    n = lambda *s, scale=1.0: torch.from_numpy(
        (RNG.standard_normal(s) * scale).astype(np.float32))
    inputs = (n(B, 2, N, C), 1 + n(C, scale=0.1), n(C, scale=0.1),
              n(3 * C, C, scale=C ** -0.5 * 1.5), n(3 * C, scale=0.1),
              n(B, N, 6))
    g = n(B, 2, H, E, E)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in inputs]
        xp, lns, lnb, w, b, pos = leaves
        fn(xp, (lns, lnb), (w, b), pos, H).backward(g)
        return [t.grad for t in leaves]

    before = te.fused_essential_block_bwd.launches
    got = grads(te.fused_essential_block_pair)
    assert te.fused_essential_block_bwd.launches == before  # CPU: no kernel
    want = grads(te.essential_block_pair_reference)
    for name, a, w in zip(("xpair", "ln scale", "ln bias", "w", "b", "pos"),
                          got, want):
        assert _normrel(a, w) <= 1e-5, name


def test_sum_dpos_order():
    """The six per-combo partials add direction-major, then by head."""
    part = torch.from_numpy(RNG.standard_normal((B, 2, H, N, 6))
                            .astype(np.float32))
    want = part[:, 0, 0]
    for d, h in [(0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]:
        want = want + part[:, d, h]
    torch.testing.assert_close(te.sum_dpos(part), want, rtol=0, atol=0)
