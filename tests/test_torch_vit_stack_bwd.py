"""PyTorch port vs the JAX package: the ViT stack's training path.

The Pallas kernels run in interpret mode, as tests/test_pallas_vit_bwd.py
runs them: the forward's stash (``_vit_stack_call(stash=True)``) and the
backward kernel (``vit_stack_bwd_call``).  The port's sides are its plain
versions, which the CUDA kernels are held to on the GPU: the stash of
``vit_stack_reference`` and ``vit_stack_bwd_reference``.  N = 64 tokens,
C = 48, 3 heads, depth 2, inputs from a numpy seed.

Tolerances, as ||err|| / ||ref|| per output (the gradient checks' metric):
fp32 1e-5 -- the same fp32 arithmetic in another order, with the Pallas
fp32 GELU a polynomial erf good to 1.5e-7; bf16 2e-2 -- the Pallas bf16
path also takes TPU-only shortcuts (single-pass LayerNorm variance, the
softmax row sum carried through a bf16 product) that move roundings by an
ulp (2^-8 relative), and the residual cotangent carries the flips back
through both blocks.  Against torch autograd in fp32: 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rel_pose_tpu.ops.pallas_vit import _vit_stack_call
from rel_pose_tpu.ops.pallas_vit_bwd import vit_stack_bwd_call
from rel_pose_tpu_torch.ops import vit_stack as tv

RNG = np.random.default_rng(53)
G, N, C, HEADS, DEPTH = 2, 64, 48, 3, 2
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs():
    def n(*shape, scale=1.0):
        return (RNG.standard_normal(shape) * scale).astype(np.float32)
    st = {"ln1_scale": 1 + n(DEPTH, C, scale=0.1),
          "ln1_bias": n(DEPTH, C, scale=0.1),
          "qkv_w": n(DEPTH, 3 * C, C, scale=C ** -0.5),
          "qkv_b": n(DEPTH, 3 * C, scale=0.1),
          "proj_w": n(DEPTH, C, C, scale=C ** -0.5),
          "proj_b": n(DEPTH, C, scale=0.1),
          "ln2_scale": 1 + n(DEPTH, C, scale=0.1),
          "ln2_bias": n(DEPTH, C, scale=0.1),
          "fc1_w": n(DEPTH, 4 * C, C, scale=C ** -0.5),
          "fc1_b": n(DEPTH, 4 * C, scale=0.1),
          "fc2_w": n(DEPTH, C, 4 * C, scale=(4 * C) ** -0.5),
          "fc2_b": n(DEPTH, C, scale=0.1)}
    return st, n(G, N, C), n(1, N, C, scale=0.5), n(G, N, C)


def _jax(stacked, dtype):
    """(depth, out, in) -> the JAX package's (depth, in, out)."""
    return {k: jnp.asarray(np.swapaxes(v, 1, 2) if v.ndim == 3 else v)
            .astype(dtype) for k, v in stacked.items()}


def _torch(stacked, dtype):
    return {k: torch.from_numpy(v).to(dtype) for k, v in stacked.items()}


def _normrel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stash_matches_pallas(dtype):
    st, x, pos, _ = _inputs()
    out, xs = _vit_stack_call(jnp.asarray(x).astype(dtype), _jax(st, dtype),
                              DEPTH, HEADS, interpret=True, stash=True,
                              pos=jnp.asarray(pos).astype(dtype))
    tdt = getattr(torch, dtype)
    stash = []
    got = tv.vit_stack_reference(torch.from_numpy(x).to(tdt),
                                 _torch(st, tdt), HEADS,
                                 torch.from_numpy(pos).to(tdt), stash=stash)
    assert len(stash) == DEPTH and stash[0].dtype == tdt
    for i in range(DEPTH):
        assert _normrel(stash[i].float(), np.asarray(xs[i], np.float32)) \
            <= TOL[dtype], i
    assert _normrel(got.float(), np.asarray(out, np.float32)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_pallas(dtype):
    """The same stash and cotangent into both backwards: dx and all 12
    stacked gradients (fp32 sums in both)."""
    st, x, pos, g = _inputs()
    _, xs = _vit_stack_call(jnp.asarray(x).astype(dtype), _jax(st, dtype),
                            DEPTH, HEADS, interpret=True, stash=True,
                            pos=jnp.asarray(pos).astype(dtype))
    jg = jnp.asarray(g).astype(dtype)
    want_dx, want = vit_stack_bwd_call(xs, jg, _jax(st, dtype), DEPTH,
                                       HEADS, interpret=True)
    tdt = getattr(torch, dtype)
    got_dx, got = tv.vit_stack_bwd_reference(
        torch.from_numpy(np.array(xs, np.float32)).to(tdt),
        torch.from_numpy(g).to(tdt), _torch(st, tdt), HEADS)
    assert got_dx.dtype == tdt
    assert _normrel(got_dx.float(), np.asarray(want_dx, np.float32)) \
        <= TOL[dtype]
    for name, _ in tv.STACK_FIELDS:
        w = np.asarray(want[name])
        if w.ndim == 3:
            w = np.swapaxes(w, 1, 2)
        assert got[name].dtype == torch.float32
        assert _normrel(got[name], w) <= TOL[dtype], name


def test_backward_matches_torch_autograd():
    """fp32: the plain backward equals autograd through the plain forward,
    and the autograd Function (CPU route) returns exactly the plain
    backward's gradients, with dpos the sum of dx over the sequences."""
    st, x, pos, g = _inputs()
    leaves = {k: v.requires_grad_() for k, v in _torch(st, torch.float32)
              .items()}
    xt = torch.from_numpy(x).requires_grad_()
    pt = torch.from_numpy(pos).requires_grad_()
    tv.vit_stack_reference(xt, leaves, HEADS, pt).backward(
        torch.from_numpy(g))
    stash = []
    with torch.no_grad():
        tv.vit_stack_reference(torch.from_numpy(x), _torch(st, torch.float32),
                               HEADS, torch.from_numpy(pos), stash=stash)
    dx, grads = tv.vit_stack_bwd_reference(
        torch.stack(stash), torch.from_numpy(g), _torch(st, torch.float32),
        HEADS)
    assert _normrel(dx, xt.grad) <= 1e-5
    for k in grads:
        assert _normrel(grads[k], leaves[k].grad) <= 1e-5, k

    f_leaves = {k: v.requires_grad_() for k, v in _torch(st, torch.float32)
                .items()}
    xf = torch.from_numpy(x).requires_grad_()
    pf = torch.from_numpy(pos).requires_grad_()
    before = tv.fused_vit_stack_bwd.launches
    tv.fused_vit_stack(xf, f_leaves, HEADS, pf).backward(torch.from_numpy(g))
    assert tv.fused_vit_stack_bwd.launches == before    # CPU: no kernel
    torch.testing.assert_close(xf.grad, dx, rtol=0, atol=0)
    torch.testing.assert_close(pf.grad, dx.sum(0, keepdim=True), rtol=0,
                               atol=0)
    for k in grads:
        torch.testing.assert_close(f_leaves[k].grad, grads[k], rtol=0,
                                   atol=0)


def test_no_grad_writes_no_stash():
    """Under no_grad the wrapper takes the eval route (no Function, no
    stash): the output carries no autograd graph."""
    st, x, pos, _ = _inputs()
    leaves = {k: v.requires_grad_() for k, v in _torch(st, torch.float32)
              .items()}
    with torch.no_grad():
        out = tv.fused_vit_stack(torch.from_numpy(x), leaves, HEADS,
                                 torch.from_numpy(pos))
    assert out.grad_fn is None
    out = tv.fused_vit_stack(torch.from_numpy(x), leaves, HEADS,
                             torch.from_numpy(pos))
    assert type(out.grad_fn).__name__ == "_VitStackBackward"
