"""PyTorch port vs the JAX package: the per-head bilinear attention op
(Pallas kernel #8) and the head-stacked essential block built on it.

  * the port's plain forward and backward
    (``bilinear_attention_reference``, ``bilinear_attention_bwd_reference``)
    against the Pallas ``_fwd_call`` / ``_bwd_call`` in interpret mode, at
    tests/test_pallas.py's shapes (G 4, N 64, d 32, e 38) and at d 64, e 70,
    N 64; dual and single softmax, fp32 and bf16, va = vb and va != vb (the
    two wirings stacked along G in one call);
  * the plain forward against the JAX einsum ``bilinear_attention_reference``,
    which rounds A to the inputs' dtype where the kernel rounds P;
  * ``fused_bilinear_attention``'s autograd Function (its CPU route: the
    plain forward, then the plain backward) against autograd through the
    plain forward, with va and vb one tensor or two;
  * ``essential_block_head_stacked`` against the JAX ``_head_stacked_impl``
    (forward and ``jax.vjp``) under ``RELPOSE_NO_PALLAS=1``, where
    ``fused_bilinear_attention`` takes its einsum reference, and against the
    port's own ``essential_block_reference`` / ``essential_block_bwd_reference``
    (#4 and #6's plain versions), for the 8 flag combinations.
The CUDA kernels are held to the same plain versions on the GPU
(``chip_smoke.py`` phase 3e).  Inputs from a numpy seed.

Tolerances (measured in brackets): forward |err| <= tol * max|F|, backward
||err|| / ||ref|| per output.  Against the Pallas kernels: fp32 1e-5
[3.2e-7, 3.1e-7] (the same fp32 arithmetic in another summation order),
bf16 1e-2 [3.7e-4, 9.3e-5] (both round P, vb / lc, av, A, dF, va dF and ds
to bf16 at the same points; a sum-order difference can move one rounding
by an ulp, 2^-8 relative).  Against the einsum reference: fp32 1e-5
[3.8e-7]; bf16 1e-2 [3.9e-3] (it rounds the normalized A instead of the
unnormalized P, and keeps vb / lc and av unrounded).  The Function against
autograd, the head-stacked route against JAX and against the plain #4 / #6,
fp32: 1e-5 [1.4e-7 against #4 / #6]; the head-stacked route against #6 in
bf16: 1e-2 [3.6e-3] (it rounds dva and dvb on their own and adds them, and
the heads' positional columns, in bf16; #6 rounds their fp32 sum once).
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rel_pose_tpu.ops import pallas_essential as jpe
from rel_pose_tpu.ops.pallas_essential_block import _head_stacked_impl
from rel_pose_tpu_torch.ops import bilinear as tb
from rel_pose_tpu_torch.ops import essential_block as te

RNG = np.random.default_rng(83)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# (G, N, d, e): tests/test_pallas.py's and the model's head widths
SHAPES = [(4, 64, 32, 38), (4, 64, 64, 70)]
B, N, H, D = 2, 64, 3, 16
# (has_pos, cross_features, use_single_softmax)
FLAGS = list(itertools.product((True, False), repeat=3))
FLAG_IDS = [f"{'pos' if p else 'nopos'}-{'cross' if x else 'self'}-"
            f"{'single' if s else 'dual'}" for p, x, s in FLAGS]


def _n(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _normrel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _max_rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() / np.abs(
        want).max()


def _slices(G, N, d, e):
    """q, k (2G, N, d), va, vb (2G, N, e), dF (2G, e, e): the first G
    slices with va = vb, the next G with va != vb."""
    q, k = _n(2 * G, N, d, scale=0.5), _n(2 * G, N, d, scale=0.5)
    vb = _n(2 * G, N, e, scale=0.5)
    va = np.concatenate([vb[:G], _n(G, N, e, scale=0.5)])
    return q, k, va, vb, _n(2 * G, e, e, scale=0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("single", [False, True], ids=["dual", "single"])
@pytest.mark.parametrize("G,n,d,e", SHAPES, ids=["d32-e38", "d64-e70"])
def test_plain_versions_match_pallas(G, n, d, e, single, dtype):
    q, k, va, vb, df = _slices(G, n, d, e)
    scale = d ** -0.5
    jx = [jnp.asarray(a).astype(dtype) for a in (q, k, va, vb)]
    want_f = jpe._fwd_call(*jx, scale, single, interpret=True)
    want_g = jpe._bwd_call(*jx, jnp.asarray(df), scale, single,
                           interpret=True)
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in
          (q, k, va, vb)]
    got_f = tb.bilinear_attention_reference(*tx, scale, single)
    assert got_f.dtype == torch.float32 and got_f.shape == (2 * G, e, e)
    assert _max_rel(got_f, want_f) <= TOL[dtype]
    got_g = tb.bilinear_attention_bwd_reference(*tx, torch.from_numpy(df),
                                                scale, single)
    for name, g, w, x in zip(("dq", "dk", "dva", "dvb"), got_g, want_g, tx):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        assert _normrel(g.float(), np.asarray(w, np.float32)) <= TOL[dtype], \
            name


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
@pytest.mark.parametrize("single", [False, True], ids=["dual", "single"])
def test_plain_forward_matches_einsum_reference(single, dtype, tol):
    q, k, va, vb, _ = _slices(*SHAPES[1])
    scale = SHAPES[1][2] ** -0.5
    want = jpe.bilinear_attention_reference(
        *(jnp.asarray(a).astype(dtype) for a in (q, k, va, vb)), scale,
        single)
    got = tb.bilinear_attention_reference(
        *(torch.from_numpy(a).to(getattr(torch, dtype))
          for a in (q, k, va, vb)), scale, single)
    assert _max_rel(got, np.asarray(want, np.float32)) <= tol


@pytest.mark.parametrize("same", [True, False], ids=["va-is-vb", "va-vb"])
@pytest.mark.parametrize("single", [False, True], ids=["dual", "single"])
def test_function_matches_autograd_of_plain_forward(single, same):
    """fp32: the Function's CPU route (plain forward, plain backward)
    against autograd through the plain forward; with va and vb one tensor
    autograd adds dva and dvb into it."""
    q, k, va, vb, df = (torch.from_numpy(a) for a in _slices(*SHAPES[0]))
    g = df
    inputs = (q, k, vb) if same else (q, k, va, vb)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in inputs]
        args = (*leaves, leaves[-1]) if same else leaves
        fn(*args, 32 ** -0.5, single).backward(g)
        return [t.grad for t in leaves]

    before = tb.fused_bilinear_attention_bwd.launches
    got = grads(tb.fused_bilinear_attention)
    want = grads(tb.bilinear_attention_reference)
    for a, w in zip(got, want):
        assert _normrel(a, w) <= 1e-5
    assert tb.fused_bilinear_attention_bwd.launches == before  # CPU: plain


@pytest.fixture(scope="module")
def block_inputs():
    return {"qkv": _n(B, 2, N, 3 * H * D, scale=1.5), "pos": _n(B, N, 6),
            "g70": _n(B, 2, H, D + 6, D + 6), "g64": _n(B, 2, H, D, D)}


def _head_stacked_grads(p, has_pos, cross, single, dtype=torch.float32):
    """F and (dqkv1, dqkv2, dpos or None) of the port's head-stacked route
    under autograd."""
    leaves = [torch.from_numpy(p["qkv"][:, i]).to(dtype).requires_grad_()
              for i in range(2)]
    if has_pos:
        leaves.append(torch.from_numpy(p["pos"]).requires_grad_())
    f = te.essential_block_head_stacked(
        leaves[0], leaves[1], leaves[2] if has_pos else None, H,
        cross_features=cross, use_single_softmax=single)
    f.backward(torch.from_numpy(p["g70" if has_pos else "g64"]))
    return f.detach(), [t.grad for t in leaves] + [None] * (not has_pos)


@pytest.mark.parametrize("has_pos,cross,single", FLAGS, ids=FLAG_IDS)
def test_head_stacked_matches_jax(block_inputs, monkeypatch, has_pos, cross,
                                  single):
    """fp32 forward and VJP against ``_head_stacked_impl`` on its einsum
    path."""
    monkeypatch.setenv("RELPOSE_NO_PALLAS", "1")
    p = block_inputs
    jq = jnp.asarray(p["qkv"])
    args = (jq[:, 0], jq[:, 1]) + ((jnp.asarray(p["pos"]),) if has_pos
                                   else ())

    @jax.jit
    def forward_and_vjp(args, g):
        f, vjp = jax.vjp(lambda a, b, *pos: _head_stacked_impl(
            a, b, pos[0] if pos else None, H, cross, single, has_pos), *args)
        return f, vjp(g)

    want, want_grads = forward_and_vjp(
        args, jnp.asarray(p["g70" if has_pos else "g64"]))
    f, grads = _head_stacked_grads(p, has_pos, cross, single)
    assert f.shape == (B, 2, H, D + 6 * has_pos, D + 6 * has_pos)
    assert _max_rel(f, want) <= 1e-5
    for g, w in zip(grads, want_grads):
        assert _normrel(g, w) <= 1e-5


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
@pytest.mark.parametrize("has_pos,cross,single", FLAGS, ids=FLAG_IDS)
def test_head_stacked_matches_plain_block(block_inputs, has_pos, cross,
                                          single, dtype, tol):
    """Against #4's plain forward and #6's plain backward on the same
    rounded qkv: two routes to one function."""
    p = block_inputs
    tdt = getattr(torch, dtype)
    flags = dict(cross_features=cross, use_single_softmax=single)
    pos = torch.from_numpy(p["pos"]) if has_pos else None
    f, grads = _head_stacked_grads(p, has_pos, cross, single, tdt)
    qkv = torch.from_numpy(p["qkv"]).to(tdt)
    want_f = te.essential_block_reference(qkv[:, 0], qkv[:, 1], pos, H,
                                          **flags)
    assert _max_rel(f, want_f) <= TOL[dtype]
    dqkv, dpos_part = te.essential_block_bwd_reference(
        qkv, pos, torch.from_numpy(p["g70" if has_pos else "g64"]), H,
        **flags)
    assert _normrel(grads[0].float(), dqkv[:, 0].float()) <= tol
    assert _normrel(grads[1].float(), dqkv[:, 1].float()) <= tol
    if has_pos:
        assert _normrel(grads[2], te.sum_dpos(dpos_part)) <= tol


def test_launch_checks():
    """Tensors on a device with no kernel raise (CPU tensors take the plain
    versions, CUDA tensors the kernels)."""
    meta = torch.zeros(4, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tb.fused_bilinear_attention(meta, meta, meta, meta, 0.125)
    with pytest.raises(ValueError, match="no kernel"):
        tb.fused_bilinear_attention_bwd(meta, meta, meta, meta,
                                        torch.zeros(4, 64, 64), 0.125)
