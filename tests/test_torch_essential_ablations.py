"""PyTorch port vs the JAX package: the Essential Matrix Module's variants.

The paper's ablations of the module change the Pallas core ``_eb_combos``
through three static flags: ``has_pos`` (e = d + 6, or d under
``no_pos_encoding``), ``cross_features`` (va = v of the query image) and
``use_single_softmax`` (A = the row softmax alone).  Here every combination
of the three, fp32 and bf16, goes through the port's plain versions and the
Pallas kernels in interpret mode, as tests/test_essential_block.py runs
them: the pair kernel #2 ``_essential_block_pair_call``, #4
``_essential_block_call`` (precomputed qkv) and #3
``_essential_block_x_call`` (the qkv Linear inside), and the backward
``essential_block_bwd_call`` for the cases tests/test_essential_block_bwd.py
covers.  The CUDA kernels are held to the same plain versions on the GPU
(``chip_smoke.py`` phase 3d).  B = 2 pairs, N = 64, 3 heads of d = 16,
inputs from a numpy seed.

Tolerances: forward, relative to max|F|: fp32 1e-5 (the same fp32
arithmetic in another summation order); bf16 1e-2 (both round P, vb / lc
and av to bf16 at the same points; the Pallas bf16 LN of #2 takes a
single-pass variance, which can move a token's rounding by an ulp, 2^-8
relative).  Backward, ||err|| / ||ref|| per output, as
tests/test_torch_essential_block_bwd.py: fp32 1e-5, bf16 1e-2 (a sum-order
difference can flip one rounding of A, dF, va dF or ds by an ulp; the
Pallas kernel also accumulates the positional cotangent in bf16, the port
in fp32).  The autograd Functions against autograd through the plain
forward: 1e-5 in fp32.
"""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rel_pose_tpu.ops import posenc as jposenc
from rel_pose_tpu.ops.essential import essential_cross_attention as jeca
from rel_pose_tpu.ops.pallas_essential_block import (
    _essential_block_call, _essential_block_pair_call,
    _essential_block_x_call)
from rel_pose_tpu.ops.pallas_essential_block_bwd import \
    essential_block_bwd_call
from rel_pose_tpu_torch.ops import essential_block as te
from rel_pose_tpu_torch.ops import posenc as tposenc
from rel_pose_tpu_torch.ops.essential import essential_cross_attention

RNG = np.random.default_rng(71)
B, N, H, D = 2, 64, 3, 16
C = H * D
FWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# (has_pos, cross_features, use_single_softmax)
VARIANTS = list(itertools.product((True, False), repeat=3))
VARIANT_IDS = [f"{'pos' if p else 'nopos'}-{'cross' if x else 'self'}-"
               f"{'single' if s else 'dual'}" for p, x, s in VARIANTS]


def _n(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _inputs():
    return {"xp": _n(B, 2, N, C), "lns": 1 + _n(C, scale=0.1),
            "lnb": _n(C, scale=0.1), "w": _n(3 * C, C, scale=C ** -0.5 * 1.5),
            "b": _n(3 * C, scale=0.1), "pos": _n(B, N, 6),
            "qkv": _n(B, 2, N, 3 * C, scale=1.5)}


def _check_f(got, want, dtype, e):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == (B, 2, H, e, e)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=FWD_TOL[dtype] * np.abs(want).max())


def _normrel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("has_pos,cross,single", VARIANTS, ids=VARIANT_IDS)
def test_pair_reference_matches_pallas(has_pos, cross, single, dtype):
    """#2: the raw pair tokens through LN and the qkv Linear."""
    p = _inputs()
    want = _essential_block_pair_call(
        jnp.asarray(p["xp"]).astype(dtype), jnp.asarray(p["lns"]),
        jnp.asarray(p["lnb"]), jnp.asarray(p["w"].T).astype(dtype),
        jnp.asarray(p["b"]), jnp.asarray(p["pos"]).astype(dtype), H, cross,
        single, has_pos, interpret=True)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = te.essential_block_pair_reference(
        t["xp"].to(getattr(torch, dtype)), (t["lns"], t["lnb"]),
        (t["w"], t["b"]), t["pos"] if has_pos else None, H,
        cross_features=cross, use_single_softmax=single)
    _check_f(got, want, dtype, D + 6 * has_pos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("has_pos,cross,single", VARIANTS, ids=VARIANT_IDS)
def test_block_reference_matches_pallas(has_pos, cross, single, dtype):
    """#4: precomputed qkv1, qkv2."""
    p = _inputs()
    jq = jnp.asarray(p["qkv"]).astype(dtype)
    want = _essential_block_call(jq[:, 0], jq[:, 1],
                                 jnp.asarray(p["pos"]).astype(dtype), H,
                                 cross, single, has_pos, interpret=True)
    q = torch.from_numpy(p["qkv"]).to(getattr(torch, dtype))
    got = te.essential_block_reference(
        q[:, 0], q[:, 1], torch.from_numpy(p["pos"]) if has_pos else None,
        H, cross_features=cross, use_single_softmax=single)
    _check_f(got, want, dtype, D + 6 * has_pos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("has_pos,cross,single", VARIANTS, ids=VARIANT_IDS)
def test_x_reference_matches_pallas(has_pos, cross, single, dtype):
    """#3: pre-normed x1, x2 and the qkv Linear, no LayerNorm."""
    p = _inputs()
    jx = jnp.asarray(p["xp"]).astype(dtype)
    want = _essential_block_x_call(
        jx[:, 0], jx[:, 1], jnp.asarray(p["w"].T).astype(dtype),
        jnp.asarray(p["b"]), jnp.asarray(p["pos"]).astype(dtype), H, cross,
        single, has_pos, interpret=True)
    x = torch.from_numpy(p["xp"]).to(getattr(torch, dtype))
    got = te.essential_block_x_reference(
        x[:, 0], x[:, 1], (torch.from_numpy(p["w"]), torch.from_numpy(p["b"])),
        torch.from_numpy(p["pos"]) if has_pos else None, H,
        cross_features=cross, use_single_softmax=single)
    _check_f(got, want, dtype, D + 6 * has_pos)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("has_pos,cross,single", [
    (True, False, False), (True, True, False), (True, False, True),
    (False, False, False), (True, True, True)],
    ids=["default", "cross", "single", "nopos", "cross-single"])
def test_backward_matches_pallas(has_pos, cross, single, dtype):
    """The cases of tests/test_essential_block_bwd.py."""
    qkv = _n(B, 2, N, 3 * C, scale=1.5)
    pos = _n(B, N, 6)
    e = D + 6 * has_pos
    df = _n(B, 2, H, e, e, scale=0.1)
    jq = jnp.asarray(qkv).astype(dtype)
    want1, want2, want_pos = essential_block_bwd_call(
        jq[:, 0], jq[:, 1], jnp.asarray(pos).astype(dtype), jnp.asarray(df),
        H, cross, single, has_pos, interpret=True)
    tdt = getattr(torch, dtype)
    dqkv, dpos_part = te.essential_block_bwd_reference(
        torch.from_numpy(qkv).to(tdt),
        torch.from_numpy(pos) if has_pos else None, torch.from_numpy(df), H,
        cross_features=cross, use_single_softmax=single)
    assert dqkv.dtype == tdt and dqkv.shape == (B, 2, N, 3 * C)
    for img, want in ((0, want1), (1, want2)):
        for slot in range(3):          # q, k, v columns of each image
            sl = slice(slot * C, (slot + 1) * C)
            assert _normrel(dqkv[:, img, :, sl].float(),
                            np.asarray(want, np.float32)[..., sl]) \
                <= BWD_TOL[dtype], (img, slot)
    if has_pos:
        assert dpos_part.shape == (B, 2, H, N, 6)
        assert _normrel(te.sum_dpos(dpos_part),
                        np.asarray(want_pos, np.float32)) <= BWD_TOL[dtype]
    else:
        assert dpos_part is None


def _grads(fn, inputs, g):
    leaves = [None if t is None else t.clone().requires_grad_()
              for t in inputs]
    fn(*leaves).backward(g)
    return [None if t is None else t.grad for t in leaves]


@pytest.mark.parametrize("has_pos,cross,single", VARIANTS, ids=VARIANT_IDS)
def test_functions_match_autograd_of_plain_forward(has_pos, cross, single):
    """fp32: the autograd Functions of #2, #3 and #4 (CPU route: the plain
    forward, then the plain backward and the chain through the Linear and
    the LayerNorm) against autograd through their plain forwards, for every
    input."""
    t = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    pos = t["pos"] if has_pos else None
    flags = dict(cross_features=cross, use_single_softmax=single)
    g = torch.from_numpy(_n(B, 2, H, D + 6 * has_pos, D + 6 * has_pos))
    cases = {
        "pair": ((t["xp"], t["lns"], t["lnb"], t["w"], t["b"], pos),
                 lambda f: lambda xp, s, bb, w, b, p: f(
                     xp, (s, bb), (w, b), p, H, **flags),
                 te.fused_essential_block_pair,
                 te.essential_block_pair_reference),
        "x": ((t["xp"][:, 0], t["xp"][:, 1], t["w"], t["b"], pos),
              lambda f: lambda x1, x2, w, b, p: f(x1, x2, (w, b), p, H,
                                                  **flags),
              te.fused_essential_block_x, te.essential_block_x_reference),
        "block": ((t["qkv"][:, 0], t["qkv"][:, 1], pos),
                  lambda f: lambda a, c, p: f(a, c, p, H, **flags),
                  te.fused_essential_block, te.essential_block_reference),
    }
    before = te.fused_essential_block_bwd.launches
    for name, (inputs, bind, fused, plain) in cases.items():
        got = _grads(bind(fused), inputs, g)
        want = _grads(bind(plain), inputs, g)
        for i, (a, w) in enumerate(zip(got, want)):
            assert (a is None) == (w is None), (name, i)
            if a is not None:
                assert _normrel(a, w) <= 1e-5, (name, i)
    assert te.fused_essential_block_bwd.launches == before  # CPU: no kernel


@pytest.mark.parametrize("has_pos,cross,single", [
    (True, False, False), (False, True, True), (True, True, False)],
    ids=["flagship", "nopos-cross-single", "cross"])
def test_essential_cross_attention_matches_jax(has_pos, cross, single):
    """#3's public caller against the JAX ``essential_cross_attention``
    (its plain path off the TPU), fp32."""
    p = _inputs()
    width = H * (D + 6 * has_pos)
    pw, pb = _n(C, width, scale=0.1), _n(C, scale=0.1)
    jparams = {"qkv": {"w": jnp.asarray(p["w"].T), "b": jnp.asarray(p["b"])},
               "proj_fundamental": {"w": jnp.asarray(pw.T),
                                    "b": jnp.asarray(pb)}}
    x = torch.from_numpy(p["xp"])
    want = jeca(jparams, jnp.asarray(p["xp"][:, 0]),
                jnp.asarray(p["xp"][:, 1]),
                jnp.asarray(p["pos"]) if has_pos else None, H,
                cross_features=cross, use_single_softmax=single)
    got = essential_cross_attention(
        x[:, 0], x[:, 1], (torch.from_numpy(p["w"]), torch.from_numpy(p["b"])),
        (torch.from_numpy(pw), torch.from_numpy(pb)),
        torch.from_numpy(p["pos"]) if has_pos else None, H,
        cross_features=cross, use_single_softmax=single)
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert a.shape == (B, D + 6 * has_pos, C)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("table", ["l1", "quadratic"])
@pytest.mark.parametrize("with_intrinsics", [True, False])
def test_positional_tables_match_jax(table, with_intrinsics):
    """The L1 table, and both tables without intrinsics (the reference's
    initial tables, broadcast to the batch), against the JAX package."""
    name = f"{table}_positional_encoding"
    K = None
    if with_intrinsics:
        K = np.tile(np.float32([[[100.0, 110.0, 12.0, 11.5]],
                                [[70.0, 80.0, 12.0, 12.0]]]), (1, 2, 1))
    want = np.asarray(getattr(jposenc, name)(
        576, None if K is None else jnp.asarray(K), batch=2))
    got = getattr(tposenc, name)(
        576, None if K is None else torch.from_numpy(K), batch=2)
    assert got.shape == want.shape == (2, 576, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if table == "l1":
        np.testing.assert_array_equal(got[..., [0, 1, 2, 5]].numpy(), 1.0)


def test_launch_checks_of_the_variants():
    """#3's and #4's CUDA-route checks, exercised on CPU tensors, and the
    raise on a device with no kernel."""
    q = torch.zeros(2, 8, 3 * 192)
    te._check_pair(q, q, torch.zeros(2, 8, 6), 192, 3)       # accepted
    te._check_pair(q, q, None, 192, 3)
    with pytest.raises(TypeError):
        te._check_pair(q, q.double(), None, 192, 3)
    with pytest.raises(ValueError, match="contiguous"):
        te._check_pair(q, q[:, :4], None, 192, 3)
    with pytest.raises(ValueError, match="head_dim 64"):
        te._check_pair(q, q, None, 96, 3)
    with pytest.raises(ValueError, match="pos"):
        te._check_pair(q, q, torch.zeros(2, 8, 5), 192, 3)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        te.fused_essential_block(meta, meta, None, 3)
    with pytest.raises(ValueError, match="no kernel"):
        te.fused_essential_block_x(meta[..., :192], meta[..., :192],
                                   (torch.zeros(576, 192), torch.zeros(576)),
                                   None, 3)
