"""PyTorch port: the numerics of the bf16 attention body of kernels #1, #5
and #7 (``csrc/attention_wgmma.cuh``), through a plain model of it, on the
CPU, against the JAX package.

The model (:func:`online_forward`, :func:`one_pass_backward`) forms what the
kernels form, in both layouts -- ``Separate`` (#7's (G, N, 64) heads, bf16
cotangent and gradients) and ``Interleaved`` (the ViT stack's heads inside
one (N, 3C) qkv, fp32 cotangent and gradients):

  * forward: one pass over 64-key tiles with online rescaling -- the
    running row max m, l and o rescaled by exp2(m_old - m_new), P =
    bf16(exp2(s - m_running)) -- and the exact (m, l) at the end;
    o = normalize(o, l) (``Separate``: o / l; ``Interleaved``: o * (1 / l));
  * backward from the forward's (m, l) and its bf16 output o: c =
    rowsum(do o), e = exp2(s - m), dp = T(do) v^T, ds = T(ds(e, dp, c, l)),
    dq = ds k, dk = ds^T q, dv = T(e)^T T(do / l).

On numpy-seeded inputs at N = 64, 100 (a ragged last tile on the card) and
576, it is held, with ``chip_smoke.py``'s bf16 tolerances
(||model - jax|| / ||jax||), to:

  * ``Separate``: the Pallas ``_fwd_call`` / ``_bwd_call`` in interpret
    mode (as tests/test_torch_attention.py runs them), G = 2 heads --
    o <= MHSA_FWD_NORMREL 2e-2 [measured 1.3e-5 - 2.2e-3], dq, dk, dv <=
    GRAD_NORMREL 3e-2 [0 - 2.2e-3];
  * ``Interleaved``: ``pallas_vit_bwd._attn_fwd_heads`` /
    ``_attn_bwd_heads`` (the ViT kernels' attention, called as
    ``_vit_stack_bwd_kernel`` calls them), 3 heads of one (N, 576) qkv --
    o <= 2e-2 [1.6e-3 - 2.2e-3], dq, dk, dv <= 3e-2 [6.8e-4 - 1.8e-3];
  * both: the kept (m, l) against ``_fwd_kernel``'s max and sum lines
    written out in JAX, <= MHSA_STATS_NORMREL 1e-5 [m 6.1e-8 - 6.3e-8,
    l 1.3e-7 - 1.9e-7: l rescaled up to 8 times].

And the model does move the rounding points: at N = 576 its o differs
from the same model with the exact max taken first (the parent kernels'
points) in some bits, and c from the rounded o differs from rowsum(dp e)
/ l by less than 1e-2 of the largest |c| [measured 1.9e-3 - 3.2e-3;
24,185 and 37,063 bf16 values of o differ].
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rel_pose_tpu.ops.pallas_attention import _bwd_call, _fwd_call
from rel_pose_tpu.ops.pallas_vit_bwd import _attn_bwd_heads, _attn_fwd_heads

LOG2E = 1.4426950408889634
D, TILE = 64, 64
SM_SCALE = D ** -0.5
SCALE2 = torch.tensor(SM_SCALE * LOG2E, dtype=torch.float32)  # d^-1/2 log2 e
MHSA_FWD_NORMREL, GRAD_NORMREL, MHSA_STATS_NORMREL = 2e-2, 3e-2, 1e-5
NS = (64, 100, 576)
LAYOUTS = ("separate", "interleaved")
G_SEP, HEADS = 2, 3


def bf(t):
    """t rounded to bf16, as fp32."""
    return t.to(torch.bfloat16).float()


def normalize(layout, o, l):
    return o / l if layout == "separate" else o * (1.0 / l)


def ds_of(layout, e, dp, c, l):
    if layout == "separate":
        return e * ((dp - c) * (SM_SCALE / l))
    return e * ((dp - c) / l) * math.log(2.0) * SCALE2


def online_forward(layout, q, k, v, exact_max=False):
    """``(o, m, l)`` as the forward kernel forms them (o before its bf16
    rounding).  ``exact_max``: the max of every score taken first, the
    parent kernels' rounding points."""
    G, N, _ = q.shape
    m = torch.full((G, N, 1), -math.inf)
    l = torch.zeros((G, N, 1))
    o = torch.zeros((G, N, D))
    if exact_max:
        m = ((q @ k.transpose(-1, -2)) * SCALE2).amax(-1, keepdim=True)
    for k0 in range(0, N, TILE):
        kt, vt = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
        s = (q @ kt.transpose(-1, -2)) * SCALE2
        mt = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mt)
        p = torch.exp2(s - mt)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + bf(p) @ vt
        m = mt
    return normalize(layout, o, l), m, l


def one_pass_backward(layout, q, k, v, do, o, m, l):
    """``(dq, dk, dv)`` in fp32 as the dq and dk / dv kernels form them from
    the forward's (m, l) and bf16 output o; and c."""
    s = (q @ k.transpose(-1, -2)) * SCALE2
    e = torch.exp2(s - m)
    c = (do * o).sum(-1, keepdim=True)
    dp = bf(do) @ v.transpose(-1, -2)
    ds = bf(ds_of(layout, e, dp, c, l))
    dv = bf(e).transpose(-1, -2) @ bf(do / l)
    return ds @ k, ds.transpose(-1, -2) @ q, dv, c


@functools.lru_cache(maxsize=None)
def inputs(layout, N):
    """numpy-seeded bf16 q, k, v (as fp32 (G, N, 64) heads) and cotangent
    (bf16 for Separate, fp32 for Interleaved)."""
    rng = np.random.default_rng(61 + N + (layout == "interleaved"))
    G = G_SEP if layout == "separate" else HEADS
    q, k, v = (bf(torch.from_numpy(rng.standard_normal((G, N, D)).astype(
        np.float32))) for _ in range(3))
    do = torch.from_numpy(rng.standard_normal((G, N, D)).astype(np.float32))
    return q, k, v, bf(do) if layout == "separate" else do


@functools.lru_cache(maxsize=None)
def model(layout, N):
    q, k, v, do = inputs(layout, N)
    o, m, l = online_forward(layout, q, k, v)
    ob = bf(o)
    dq, dk, dv, c = one_pass_backward(layout, q, k, v, do, ob, m, l)
    if layout == "separate":
        dq, dk, dv = bf(dq), bf(dk), bf(dv)
    return o, m, l, (dq, dk, dv), c


def to_jnp(t, dtype=jnp.bfloat16):
    return jnp.asarray(t.numpy()).astype(dtype)


@functools.lru_cache(maxsize=None)
def jax_outputs(layout, N):
    """(o, (dq, dk, dv)) of the JAX package as fp32 numpy, (G, N, 64)."""
    q, k, v, do = inputs(layout, N)
    if layout == "separate":
        jq, jk, jv, jdo = (to_jnp(t) for t in (q, k, v, do))
        o = _fwd_call(jq, jk, jv, SM_SCALE, interpret=True)
        grads = _bwd_call(jq, jk, jv, jdo, SM_SCALE, interpret=True)
        f = lambda a: np.asarray(a.astype(jnp.float32))
        return f(o), tuple(f(g) for g in grads)
    # one sequence: qkv (N, 3C), head h at columns h*64, C + h*64, 2C + h*64
    C = HEADS * D
    cat = lambda t: torch.cat(list(t), -1)   # (G, N, 64) -> (N, G*64)
    qkv = to_jnp(torch.cat([cat(q), cat(k), cat(v)], -1))
    heads, stash = _attn_fwd_heads(qkv, C, HEADS, D, SM_SCALE * LOG2E,
                                   jnp.bfloat16)
    dqs, dks, dvs = _attn_bwd_heads(to_jnp(cat(do), jnp.float32), stash,
                                    HEADS, D, SM_SCALE, jnp.bfloat16)
    f = lambda hs: np.stack([np.asarray(h, np.float32) for h in hs])
    return f(heads), (f(dqs), f(dks), f(dvs))


@functools.lru_cache(maxsize=None)
def jax_stats(layout, N):
    """(m, l) from ``_fwd_kernel``'s score, max and sum lines in JAX."""
    q, k, _, _ = inputs(layout, N)
    jq, jk = to_jnp(q), to_jnp(k)
    s = jax.lax.dot_general(jq, jk, (((2,), (2,)), ((0,), (0,))),
                            preferred_element_type=jnp.float32) * (
        SM_SCALE * LOG2E)
    m = jnp.max(s, axis=-1, keepdims=True)
    l = jnp.sum(jnp.exp2(s - m), axis=-1, keepdims=True)
    return np.asarray(m), np.asarray(l)


def normrel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_matches_jax(layout, N):
    o = model(layout, N)[0]
    want, _ = jax_outputs(layout, N)
    # Separate's kernel writes bf16 o; the ViT's attn is rounded too
    assert normrel(bf(o).numpy(), want) <= MHSA_FWD_NORMREL


@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_stats_match_jax(layout, N):
    _, m, l, _, _ = model(layout, N)
    want_m, want_l = jax_stats(layout, N)
    assert normrel(m.numpy(), want_m) <= MHSA_STATS_NORMREL
    assert normrel(l.numpy(), want_l) <= MHSA_STATS_NORMREL


@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_backward_matches_jax(layout, N):
    grads = model(layout, N)[3]
    _, want = jax_outputs(layout, N)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert normrel(g.numpy(), w) <= GRAD_NORMREL, name


@pytest.mark.parametrize("layout", LAYOUTS)
def test_rounding_points_moved(layout):
    """At N = 576 the running max rises within a row, so P rounds against
    another max than the parent kernels' exact one: some o bits differ;
    and c from the rounded o stays within 1e-2 of rowsum(dp e) / l."""
    N = 576
    q, k, v, do = inputs(layout, N)
    o = model(layout, N)[0]
    o_exact, m, l = online_forward(layout, q, k, v, exact_max=True)
    assert not torch.equal(bf(o), bf(o_exact))
    c = model(layout, N)[4]
    s = (q @ k.transpose(-1, -2)) * SCALE2
    e = torch.exp2(s - m)
    dp = bf(do) @ v.transpose(-1, -2)
    c_ref = (dp * e).sum(-1, keepdim=True) / l
    assert (c - c_ref).abs().max() <= 1e-2 * c_ref.abs().max()
