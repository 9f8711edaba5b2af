"""PyTorch port: the numerics of the fp32 attention body of kernels #1, #5
and #7 (``csrc/attention_wgmma_f32.cuh``: TF32 wgmma, every product
3xTF32), through a plain model of it, on the CPU, against the JAX package.

The model (:func:`tc_forward`, :func:`tc_backward`) forms what the kernels
form, in both layouts -- ``Separate`` (#7's (G, N, 64) heads) and
``Interleaved`` (the ViT stack's heads inside one (N, 3C) qkv):

  * every product 3xTF32 (:func:`mm3`): each operand split into hi =
    rna(x) and lo = rna(x - hi), lo_a hi_b + hi_a lo_b, then + hi_a hi_b;
    each 64-deep tile's products into a fresh partial, added to the
    running sum in fp32;
  * forward: one pass over 64-key tiles with online rescaling -- the
    running row max m, l and o rescaled by exp2(m_old - m_new), e =
    exp2(s - m_running) in fp32 -- and the exact (m, l) at the end; o =
    normalize(o, l) (``Separate``: o / l; ``Interleaved``: o * (1 / l));
  * backward from the forward's (m, l) and o: c = rowsum(do o) (in place
    of rowsum(dp e) / l, equal in exact arithmetic), e = exp2(s - m), dp =
    do v^T, ds = layout's ds(e, dp, c, l), dq = ds k, dk = ds^T q, dv =
    e^T (do / l), tile by tile.

On numpy-seeded inputs at N = 64, 100 (a ragged last tile on the card) and
576, it is held to:

  (a) the JAX package, ||model - jax|| / ||jax|| <= 1e-5 for o, dq, dk, dv
      (fp32 sums in another order, c from do . o): ``Separate`` against the
      Pallas ``_fwd_call`` / ``_bwd_call`` in interpret mode (as
      tests/test_torch_attention.py runs them), G = 4 heads [measured
      3.5e-7 - 6.4e-7]; ``Interleaved`` against ``pallas_vit_bwd.
      _attn_fwd_heads`` / ``_attn_bwd_heads`` in fp32 (the ViT kernels'
      attention, called as ``_vit_stack_bwd_kernel`` calls them), 3 heads
      of one (N, 576) qkv [3.9e-7 - 6.4e-7];
  (b) the function in float64 (autograd through an exact softmax
      attention): the model's max |err| at most F64_BAR = 2 times that of
      the port's fp32 plain version on the same inputs, per output --
      ``chip_smoke.py``'s bar (phase 3b), which holds the kernels to it on
      the card.  The plain versions: ``mhsa_reference`` /
      ``mhsa_bwd_reference`` (``Separate``) and the attention lines of
      ``ops.vit_stack``'s plain forward and backward (``Interleaved``)
      [measured ratios 0.50-1.71];
  (c) a model whose products are one TF32 product each fails (b) by more
      than ten times the bar [worst ratio 801-1,976]: the bar tells TF32
      from 3xTF32;
  (d) the B_hi choice: a B operand read raw, its fp32 word as the hi part
      (the tensor cores read only a TF32 word's top 19 bits, so hi is x
      truncated, and lo = rna(x - trunc(x))), is modelled too, and it stays
      within the bar as well [0.49-1.45] -- the kernels split every
      operand with rna all the same, so that one pass over a tile gives
      both halves and the raw box can refill at once.

And the one-pass forward does move the rounding points: at N = 576 its o
differs from the same model with the exact max taken first (the parent
kernels' two passes) in some bits.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rel_pose_tpu.ops.pallas_attention import _bwd_call, _fwd_call
from rel_pose_tpu.ops.pallas_vit_bwd import _attn_bwd_heads, _attn_fwd_heads
from rel_pose_tpu_torch.ops.attention import (LOG2E, mhsa_bwd_reference,
                                              mhsa_reference)
from rel_pose_tpu_torch.ops.vit_stack import tf32_rna

G, D, TILE, HEADS = 4, 64, 64, 3
SCALE = D ** -0.5
SCALE2 = torch.tensor(SCALE * LOG2E, dtype=torch.float32)
F64_BAR = 2.0
PALLAS_NORMREL = 1e-5
OUTPUTS = ("o", "dq", "dk", "dv")
NS = (64, 100, 576)


def tf32_trunc(x):
    """The TF32 word the tensor cores read from fp32 ``x``: its low 13
    mantissa bits dropped (rounded toward zero)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def mm3(a, b, b_hi="rna"):
    """``a @ b`` as one 64-deep tile's 3xTF32 products: lo_a hi_b + hi_a
    lo_b, then + hi_a hi_b.  ``b_hi="trunc"``: B's hi part is its raw fp32
    word as the tensor cores read it."""
    ah = tf32_rna(a)
    bh = tf32_rna(b) if b_hi == "rna" else tf32_trunc(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) \
        + torch.matmul(ah, bh)


def tf32_matmul(a, b):
    """One TF32 product: the operands rounded to TF32, summed in fp32."""
    return torch.matmul(tf32_rna(a), tf32_rna(b))


def normalize(layout, o, l):
    return o / l if layout == "separate" else o * (1.0 / l)


def ds_of(layout, e, dp, c, l):
    if layout == "separate":
        return e * ((dp - c) * (SCALE / l))
    return e * ((dp - c) / l) * math.log(2.0) * SCALE2


def tiles(N):
    return [slice(t, min(t + TILE, N)) for t in range(0, N, TILE)]


def tc_forward(layout, q, k, v, mm=mm3, exact_max=False):
    """``(o, m, l)`` as the fp32 forward kernel forms them.  ``exact_max``:
    the max of every score taken first (the parent kernels' points)."""
    Gh, N, _ = q.shape
    m = torch.full((Gh, N, 1), -math.inf)
    l = torch.zeros((Gh, N, 1))
    o = torch.zeros((Gh, N, D))
    if exact_max:
        m = (mm(q, k.transpose(-1, -2)) * SCALE2).amax(-1, keepdim=True)
    for kt in tiles(N):
        s = mm(q, k[:, kt].transpose(-1, -2)) * SCALE2
        mt = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mt)
        e = torch.exp2(s - mt)
        l = l * alpha + e.sum(-1, keepdim=True)
        o = o * alpha + mm(e, v[:, kt])
        m = mt
    return normalize(layout, o, l), m, l


def tc_backward(layout, q, k, v, do, o, m, l, mm=mm3):
    """``(dq, dk, dv)`` as the fp32 dq and dk / dv kernels form them from
    the forward's (m, l) and o: every (query tile, key tile) block's
    products in fresh partials, added in tile order."""
    c = (do * o).sum(-1, keepdim=True)
    dn = do / l
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    for qt in tiles(q.shape[1]):
        for kt in tiles(k.shape[1]):
            s = mm(q[:, qt], k[:, kt].transpose(-1, -2)) * SCALE2
            e = torch.exp2(s - m[:, qt])
            dp = mm(do[:, qt], v[:, kt].transpose(-1, -2))
            ds = ds_of(layout, e, dp, c[:, qt], l[:, qt])
            dq[:, qt] += mm(ds, k[:, kt])
            dk[:, kt] += mm(ds.transpose(-1, -2), q[:, qt])
            dv[:, kt] += mm(e.transpose(-1, -2), dn[:, qt])
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def inputs(layout, N):
    """numpy-seeded fp32 q, k, v, do: (G, N, 64) heads (``Interleaved``:
    the HEADS heads of one sequence)."""
    rng = np.random.default_rng(19 + N + 7 * (layout == "interleaved"))
    n = G if layout == "separate" else HEADS
    return tuple(torch.from_numpy(rng.standard_normal((n, N, D)).astype(
        np.float32)) for _ in range(4))


def model(layout, N, mm=mm3):
    q, k, v, do = inputs(layout, N)
    o, m, l = tc_forward(layout, q, k, v, mm)
    return (o, *tc_backward(layout, q, k, v, do, o, m, l, mm))


@functools.lru_cache(maxsize=None)
def model_cached(layout, N, b_hi="rna"):
    return model(layout, N, functools.partial(mm3, b_hi=b_hi))


@functools.lru_cache(maxsize=None)
def float64(layout, N):
    """o, dq, dk, dv of the exact function in float64."""
    q, k, v, do = (t.double() for t in inputs(layout, N))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    o = torch.softmax(q @ k.transpose(-1, -2) * SCALE, -1) @ v
    return (o.detach(), *torch.autograd.grad(o, leaves, do))


def plain_interleaved(q, k, v, do):
    """The attention lines of ``ops.vit_stack``'s plain forward and
    backward in fp32 (``vit_stack_reference``, ``vit_stack_bwd_reference``
    with T = fp32)."""
    s = torch.matmul(q, k.transpose(-1, -2)) * SCALE2
    e = torch.exp2(s - s.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True)
    o = torch.matmul(e, v) * (1.0 / l)
    dv = torch.matmul(e.transpose(-1, -2), do / l)
    dp = torch.matmul(do, v.transpose(-1, -2))
    c = (dp * e).sum(-1, keepdim=True) / l
    ds = e * ((dp - c) / l) * math.log(2.0) * SCALE2
    return o, torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), dv


@functools.lru_cache(maxsize=None)
def plain_fp32(layout, N):
    q, k, v, do = inputs(layout, N)
    if layout == "interleaved":
        return plain_interleaved(q, k, v, do)
    return (mhsa_reference(q, k, v, SCALE),
            *mhsa_bwd_reference(q, k, v, do, SCALE))


@functools.lru_cache(maxsize=None)
def jax_outputs(layout, N):
    """o, dq, dk, dv of the JAX package as fp32 numpy, (heads, N, 64)."""
    q, k, v, do = (jnp.asarray(t.numpy()) for t in inputs(layout, N))
    if layout == "separate":
        return (_fwd_call(q, k, v, SCALE, interpret=True),
                *_bwd_call(q, k, v, do, SCALE, interpret=True))
    # one sequence: qkv (N, 3C), head h at columns h*64, C + h*64, 2C + h*64
    C = HEADS * D
    cat = lambda t: jnp.concatenate(list(t), -1)   # (H, N, 64) -> (N, H*64)
    qkv = jnp.concatenate([cat(q), cat(k), cat(v)], -1)
    heads, stash = _attn_fwd_heads(qkv, C, HEADS, D, SCALE * LOG2E,
                                   jnp.float32)
    grads = _attn_bwd_heads(cat(do), stash, HEADS, D, SCALE, jnp.float32)
    return tuple(np.stack([np.asarray(h) for h in hs])
                 for hs in (heads, *grads))


def max_err(x, ref):
    return (x.double() - ref).abs().max().item()


def normrel(got, want):
    got, want = got.double().numpy(), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def bar_ratios(layout, N, got):
    return [max_err(g, r) / max_err(p, r) for g, r, p in
            zip(got, float64(layout, N), plain_fp32(layout, N))]


@pytest.mark.parametrize("N", NS)
def test_model_matches_pallas(N):
    """(a), ``Separate``"""
    for name, got, w in zip(OUTPUTS, model_cached("separate", N),
                            jax_outputs("separate", N)):
        rel = normrel(got, w)
        assert rel <= PALLAS_NORMREL, (name, rel)


@pytest.mark.parametrize("N", NS)
def test_interleaved_model_matches_jax(N):
    """(a), ``Interleaved``"""
    for name, got, w in zip(OUTPUTS, model_cached("interleaved", N),
                            jax_outputs("interleaved", N)):
        rel = normrel(got, w)
        assert rel <= PALLAS_NORMREL, (name, rel)


@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("out", OUTPUTS)
def test_model_within_the_float64_bar(N, out):
    """(b), ``Separate``"""
    i = OUTPUTS.index(out)
    ratio = bar_ratios("separate", N, model_cached("separate", N))[i]
    assert ratio <= F64_BAR, ratio


@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("out", OUTPUTS)
def test_interleaved_model_within_the_float64_bar(N, out):
    """(b), ``Interleaved``"""
    i = OUTPUTS.index(out)
    ratio = bar_ratios("interleaved", N, model_cached("interleaved", N))[i]
    assert ratio <= F64_BAR, ratio


@pytest.mark.parametrize("N", NS)
def test_single_tf32_fails_the_bar(N):
    """(c) the worst output of the one-TF32-product model is far outside
    (b)'s bar."""
    ratio = max(bar_ratios("separate", N, model("separate", N, tf32_matmul)))
    assert ratio > 10 * F64_BAR, ratio


@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("layout", ("separate", "interleaved"))
def test_truncated_b_hi_within_the_bar(layout, N):
    """(d) B's raw fp32 word as its hi part keeps every output within the
    bar too."""
    ratio = max(bar_ratios(layout, N, model_cached(layout, N, "trunc")))
    assert ratio <= F64_BAR, ratio


@pytest.mark.parametrize("layout", ("separate", "interleaved"))
def test_one_pass_moves_rounding_points(layout):
    """At N = 576 the running max rises within a row, so e is formed
    against another max than the parent kernels' exact one: some o bits
    differ, and both stay within 1e-5 of each other."""
    q, k, v, _ = inputs(layout, 576)
    o = model_cached(layout, 576)[0]
    o_exact = tc_forward(layout, q, k, v, exact_max=True)[0]
    assert not torch.equal(o, o_exact)
    assert normrel(o, o_exact.numpy()) <= PALLAS_NORMREL
