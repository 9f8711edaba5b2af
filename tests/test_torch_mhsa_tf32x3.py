"""PyTorch port: the numerics of kernel #7's fp32 tensor-core kernels
(``csrc/attention_tc.cuh``, layout ``Separate<float>``: every product
3xTF32), through a plain model of them, on the CPU.

The model (:func:`tc_forward`, :func:`tc_backward`) forms what the kernels
form, with ``ops.vit_stack.tf32x3_matmul`` for every product:

  * forward: s = (q . k) * fp32(scale log2 e), the exact row max m over a
    first pass, e = exp2(s - m), the row sum l, o = (e . v) / l, and (m, l)
    kept for the backward;
  * backward from the forward's (m, l) and o: c = do . o (in place of
    ``_bwd_kernel``'s rowsum(dp e) / l, equal in exact arithmetic), dp =
    do . v^T, ds = e ((dp - c) (scale / l)), dq = ds . k, dk = ds^T . q,
    dv = e^T . (do / l).

On numpy-seeded (G = 4, N, 64) inputs, N = 64 and 100 (a ragged last
64-row tile on the card), it is held to:

  (a) the Pallas ``_fwd_call`` / ``_bwd_call`` in interpret mode (as
      tests/test_torch_attention.py runs them), ||model - pallas|| /
      ||pallas|| <= 1e-5 for o, dq, dk, dv: fp32 sums in another order
      and c from do . o [measured <= 4.4e-7];
  (b) the function in float64 (autograd through an exact softmax
      attention): the model's max |err| at most F64_BAR = 2 times that of
      the fp32 plain version (``mhsa_reference``, ``mhsa_bwd_reference``)
      on the same inputs, per output -- ``chip_smoke.py``'s bar (phase 3b),
      which holds the kernels to it on the card [measured ratios
      0.68-1.60];
  (c) a model whose products are one TF32 product each fails (b) by more
      than ten times the bar [worst ratio 473-1,515]: the bar tells TF32
      from 3xTF32.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rel_pose_tpu.ops.pallas_attention import _bwd_call, _fwd_call
from rel_pose_tpu_torch.ops.attention import (LOG2E, mhsa_bwd_reference,
                                              mhsa_reference)
from rel_pose_tpu_torch.ops.vit_stack import tf32_rna, tf32x3_matmul

G, D = 4, 64
SCALE = D ** -0.5
F64_BAR = 2.0
PALLAS_NORMREL = 1e-5
OUTPUTS = ("o", "dq", "dk", "dv")


def tf32_matmul(a, b):
    """One TF32 product: the operands rounded to TF32, summed in fp32."""
    return torch.matmul(tf32_rna(a), tf32_rna(b))


def tc_forward(q, k, v, mm=tf32x3_matmul):
    """``(o, m, l)`` as the fp32 forward kernel forms them."""
    s = mm(q, k.transpose(-1, -2)) * torch.tensor(SCALE * LOG2E,
                                                  dtype=torch.float32)
    m = s.amax(-1, keepdim=True)
    e = torch.exp2(s - m)
    l = e.sum(-1, keepdim=True)
    return mm(e, v) / l, m, l


def tc_backward(q, k, v, do, o, m, l, mm=tf32x3_matmul):
    """``(dq, dk, dv)`` as the fp32 dq and dk / dv kernels form them from
    the forward's (m, l) and o."""
    s = mm(q, k.transpose(-1, -2)) * torch.tensor(SCALE * LOG2E,
                                                  dtype=torch.float32)
    e = torch.exp2(s - m)
    c = (do * o).sum(-1, keepdim=True)
    dp = mm(do, v.transpose(-1, -2))
    ds = e * ((dp - c) * (SCALE / l))
    dq = mm(ds, k)
    dk = mm(ds.transpose(-1, -2), q)
    dv = mm(e.transpose(-1, -2), do / l)
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def inputs(N):
    rng = np.random.default_rng(19 + N)
    return tuple(rng.standard_normal((G, N, D)).astype(np.float32)
                 for _ in range(4))


def model(N, mm=tf32x3_matmul):
    q, k, v, do = (torch.from_numpy(a) for a in inputs(N))
    o, m, l = tc_forward(q, k, v, mm)
    return (o, *tc_backward(q, k, v, do, o, m, l, mm))


@functools.lru_cache(maxsize=None)
def float64(N):
    """o, dq, dk, dv of the exact function in float64."""
    leaves = [torch.from_numpy(a).double().requires_grad_()
              for a in inputs(N)[:3]]
    do = torch.from_numpy(inputs(N)[3]).double()
    q, k, v = leaves
    o = torch.softmax(q @ k.transpose(-1, -2) * SCALE, -1) @ v
    return (o.detach(), *torch.autograd.grad(o, leaves, do))


@functools.lru_cache(maxsize=None)
def plain_fp32(N):
    q, k, v, do = (torch.from_numpy(a) for a in inputs(N))
    return (mhsa_reference(q, k, v, SCALE),
            *mhsa_bwd_reference(q, k, v, do, SCALE))


def max_err(x, ref):
    return (x.double() - ref).abs().max().item()


@pytest.mark.parametrize("N", [64, 100])
def test_model_matches_pallas(N):
    """(a)"""
    q, k, v, do = (jnp.asarray(a) for a in inputs(N))
    want = (_fwd_call(q, k, v, SCALE, interpret=True),
            *_bwd_call(q, k, v, do, SCALE, interpret=True))
    for name, got, w in zip(OUTPUTS, model(N), want):
        w = np.asarray(w, np.float64)
        rel = np.linalg.norm(got.double().numpy() - w) / np.linalg.norm(w)
        assert rel <= PALLAS_NORMREL, (name, rel)


@pytest.mark.parametrize("N", [64, 100])
@pytest.mark.parametrize("out", OUTPUTS)
def test_model_within_the_float64_bar(N, out):
    """(b)"""
    i = OUTPUTS.index(out)
    ref = float64(N)[i]
    ek, ep = max_err(model(N)[i], ref), max_err(plain_fp32(N)[i], ref)
    assert ek <= F64_BAR * ep, (ek, ep)


@pytest.mark.parametrize("N", [64, 100])
def test_single_tf32_fails_the_bar(N):
    """(c) the worst output of the one-TF32-product model is far outside
    (b)'s bar."""
    got = model(N, tf32_matmul)
    ratio = max(max_err(g, r) / max_err(p, r) for g, r, p in
                zip(got, float64(N), plain_fp32(N)))
    assert ratio > 10 * F64_BAR, ratio
