"""PyTorch port: the numerics of the fp32 ViT stack's tensor-core products
(3xTF32, ``csrc/mma_helpers.cuh`` and ``csrc/attention_wgmma_f32.cuh``),
through their plain model ``ops.vit_stack.tf32x3_matmul``, on the CPU.

  * ``tf32_rna`` rounds as ``cvt.rna.tf32.f32``: to nearest, ties away
    from zero, 10 mantissa bits, against an independent numpy rounding;
  * at the ViT's GEMM shapes (K = 192 with 576 outputs, the qkv Linear;
    K = 768 with 192, fc2), numpy-seeded:
    (a) the split x = hi + lo reconstructs x to within 2^-22 |x|;
    (b) the 3xTF32 product's max error against float64 is at most twice
        that of an fp32 ``torch.matmul`` on the same inputs;
    (c) a single TF32 product fails (b): the check tells TF32 from 3xTF32.

The kernels themselves run only on the card, where ``chip_smoke.py``
(phase 3b) holds them to the plain version run in float64 by the same bar
as (b).
"""

import numpy as np
import pytest
import torch

from rel_pose_tpu_torch.ops.vit_stack import tf32_rna, tf32x3_matmul

# (K, output columns) of the ViT stack's Linears: qkv and fc2
SHAPES = [(192, 576), (768, 192)]
ROWS = 320


def operands(K, n_out, seed=0):
    """Tokens and a Linear weight scaled like PyTorch's init, (ROWS, K) and
    (K, n_out) fp32."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((ROWS, K)).astype(np.float32)
    b = (rng.standard_normal((K, n_out)) * K ** -0.5).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


def rna_numpy(x):
    """Round fp32 values to 11 significant bits, ties away from zero, in
    float64 arithmetic: m * 2^e with |m| in [1, 2) rounded to a multiple of
    2^-10."""
    x = x.astype(np.float64)
    out = np.zeros_like(x)
    nz = x != 0
    e = np.floor(np.log2(np.abs(x[nz])))
    ulp = np.exp2(e - 10)
    out[nz] = np.sign(x[nz]) * np.floor(np.abs(x[nz]) / ulp + 0.5) * ulp
    return out


def test_tf32_rna_ties_away_from_zero():
    half = 2.0 ** -11                 # half a TF32 ulp at 1
    x = torch.tensor([1 + half, -(1 + half), 1 + 3 * half, 1 + half * 0.999,
                      2.0 ** -130, 0.0, -0.0, float("inf")],
                     dtype=torch.float32)
    want = torch.tensor([1 + 2 * half, -(1 + 2 * half), 1 + 4 * half, 1.0,
                         2.0 ** -130, 0.0, -0.0, float("inf")],
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    assert torch.isnan(tf32_rna(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e4])
def test_tf32_rna_matches_numpy(scale):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4096) * scale).astype(np.float32)
    got = tf32_rna(torch.from_numpy(x))
    bits = got.view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0     # the low 13 bits clear
    np.testing.assert_array_equal(got.numpy().astype(np.float64),
                                  rna_numpy(x))


@pytest.mark.parametrize("K,n_out", SHAPES)
def test_split_reconstructs_to_2pow_minus22(K, n_out):
    """(a) hi = rna(x), lo = rna(x - hi): |x - hi - lo| <= 2^-22 |x|."""
    a, b = operands(K, n_out)
    for x in (a, b):
        hi = tf32_rna(x)
        lo = tf32_rna(x - hi)
        err = (x.double() - hi.double() - lo.double()).abs()
        assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


def max_err(c, ref):
    return (c.double() - ref).abs().max().item()


@pytest.mark.parametrize("K,n_out", SHAPES)
def test_3xtf32_error_within_twice_fp32(K, n_out):
    """(b) the 3xTF32 product against float64: at most 2x the max error of
    fp32 ``torch.matmul``."""
    a, b = operands(K, n_out)
    ref = a.double() @ b.double()
    fp32 = max_err(torch.matmul(a, b), ref)
    assert max_err(tf32x3_matmul(a, b), ref) <= 2 * fp32


@pytest.mark.parametrize("K,n_out", SHAPES)
def test_single_tf32_fails_the_bar(K, n_out):
    """(c) one TF32 product, hi . hi, is far outside (b)'s bar: it keeps
    about 3 decimal digits."""
    a, b = operands(K, n_out)
    ref = a.double() @ b.double()
    fp32 = max_err(torch.matmul(a, b), ref)
    one = max_err(torch.matmul(tf32_rna(a), tf32_rna(b)), ref)
    assert one > 2 * fp32
    assert one > 50 * max_err(tf32x3_matmul(a, b), ref)
