"""PyTorch port vs the JAX package: preprocessing, positional encoding and
the eval-mode layers (rel_pose_tpu_torch.ops.image / ops.posenc / nn.layers).

Inputs come from a numpy seed and go through both packages as numpy.
Tolerances: index gathers are exact; the positional table and the fp32
layers agree to 1e-6 (the same fp32 arithmetic, summed in another order);
bf16 results agree to one bf16 ulp of their magnitude, since XLA and
PyTorch may round a bf16 product or GELU at different points.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rel_pose_tpu.nn import layers as jl
from rel_pose_tpu.ops import image as jimage
from rel_pose_tpu.ops import posenc as jposenc
from rel_pose_tpu_torch.nn import layers as tl
from rel_pose_tpu_torch.ops import image as timage
from rel_pose_tpu_torch.ops import posenc as tposenc

RNG = np.random.default_rng(7)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("hw,size", [((256, 256), 224), ((480, 640), 224),
                                     ((480, 640), (384, 512)),
                                     ((384, 512), 224)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_nearest_resize_exact(hw, size, dtype):
    x = RNG.integers(0, 256, (2, 3) + hw).astype(dtype)
    want = np.asarray(jimage.nearest_resize(jnp.asarray(x), size))
    got = timage.nearest_resize(torch.from_numpy(x), size).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_nearest_resize_640_to_512_width():
    x = RNG.standard_normal((1, 3, 8, 640)).astype(np.float32)
    want = np.asarray(jimage.nearest_resize(jnp.asarray(x), (8, 512)))
    got = timage.nearest_resize(torch.from_numpy(x), (8, 512)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(3, 2, 3, 256, 256), (1, 2, 3, 384, 512)])
def test_scale_intrinsics(shape):
    intr = RNG.uniform(50, 600, (shape[0], 2, 4)).astype(np.float32)
    want = np.asarray(jimage.scale_intrinsics(jnp.asarray(intr), shape))
    got = timage.scale_intrinsics(torch.from_numpy(intr), shape).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_patches", [576, 64])
def test_quadratic_positional_encoding(num_patches):
    intr = np.tile(np.array([[[517.97, 517.97, 320.0, 240.0]],
                             [[128.0, 128.0, 128.0, 128.0]],
                             [[300.0, 310.0, 250.0, 190.0]]], np.float32),
                   (1, 2, 1))
    grid = jimage.scale_intrinsics(jnp.asarray(intr), (480, 640))
    want = np.asarray(jposenc.quadratic_positional_encoding(
        num_patches, grid))
    got = tposenc.quadratic_positional_encoding(
        num_patches, torch.from_numpy(np.array(grid))).numpy()
    assert got.shape == (3, num_patches, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_positional_encoding_rejects_non_square():
    with pytest.raises(ValueError):
        tposenc.quadratic_positional_encoding(48 * 64,
                                              torch.ones(1, 2, 4))


def test_normalization_fold_matches_explicit_normalize():
    """conv(x - 255*mean_bgr, flip(w) * inv_std) == conv(normalized RGB)."""
    x = RNG.integers(0, 256, (2, 3, 20, 20)).astype(np.float32)
    w = RNG.standard_normal((4, 3, 7, 7)).astype(np.float32)
    mean, inv_std = timage.normalization_constants(torch.float32, "cpu")
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    folded = torch.nn.functional.conv2d(xt - mean, wt.flip(1) * inv_std,
                                        stride=2, padding=3)
    norm = np.asarray(jimage.preprocess_images(jnp.asarray(x)))
    explicit = torch.nn.functional.conv2d(torch.from_numpy(norm), wt,
                                          stride=2, padding=3)
    np.testing.assert_allclose(folded.numpy(), explicit.numpy(), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_rounding(dtype):
    x = RNG.standard_normal((4, 9, 48)).astype(np.float32)
    w = RNG.standard_normal((48, 20)).astype(np.float32) * 0.2   # (in, out)
    b = RNG.standard_normal(20).astype(np.float32)
    want = jl.linear_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                           jnp.asarray(x).astype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tl.linear(tx, torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    assert got.dtype == tx.dtype
    atol = 1e-5 if dtype == "float32" else 2 ** -8 * 8
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm(dtype):
    x = RNG.standard_normal((3, 7, 48)).astype(np.float32) * 3 + 1
    s = 1 + 0.1 * RNG.standard_normal(48).astype(np.float32)
    b = 0.1 * RNG.standard_normal(48).astype(np.float32)
    want = jl.layernorm_apply({"scale": jnp.asarray(s),
                               "bias": jnp.asarray(b)},
                              jnp.asarray(x).astype(dtype))
    got = tl.layernorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                       torch.from_numpy(s), torch.from_numpy(b))
    atol = 1e-5 if dtype == "float32" else 2 ** -8 * 4
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_policy(dtype):
    x = np.linspace(-6, 6, 241).astype(np.float32)
    want = jl.gelu(jnp.asarray(x).astype(dtype))
    got = tl.gelu(torch.from_numpy(x).to(getattr(torch, dtype)))
    atol = 1e-6 if dtype == "float32" else 2 ** -8 * 6
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("stride,padding,bias", [(1, 1, False),
                                                 (2, 3, False),
                                                 (1, 0, True)])
def test_conv_bn_eval_fold(stride, padding, bias):
    cin, cout, k = 5, 6, 3
    x = RNG.standard_normal((2, cin, 12, 12)).astype(np.float32)
    w = RNG.standard_normal((cout, cin, k, k)).astype(np.float32) * 0.3
    cb = RNG.standard_normal(cout).astype(np.float32)
    g = 1 + 0.1 * RNG.standard_normal(cout).astype(np.float32)
    beta = 0.1 * RNG.standard_normal(cout).astype(np.float32)
    mean = 0.1 * RNG.standard_normal(cout).astype(np.float32)
    var = RNG.uniform(0.5, 1.5, cout).astype(np.float32)
    jconv = {"w": jnp.asarray(w)}
    if bias:
        jconv["b"] = jnp.asarray(cb)
    want, _ = jl.conv_bn_apply(
        jconv, {"scale": jnp.asarray(g), "bias": jnp.asarray(beta)},
        {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
        jnp.asarray(x), False, stride=stride, padding=padding)
    conv = torch.nn.Conv2d(cin, cout, k, stride, padding, bias=bias)
    bn = torch.nn.BatchNorm2d(cout).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        if bias:
            conv.bias.copy_(torch.from_numpy(cb))
        for t, v in ((bn.weight, g), (bn.bias, beta),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
        got = tl.conv_bn_eval(torch.from_numpy(x), conv, bn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_max_pool_pads_with_neg_inf():
    x = -np.abs(RNG.standard_normal((2, 3, 9, 9))).astype(np.float32) - 1
    want = np.asarray(jl.max_pool_2d(jnp.asarray(x)))
    got = tl.max_pool_2d(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
