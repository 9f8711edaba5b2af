"""NN primitives on tensors, with the JAX package's numerics.

Counterpart of ``rel_pose_tpu/nn/layers.py``.  Weights are in PyTorch's
layouts (Linear ``(out, in)``, Conv2d OIHW) and stay fp32; each function
casts them to the activation dtype where the JAX package does:

  * ``linear``: the product is rounded to the input dtype, then the bias is
    added in that dtype (``nn/layers.py:46-50``);
  * ``layernorm``: eps 1e-6, fp32 statistics (``:59-68``);
  * ``conv_bn_eval``: eval BatchNorm folded into the conv in fp32
    (``:146-168``); ``conv_bn`` picks it or, in training, the explicit
    conv and ``batchnorm_train`` (``:82-111``);
  * ``max_pool_2d``: torch semantics, -inf padding (``:173-194``);
  * ``gelu``: exact erf in fp32, the tanh form in bf16 (``:199-209``),
    evaluated in fp32 and rounded to the input dtype.
"""

import torch
import torch.nn.functional as F

from .. import parallel


def linear(x, weight, bias):
    """``x @ weight.T`` rounded to x.dtype, then ``+ bias`` in x.dtype."""
    return torch.matmul(x, weight.to(x.dtype).t()) + bias.to(x.dtype)


def layernorm(x, weight, bias, eps=1e-6):
    """LayerNorm over the last axis: fp32 statistics and affine, result in
    x.dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def conv_bn_eval(x, conv, bn, weight=None):
    """``conv`` then eval-mode ``bn``, folded into one conv: w' = w * g,
    b' = beta + (b - mean) * g with g = gamma / sqrt(var + eps), computed in
    fp32 and cast to x.dtype.  ``weight`` replaces ``conv.weight`` (the stem
    passes its normalization-folded weight)."""
    w = conv.weight if weight is None else weight
    g = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    w = w * g[:, None, None, None]
    b = bn.bias - bn.running_mean * g
    if conv.bias is not None:
        b = b + conv.bias * g
    y = F.conv2d(x, w.to(x.dtype), None, conv.stride, conv.padding)
    return y + b.to(x.dtype)[:, None, None]


def batchnorm_train(x, bn):
    """Training-mode BatchNorm over NCHW with the JAX formula
    (``nn/layers.py:93-111``): fp32 batch statistics with
    var = E[x^2] - mean^2, normalized in fp32 and cast to x.dtype.  The
    running statistics of ``bn`` move in place, outside autograd, with
    momentum 0.1 and the unbiased variance; ``num_batches_tracked`` += 1.

    In a world of more than one rank (``parallel``) the statistics are the
    global batch's, as XLA takes them over the JAX package's mesh: the fp32
    sums of x and x^2 are summed over the ranks by a differentiable
    all-reduce, so each rank's input gradient carries every rank's loss, and
    n is the global count."""
    xf = x.float()
    n = x.shape[0] * x.shape[2] * x.shape[3]
    if parallel.world_size() > 1:
        sums = parallel.all_reduce_sum(torch.stack(
            [xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3))]))
        n *= parallel.world_size()
        mean = sums[0] / n
        var = sums[1] / n - mean.square()
    else:
        mean = xf.mean((0, 2, 3))
        var = xf.square().mean((0, 2, 3)) - mean.square()
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var
                             + m * (var * (n / max(n - 1, 1))))
        bn.num_batches_tracked += 1
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean[:, None, None]) * inv[:, None, None] \
        + bn.bias[:, None, None]
    return y.to(x.dtype)


def conv_bn(x, conv, bn, training, weight=None):
    """``conv`` then ``bn``: folded (:func:`conv_bn_eval`) in eval mode,
    an explicit conv and :func:`batchnorm_train` in training mode, as
    ``conv_bn_apply`` (``nn/layers.py:146-168``) does."""
    if not training:
        return conv_bn_eval(x, conv, bn, weight)
    w = conv.weight if weight is None else weight
    y = F.conv2d(x, w.to(x.dtype), None, conv.stride, conv.padding)
    if conv.bias is not None:
        y = y + conv.bias.to(x.dtype)[:, None, None]
    return batchnorm_train(y, bn)


def max_pool_2d(x, window=3, stride=2, padding=1):
    return F.max_pool2d(x, window, stride, padding)


def gelu(x):
    approximate = "tanh" if x.dtype == torch.bfloat16 else "none"
    return F.gelu(x.float(), approximate=approximate).to(x.dtype)


def mlp(x, fc1, fc2):
    """timm-style MLP on ``nn.Linear`` modules: fc1 -> GELU -> fc2."""
    return linear(gelu(linear(x, fc1.weight, fc1.bias)), fc2.weight,
                  fc2.bias)
