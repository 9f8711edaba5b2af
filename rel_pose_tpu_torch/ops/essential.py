"""The cross block's attention: the Essential Matrix Module (the paper's
core op) and its --noess ablation.

Counterpart of ``rel_pose_tpu/ops/essential.py:61-153``:

  * ``essential_cross_attention_pair``: the pair block
    (``ops.essential_block``, #2) gives per direction and head an e x e
    moment matrix F (e = d + 6, or d without a positional table); this
    reshapes them head-major, projects with ``proj_fundamental`` (h e -> C)
    and applies the reference's ViLBERT flip;
  * ``essential_cross_attention``: the same from the pre-normed token sets
    ``x1, x2`` through #3 (``fused_essential_block_x``);
  * ``noess_cross_attention``: plain softmax cross attention between the two
    images' tokens (``ops.attention``), both directions in one launch, then
    ``proj`` and the same flip.

``cross_features`` and ``use_single_softmax`` are the ablation flags of
``ModelConfig``; ``positional`` is None under ``no_pos_encoding``.
"""

import torch

from ..nn.layers import linear
from .attention import fused_mhsa
from .essential_block import fused_essential_block_pair, \
    fused_essential_block_x


def _project(f, proj_params, dtype):
    """``F (B, 2, h, e, e)`` -> (out1, out2), each ``(B, e, C)``: head-major
    reshape, ``proj_fundamental`` and the flip (out1 from direction 2)."""
    f = f.to(dtype)
    B, _, heads, e, _ = f.shape
    fund_1 = f[:, 0].reshape(B, heads * e, e).transpose(-1, -2)
    fund_2 = f[:, 1].reshape(B, heads * e, e).transpose(-1, -2)
    fund_2 = linear(fund_2, *proj_params)
    fund_1 = linear(fund_1, *proj_params)
    return fund_2, fund_1


def essential_cross_attention_pair(xp, ln_params, qkv_params, proj_params,
                                   positional, num_heads,
                                   cross_features=False,
                                   use_single_softmax=False,
                                   block=fused_essential_block_pair):
    """Raw pair tokens ``xp (B, 2, N, C)`` -> ``(out1, out2)``, each
    ``(B, e, C)``.  ``block`` is the pair-block function: the kernel
    wrapper, or ``essential_block_pair_reference`` to run the plain version
    on any device."""
    f = block(xp, ln_params, qkv_params, positional, num_heads,
              cross_features=cross_features,
              use_single_softmax=use_single_softmax)
    return _project(f, proj_params, xp.dtype)


def essential_cross_attention(x1, x2, qkv_params, proj_params, positional,
                              num_heads, cross_features=False,
                              use_single_softmax=False,
                              block=fused_essential_block_x):
    """``rel_pose_tpu/ops/essential.py:61-97``: pre-normed ``x1, x2 (B, N,
    C)`` -> ``(out1, out2)``, each ``(B, e, C)``.  ``block`` is #3's
    wrapper, or ``essential_block_x_reference``."""
    f = block(x1, x2, qkv_params, positional, num_heads,
              cross_features=cross_features,
              use_single_softmax=use_single_softmax)
    return _project(f, proj_params, x1.dtype)


def noess_cross_attention(x1, x2, qkv_params, proj_params, num_heads,
                          attention=fused_mhsa):
    """The --noess path (``rel_pose_tpu/ops/essential.py:127-153``):
    pre-normed ``x1, x2 (B, N, C)`` -> ``(out1, out2)``, each
    ``(B, N, C)``: y1 = attn(q2, k1) v1 and y2 = attn(q1, k2) v2 as one
    ``(2 B heads, N, d)`` attention call, projected, flipped (out1 from
    y2).  ``attention`` is :func:`ops.attention.fused_mhsa` or
    ``mhsa_reference`` to run the plain version on any device."""
    B, N, C = x1.shape
    d = C // num_heads

    def heads(x):    # (B, N, C) -> q, k, v, each (B, heads, N, d)
        qkv = linear(x, *qkv_params).reshape(B, N, 3, num_heads, d)
        return qkv.permute(2, 0, 3, 1, 4).unbind(0)

    q1, k1, v1 = heads(x1)
    q2, k2, v2 = heads(x2)
    g = (2 * B * num_heads, N, d)
    y = attention(torch.cat([q2, q1]).reshape(g),
                  torch.cat([k1, k2]).reshape(g),
                  torch.cat([v1, v2]).reshape(g), d ** -0.5)
    y = y.reshape(2, B, num_heads, N, d).transpose(2, 3).reshape(2, B, N, C)
    y1 = linear(y[0], *proj_params)
    y2 = linear(y[1], *proj_params)
    return y2, y1
