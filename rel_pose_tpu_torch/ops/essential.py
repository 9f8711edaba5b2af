"""The cross block's attention: the Essential Matrix Module (the paper's
core op) and its --noess ablation.

Counterpart of ``rel_pose_tpu/ops/essential.py:100-153``:

  * ``essential_cross_attention_pair``: the pair block
    (``ops.essential_block``) gives per direction and head a (d+6) x (d+6)
    moment matrix F; this reshapes them head-major, projects with
    ``proj_fundamental`` (h(d+6) -> C) and applies the reference's ViLBERT
    flip;
  * ``noess_cross_attention``: plain softmax cross attention between the two
    images' tokens (``ops.attention``), both directions in one launch, then
    ``proj`` and the same flip.
"""

import torch

from ..nn.layers import linear
from .attention import fused_mhsa
from .essential_block import fused_essential_block_pair


def essential_cross_attention_pair(xp, ln_params, qkv_params, proj_params,
                                   positional, num_heads,
                                   block=fused_essential_block_pair):
    """Raw pair tokens ``xp (B, 2, N, C)`` -> ``(out1, out2)``, each
    ``(B, d+6, C)``, out1 derived from direction 2 (the flip).
    ``block`` is the pair-block function: the kernel wrapper, or
    ``essential_block_pair_reference`` to run the plain version on any
    device."""
    B = xp.shape[0]
    f = block(xp, ln_params, qkv_params, positional,
              num_heads).to(xp.dtype)                 # (B, 2, h, e, e)
    e = f.shape[-1]
    fund_1 = f[:, 0].reshape(B, num_heads * e, e).transpose(-1, -2)
    fund_2 = f[:, 1].reshape(B, num_heads * e, e).transpose(-1, -2)
    fund_2 = linear(fund_2, *proj_params)
    fund_1 = linear(fund_1, *proj_params)
    return fund_2, fund_1


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
