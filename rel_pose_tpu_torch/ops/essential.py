"""Essential Matrix Module cross attention (the paper's core op).

Counterpart of ``rel_pose_tpu/ops/essential.py:100-124``: the pair block
(``ops.essential_block``) gives per direction and head a (d+6) x (d+6)
moment matrix F; this reshapes them head-major, projects with
``proj_fundamental`` (h(d+6) -> C) and applies the reference's ViLBERT flip.
"""

import torch

from ..nn.layers import linear
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
