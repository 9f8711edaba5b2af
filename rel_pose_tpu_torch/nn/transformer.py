"""Pre-LN ViT self-attention block.

Counterpart of ``rel_pose_tpu/nn/transformer.py:35-68``: x + MHSA(LN(x)),
then x + MLP(LN(x)).  ``Block`` only carries the reference's parameter names
(``blocks.{i}.attn.qkv`` ...); the fusion transformer runs its blocks as one
stack (``ops.vit_stack``), whose plain version applies :func:`vit_block`
once per block.

:func:`vit_block` follows the rounding of the Pallas ViT kernel
(``ops/pallas_vit.py:_vit_stack_kernel``), which is the hand kernel's
contract: every Linear is ``T(x . W^T + b)`` with the product accumulated in
fp32, attention is an fp32 ``exp2`` softmax whose unnormalized weights are
rounded to T before the value product, and each residual is
``T(x.f32 + y.f32)``.  T is x.dtype; in fp32 this is the plain block.
"""

import torch
from torch import nn

from .layers import gelu, layernorm

LOG2E = 1.4426950408889634


class Attention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)


def _dense(x, w, b):
    """fp32-accumulated ``x . w^T + b`` (not yet rounded)."""
    return torch.matmul(x.float(), w.float().t()) + b.float()


def vit_block(x, p, num_heads):
    """One block on x ``(G, N, C)``.  ``p`` maps the names of
    ``ops.vit_stack.STACK_FIELDS`` to this block's tensors, already in
    x.dtype where the stack casts them."""
    cdt = x.dtype
    G, N, C = x.shape
    d = C // num_heads
    y = layernorm(x, p["ln1_scale"], p["ln1_bias"])
    qkv = _dense(y, p["qkv_w"], p["qkv_b"]).to(cdt).float()
    q, k, v = qkv.view(G, N, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5 * LOG2E)
    e = torch.exp2(s - s.amax(-1, keepdim=True))
    o = torch.matmul(e.to(cdt).float(), v) * (1.0 / e.sum(-1, keepdim=True))
    attn = o.transpose(1, 2).reshape(G, N, C).to(cdt)
    x = (x.float() + _dense(attn, p["proj_w"], p["proj_b"])).to(cdt)
    y = layernorm(x, p["ln2_scale"], p["ln2_bias"])
    h = gelu(_dense(y, p["fc1_w"], p["fc1_b"]).to(cdt))
    return (x.float() + _dense(h, p["fc2_w"], p["fc2_b"])).to(cdt)
