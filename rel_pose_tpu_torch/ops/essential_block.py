"""The Essential Matrix Module's pair block: norm1 LN + shared qkv Linear +
2 directions x heads of dual-softmax bilinear moments.

Counterpart of ``rel_pose_tpu/ops/pallas_essential_block.py``.
``fused_essential_block_pair`` takes the interleaved raw pair tokens
``xpair (B, 2, N, C)`` and returns ``F (B, 2, h, e, e)`` in fp32, e = d + 6:

  * on a CPU tensor it is the plain PyTorch version,
    :func:`essential_block_pair_reference`;
  * on a CUDA tensor it launches the hand kernels of
    ``csrc/essential_block.cu`` (which replace the Pallas
    ``_essential_block_pair_kernel``) or raises.

Per direction and head: s = q k^T / sqrt(d), A = softmax_row(s) *
softmax_col(s) in fp32, F = va^T A vb with va = vb = v ++ positional.
Direction 0 takes q from image 2 and k, v from image 1.  The rounding is
the Pallas kernel's (``_eb_combos``): P = T(exp2(s - mr) * exp2(s - mc)),
vb_n = T(vb / lc), av = T((P . vb_n) / lr), F = va^T . av accumulated in
fp32, with T = xpair.dtype.  Only the slice's configuration is here:
positions on, dual softmax, no cross features.  Eval only.
"""

import torch

from ..nn.layers import layernorm
from ..nn.transformer import LOG2E
from . import _build


def linear_rounded(x, weight, bias):
    """``_linear_rounded``: the fp32-accumulated product rounded to x.dtype,
    then the bias added in x.dtype."""
    y = torch.matmul(x.float(), weight.to(x.dtype).float().t()).to(x.dtype)
    return y + bias.to(x.dtype)


def essential_block_pair_reference(xpair, ln_params, qkv_params, positional,
                                   num_heads):
    """Plain version.  ``ln_params`` = (scale, bias) of norm1,
    ``qkv_params`` = (weight (3C, C), bias (3C,)), ``positional`` the
    ``(B, N, 6)`` table."""
    cdt = xpair.dtype
    B, _, N, C = xpair.shape
    d = C // num_heads
    y = layernorm(xpair, *ln_params)
    qkv = linear_rounded(y, *qkv_params).float()          # (B, 2, N, 3C)
    q, k, v = qkv.view(B, 2, N, 3, num_heads, d).permute(3, 0, 1, 4, 2, 5)
    pos = positional.to(cdt).float()[:, None, None]       # (B, 1, 1, N, 6)
    v = torch.cat([v, pos.expand(B, 2, num_heads, N, 6)], -1)
    q = q.flip(1)              # direction 0: q of image 2 against image 1
    s = torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5 * LOG2E)
    er = torch.exp2(s - s.amax(-1, keepdim=True))
    ec = torch.exp2(s - s.amax(-2, keepdim=True))
    lr = er.sum(-1, keepdim=True)                         # (..., N, 1)
    lc = ec.sum(-2, keepdim=True)                         # (..., 1, N)
    p = (er * ec).to(cdt).float()
    vb_n = (v * (1.0 / lc).transpose(-1, -2)).to(cdt).float()
    av = (torch.matmul(p, vb_n) * (1.0 / lr)).to(cdt).float()
    return torch.matmul(v.transpose(-1, -2), av)          # (B, 2, h, e, e)


def fused_essential_block_pair(xpair, ln_params, qkv_params, positional,
                               num_heads):
    """See the module docstring for the dispatch."""
    if xpair.device.type == "cpu":
        return essential_block_pair_reference(xpair, ln_params, qkv_params,
                                              positional, num_heads)
    if xpair.device.type != "cuda":
        raise ValueError(f"fused_essential_block_pair: no kernel for "
                         f"{xpair.device}")
    cdt = xpair.dtype
    B, _, N, C = xpair.shape
    lns, lnb = (t.float().contiguous() for t in ln_params)
    w = qkv_params[0].to(cdt).contiguous()
    b = qkv_params[1].float().contiguous()
    pos = positional.to(cdt).contiguous()
    _check_inputs(xpair, (lns, lnb, w, b, pos), num_heads)
    f = torch.empty((B, 2, num_heads, 70, 70), dtype=torch.float32,
                    device=xpair.device)
    y = torch.empty((2 * B * N, C), dtype=cdt, device=xpair.device)
    qkv = torch.empty((2 * B * N, 3 * C), dtype=cdt, device=xpair.device)
    stream = _build.prepare_launch(xpair.device)
    err = _build.library().rp_essential_block_pair(
        xpair.data_ptr(), lns.data_ptr(), lnb.data_ptr(), w.data_ptr(),
        b.data_ptr(), pos.data_ptr(), f.data_ptr(), y.data_ptr(),
        qkv.data_ptr(), B, N, C, num_heads, int(cdt == torch.bfloat16),
        stream)
    _build.check(err, "rp_essential_block_pair")
    fused_essential_block_pair.launches += 1
    return f


fused_essential_block_pair.launches = 0


def _check_inputs(xpair, params, num_heads):
    lns, lnb, w, b, pos = params
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xpair, *params)):
        raise RuntimeError("fused_essential_block_pair is eval-only: its "
                           "CUDA kernels have no backward (run under "
                           "torch.no_grad())")
    if xpair.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_essential_block_pair: dtype {xpair.dtype} "
                        "(fp32 or bf16)")
    if (xpair.dim() != 4 or xpair.shape[1] != 2
            or not xpair.is_contiguous()):
        raise ValueError("fused_essential_block_pair: xpair must be a "
                         "contiguous (B, 2, N, C) tensor, got "
                         f"{tuple(xpair.shape)}")
    B, _, N, C = xpair.shape
    if C != 64 * num_heads:
        raise ValueError("fused_essential_block_pair: the kernel needs "
                         f"head_dim 64, got C={C} with {num_heads} heads")
    want = ((lns, (C,)), (lnb, (C,)), (w, (3 * C, C)), (b, (3 * C,)),
            (pos, (B, N, 6)))
    for t, shape in want:
        if tuple(t.shape) != shape or t.device != xpair.device:
            raise ValueError(f"fused_essential_block_pair: got a "
                             f"{tuple(t.shape)} tensor on {t.device}, "
                             f"expected {shape} on {xpair.device}")
