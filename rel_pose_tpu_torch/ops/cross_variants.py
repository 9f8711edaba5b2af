"""Microbenchmark variants of the essential block's moments kernel.

Counterpart of the Pallas kernel #9 of ``scripts/bench_cross.py`` (:35-164),
which times restructured copies of #4 (``fused_essential_block``) at the
flagship's flags: dual softmax, the ``(B, N, 6)`` positional table appended
to v (e = 70), va = vb, heads of 64.  Inputs ``qkv1, qkv2 (B, N, 3C)``,
result ``F (B, 2, heads, 70, 70)`` fp32, as #4:

  * :func:`essential_block_s` (``_s_kernel``, :88-120): #4's arithmetic,
    each CUDA block handling S pairs of one (direction, head); its plain
    version is #4's, ``essential_block_reference``;
  * :func:`essential_block_variant` (``_variant_kernel``, :35-85), bf16
    only: mode ``"mxu_sums"`` forms the softmax row and column sums on the
    tensor cores, ``"bf16_mul"`` the P product in bf16; its plain version is
    :func:`essential_block_variant_reference`.

On CPU tensors each is its plain version; on CUDA tensors it launches
``rp_essential_block_s`` / ``rp_essential_block_variant`` of
``csrc/cross_variants.cu`` or raises.  No model path runs them: their caller
is ``scripts/bench_cross_torch.py``, for kernel-design work.
"""

import torch

from . import _build
from .essential_block import (HEAD_DIM, LOG2E, POS_COLS, _check_pair,
                              _split, essential_block_reference)

MODES = ("mxu_sums", "bf16_mul")
E = HEAD_DIM + POS_COLS


def _heads(qkv1):
    return qkv1.shape[-1] // 3 // HEAD_DIM


def essential_block_variant_reference(qkv1, qkv2, positional, mode):
    """Plain ``_variant_kernel`` with its mode's rounding, per direction and
    head: s2 = q k^T d^-1/2 log2e in fp32, er = exp2(s2 - mr), ec = exp2(s2 -
    mc), P = bf16(bf16(er) bf16(ec)); ``"mxu_sums"``: lr = sum_j bf16(er),
    lc = sum_i bf16(ec) in fp32; ``"bf16_mul"``: the fp32 sums of er and ec;
    then vb_n = T(vb / lc), av = T((P vb_n) / lr), F = vb^T av in fp32."""
    _check_mode(mode)
    cdt = qkv1.dtype
    q, k, v = _split(torch.stack([qkv1, qkv2], 1), positional, _heads(qkv1))
    q = q.flip(1)              # direction 0: q of image 2 against image 1
    s = torch.matmul(q, k.transpose(-1, -2)) * (HEAD_DIM ** -0.5 * LOG2E)
    er = torch.exp2(s - s.amax(-1, keepdim=True))
    ec = torch.exp2(s - s.amax(-2, keepdim=True))
    erb, ecb = (t.bfloat16().float() for t in (er, ec))
    summed = (erb, ecb) if mode == "mxu_sums" else (er, ec)
    lr = summed[0].sum(-1, keepdim=True)                 # (..., N, 1)
    lc = summed[1].sum(-2, keepdim=True)                 # (..., 1, N)
    p = (erb * ecb).bfloat16().float()
    vb_n = (v / lc.transpose(-1, -2)).to(cdt).float()
    av = (torch.matmul(p, vb_n) / lr).to(cdt).float()
    return torch.matmul(v.transpose(-1, -2), av)          # (B, 2, h, e, e)


def essential_block_s(qkv1, qkv2, positional, S):
    """#4's moments with S pairs per CUDA block (``B % S == 0``); see the
    module docstring for the dispatch."""
    B = qkv1.shape[0]
    if S < 1 or B % S:
        raise ValueError(f"essential_block_s: S = {S} must divide B = {B}")
    if qkv1.device.type == "cpu":
        return essential_block_reference(qkv1, qkv2, positional,
                                         _heads(qkv1))
    f, args = _prepare("essential_block_s", qkv1, qkv2, positional)
    err = _build.library().rp_essential_block_s(
        *args, S, int(qkv1.dtype == torch.bfloat16),
        _build.prepare_launch(qkv1.device))
    _build.check(err, "rp_essential_block_s")
    essential_block_s.launches += 1
    return f


essential_block_s.launches = 0


def essential_block_variant(qkv1, qkv2, positional, mode):
    """``_variant_kernel``'s ``mode`` on bf16 inputs; see the module
    docstring for the dispatch."""
    _check_mode(mode)
    if qkv1.dtype != torch.bfloat16:
        raise TypeError(f"essential_block_variant: bf16 only, got "
                        f"{qkv1.dtype}")
    if qkv1.device.type == "cpu":
        return essential_block_variant_reference(qkv1, qkv2, positional,
                                                 mode)
    f, args = _prepare("essential_block_variant", qkv1, qkv2, positional)
    err = _build.library().rp_essential_block_variant(
        *args, MODES.index(mode), _build.prepare_launch(qkv1.device))
    _build.check(err, "rp_essential_block_variant")
    essential_block_variant.launches += 1
    return f


essential_block_variant.launches = 0


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"essential block variant: mode {mode!r}, expected "
                         f"one of {MODES}")


def _prepare(what, qkv1, qkv2, positional):
    """Launch checks on CUDA tensors -> (F, the leading C arguments)."""
    if qkv1.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {qkv1.device}")
    if positional is None:
        raise ValueError(f"{what}: the variants take a positional table")
    B, N, C3 = qkv1.shape
    heads = _heads(qkv1)
    pos = positional.to(qkv1.dtype).contiguous()
    _check_pair(qkv1, qkv2, pos, C3 // 3, heads)
    f = torch.empty((B, 2, heads, E, E), dtype=torch.float32,
                    device=qkv1.device)
    return f, (qkv1.data_ptr(), qkv2.data_ptr(), pos.data_ptr(),
               f.data_ptr(), B, N, C3 // 3, heads)
