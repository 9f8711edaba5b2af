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
positions on, dual softmax, no cross features.

Under autograd the pair block is a ``torch.autograd.Function`` after
``_ebp_bwd`` (``pallas_essential_block.py:577-614``): the backward
recomputes the LayerNorm and ``linear_rounded`` in PyTorch, runs
:func:`fused_essential_block_bwd` for dqkv and the positional cotangent --
the plain :func:`essential_block_bwd_reference` on CPU tensors, the kernel
of ``csrc/essential_block_bwd.cu`` (which replaces
``_essential_block_bwd_kernel``) on CUDA tensors -- and chains through the
Linear and the LayerNorm VJP in PyTorch.
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
    args = (xpair, *ln_params, *qkv_params, positional)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _EssentialBlockPair.apply(*args, num_heads)
    return _forward(*args, num_heads)


def _forward(xpair, lns, lnb, w, b, positional, num_heads):
    if xpair.device.type == "cpu":
        return essential_block_pair_reference(xpair, (lns, lnb), (w, b),
                                              positional, num_heads)
    if xpair.device.type != "cuda":
        raise ValueError(f"fused_essential_block_pair: no kernel for "
                         f"{xpair.device}")
    cdt = xpair.dtype
    B, _, N, C = xpair.shape
    lns, lnb = (t.float().contiguous() for t in (lns, lnb))
    w = w.to(cdt).contiguous()
    b = b.float().contiguous()
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


class _EssentialBlockPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xpair, lns, lnb, w, b, positional, num_heads):
        ctx.save_for_backward(xpair, lns, lnb, w, b, positional)
        ctx.num_heads = num_heads
        return _forward(xpair, lns, lnb, w, b, positional, num_heads)

    @staticmethod
    def backward(ctx, g):
        xpair, lns, lnb, w, b, positional = ctx.saved_tensors
        cdt = xpair.dtype
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (xpair, lns, lnb)]
            y = layernorm(*leaves)                          # (B, 2, N, C)
        qkv = linear_rounded(y.detach(), w, b)
        dqkv, dpos_part = fused_essential_block_bwd(
            qkv, positional.to(cdt), g.float().contiguous(), ctx.num_heads)
        dqkv = dqkv.float()
        dy = torch.matmul(dqkv, w.to(cdt).float()).to(cdt)
        dxpair, dlns, dlnb = torch.autograd.grad(y, leaves, dy)
        dw = torch.einsum("binq,binc->qc", dqkv, y.detach().float())
        db = dqkv.sum((0, 1, 2))
        return (dxpair, dlns, dlnb, dw.to(w.dtype), db.to(b.dtype),
                sum_dpos(dpos_part).to(positional.dtype), None)


def sum_dpos(dpos_part):
    """``(B, 2, h, N, 6)`` per-combo positional cotangents -> ``(B, N, 6)``,
    summed in a fixed order (direction-major, then head)."""
    parts = dpos_part.flatten(1, 2).unbind(1)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def essential_block_bwd_reference(qkv, positional, df, num_heads):
    """Plain backward of the dual-softmax moments from the pair's rounded
    ``qkv (B, 2, N, 3C)``, ``positional (B, N, 6)`` and ``df (B, 2, h, e,
    e)`` fp32 -> ``(dqkv (B, 2, N, 3C) in qkv.dtype, dpos_part (B, 2, h, N,
    6) fp32)``.  It repeats ``_essential_block_bwd_kernel``
    (``pallas_essential_block_bwd.py:39-144``) for the slice's case
    (positions on, dual softmax, no cross features), with its T roundings
    of A, dF, va dF and ds: s = q k^T d^-1/2 log2e, R and Cmat the
    normalized row and column softmaxes, A = R Cmat,
    dva = A T(vb dF^T), dvb = A^T T(va dF), dA = T(va dF) vb^T,
    ds = R (dR - rowsum(dR R)) + Cmat (dC - colsum(dC Cmat)) with
    dR = dA Cmat, dC = dA R, dq = T(ds d^-1/2) k, dk = T(ds d^-1/2)^T q."""
    cdt = qkv.dtype
    B, _, N, C3 = qkv.shape
    C = C3 // 3
    d = C // num_heads
    rnd = lambda t: t.to(cdt).float()
    q, k, v = qkv.float().view(B, 2, N, 3, num_heads, d) \
        .permute(3, 0, 1, 4, 2, 5)                       # (B, img, h, N, d)
    pos = positional.to(cdt).float()[:, None, None]
    vs = torch.cat([v, pos.expand(B, 2, num_heads, N, 6)], -1)
    q = q.flip(1)               # direction 0: q of image 2 against image 1
    s = torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5 * LOG2E)
    er = torch.exp2(s - s.amax(-1, keepdim=True))
    R = er / er.sum(-1, keepdim=True)
    ec = torch.exp2(s - s.amax(-2, keepdim=True))
    Cm = ec / ec.sum(-2, keepdim=True)
    Ab = rnd(R * Cm)
    dfb = rnd(df)
    dva = torch.matmul(Ab, rnd(torch.matmul(vs, dfb.transpose(-1, -2))))
    vadf_b = rnd(torch.matmul(vs, dfb))
    dvb = torch.matmul(Ab.transpose(-1, -2), vadf_b)
    dA = torch.matmul(vadf_b, vs.transpose(-1, -2))
    dR = dA * Cm
    dC = dA * R
    ds = (R * (dR - (dR * R).sum(-1, keepdim=True))
          + Cm * (dC - (dC * Cm).sum(-2, keepdim=True)))
    dsb = rnd(ds * d ** -0.5)
    dq = torch.matmul(dsb, k).flip(1)                 # back to image order
    dk = torch.matmul(dsb.transpose(-1, -2), q)
    dv = dvb + dva
    dqkv = torch.stack([dq, dk, dv[..., :d]], 2).permute(0, 1, 4, 2, 3, 5)
    return dqkv.reshape(B, 2, N, C3).to(cdt), dv[..., d:]


def fused_essential_block_bwd(qkv, positional, df, num_heads):
    """Backward of the dual-softmax moments; see
    :func:`essential_block_bwd_reference` for the arguments.  CPU tensors
    take that plain version, CUDA tensors the kernel (or a raise)."""
    if qkv.device.type == "cpu":
        return essential_block_bwd_reference(qkv, positional, df, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_essential_block_bwd: no kernel for "
                         f"{qkv.device}")
    B, _, N, C3 = qkv.shape
    e = C3 // 3 // num_heads + 6
    pos = positional.to(qkv.dtype).contiguous()
    if (qkv.dtype not in (torch.float32, torch.bfloat16)
            or not qkv.is_contiguous() or C3 != 3 * 64 * num_heads
            or tuple(pos.shape) != (B, N, 6)
            or tuple(df.shape) != (B, 2, num_heads, e, e)
            or df.dtype != torch.float32 or not df.is_contiguous()):
        raise ValueError(
            "fused_essential_block_bwd: needs a contiguous fp32/bf16 qkv "
            f"(B, 2, N, 3*64*heads), pos (B, N, 6) and fp32 dF (B, 2, h, "
            f"70, 70); got {tuple(qkv.shape)} {qkv.dtype}, "
            f"{tuple(pos.shape)}, {tuple(df.shape)} {df.dtype}")
    lib = _build.library()
    dqkv = torch.empty_like(qkv)
    dpos_part = torch.empty((B, 2, num_heads, N, 6), dtype=torch.float32,
                            device=qkv.device)
    ws = torch.empty(lib.rp_essential_block_bwd_workspace(B, N, num_heads),
                     dtype=torch.uint8, device=qkv.device)
    stream = _build.prepare_launch(qkv.device)
    err = lib.rp_essential_block_bwd(
        qkv.data_ptr(), pos.data_ptr(), df.data_ptr(), dqkv.data_ptr(),
        dpos_part.data_ptr(), ws.data_ptr(), B, N, C3 // 3,
        num_heads, int(qkv.dtype == torch.bfloat16), stream)
    _build.check(err, "rp_essential_block_bwd")
    fused_essential_block_bwd.launches += 1
    return dqkv, dpos_part


fused_essential_block_bwd.launches = 0


def _check_inputs(xpair, params, num_heads):
    lns, lnb, w, b, pos = params
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
