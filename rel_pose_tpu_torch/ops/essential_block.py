"""The Essential Matrix Module's moments: 2 directions x heads of dual (or
single) softmax bilinear moments of an image pair.

Counterpart of ``rel_pose_tpu/ops/pallas_essential_block.py``, whose three
Pallas kernels share one core (``_eb_combos``) behind three prologues; each
has a public op here, with the same arguments and result ``F (B, 2, h, e,
e)`` in fp32, e = d + 6 with a positional table and e = d without:

  * ``fused_essential_block_pair`` (#2, the model's path): the interleaved
    raw pair tokens ``xpair (B, 2, N, C)``, norm1 LayerNorm, the shared qkv
    Linear;
  * ``fused_essential_block_x`` (#3): pre-normed ``x1, x2 (B, N, C)`` and
    the qkv Linear (no LayerNorm);
  * ``fused_essential_block`` (#4): precomputed ``qkv1, qkv2 (B, N, 3C)``;
  * ``essential_block_head_stacked``: #4's function and arguments composed
    from the per-head bilinear op #8 (``ops/bilinear.py``) over the 2 B
    heads (direction, pair, head) slices, as the JAX package's
    ``_head_stacked_impl``; its backward is #8's, by autograd.

Each takes ``positional`` (``(B, N, 6)`` or None) and the flags
``cross_features`` and ``use_single_softmax`` of ``ModelConfig``.  On a CPU
tensor it is its plain PyTorch version (``essential_block_pair_reference``,
``essential_block_x_reference``, ``essential_block_reference``); on a CUDA
tensor it launches the hand kernels of ``csrc/essential_block.cu`` or
raises.

Per direction and head: s = q k^T / sqrt(d), A = softmax_row(s) *
softmax_col(s) in fp32 (softmax_row(s) alone with ``use_single_softmax``),
F = va^T A vb with vb = v ++ positional of the attended image and va = vb,
or with ``cross_features`` va = v ++ positional of the query image.
Direction 0 takes q from image 2 and k, v from image 1.  The rounding is the
Pallas kernel's (``_eb_combos``): P = T(exp2(s - mr) * exp2(s - mc)),
vb_n = T(vb / lc), av = T((P . vb_n) / lr), F = va^T . av accumulated in
fp32, with T the tokens' dtype; with a single softmax P = T(exp2(s - mr))
and vb_n = vb.

Under autograd each op is a ``torch.autograd.Function`` after the Pallas
package's VJPs (``_ebp_bwd``, ``_ebx_bwd``, ``_eb_bwd``): the backward
recomputes the LayerNorm and ``linear_rounded`` in PyTorch where the op has
them, runs :func:`fused_essential_block_bwd` for dqkv and the positional
cotangent -- the plain :func:`essential_block_bwd_reference` on CPU
tensors, the kernel of ``csrc/essential_block_bwd.cu`` (which replaces
``_essential_block_bwd_kernel``) on CUDA tensors -- and chains through the
Linear and the LayerNorm VJP in PyTorch.
"""

import torch

from ..nn.layers import layernorm
from ..nn.transformer import LOG2E
from . import _build
from .bilinear import fused_bilinear_attention

HEAD_DIM = 64          # the kernels' head width
POS_COLS = 6


def linear_rounded(x, weight, bias):
    """``_linear_rounded``: the fp32-accumulated product rounded to x.dtype,
    then the bias added in x.dtype."""
    y = torch.matmul(x.float(), weight.to(x.dtype).float().t()).to(x.dtype)
    return y + bias.to(x.dtype)


def _split(qkv, positional, num_heads):
    """``qkv (B, 2, N, 3C)`` -> fp32 q, k, v ``(B, img, h, N, d)``, v with
    the positional columns (rounded to qkv.dtype) appended."""
    B, _, N, C3 = qkv.shape
    q, k, v = qkv.float().view(B, 2, N, 3, num_heads, C3 // 3 // num_heads) \
        .permute(3, 0, 1, 4, 2, 5)
    if positional is not None:
        pos = positional.to(qkv.dtype).float()[:, None, None]
        v = torch.cat([v, pos.expand(B, 2, num_heads, N, POS_COLS)], -1)
    return q, k, v


def _moments_reference(qkv, positional, num_heads, cross_features,
                       use_single_softmax):
    """The plain ``_eb_combos`` on the pair's rounded ``qkv (B, 2, N,
    3C)``."""
    cdt = qkv.dtype
    d = qkv.shape[-1] // 3 // num_heads
    q, k, v = _split(qkv, positional, num_heads)
    q = q.flip(1)              # direction 0: q of image 2 against image 1
    s = torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5 * LOG2E)
    er = torch.exp2(s - s.amax(-1, keepdim=True))
    lr = er.sum(-1, keepdim=True)                         # (..., N, 1)
    if use_single_softmax:
        p = er.to(cdt).float()
        vb_n = v
    else:
        ec = torch.exp2(s - s.amax(-2, keepdim=True))
        lc = ec.sum(-2, keepdim=True)                     # (..., 1, N)
        p = (er * ec).to(cdt).float()
        vb_n = (v * (1.0 / lc).transpose(-1, -2)).to(cdt).float()
    av = (torch.matmul(p, vb_n) * (1.0 / lr)).to(cdt).float()
    va = v.flip(1) if cross_features else v
    return torch.matmul(va.transpose(-1, -2), av)         # (B, 2, h, e, e)


def essential_block_pair_reference(xpair, ln_params, qkv_params, positional,
                                   num_heads, cross_features=False,
                                   use_single_softmax=False):
    """Plain version of #2.  ``ln_params`` = (scale, bias) of norm1,
    ``qkv_params`` = (weight (3C, C), bias (3C,)), ``positional`` the
    ``(B, N, 6)`` table or None."""
    qkv = linear_rounded(layernorm(xpair, *ln_params), *qkv_params)
    return _moments_reference(qkv, positional, num_heads, cross_features,
                              use_single_softmax)


def essential_block_x_reference(x1, x2, qkv_params, positional, num_heads,
                                cross_features=False,
                                use_single_softmax=False):
    """Plain version of #3: pre-normed ``x1, x2 (B, N, C)``."""
    qkv = linear_rounded(torch.stack([x1, x2], 1), *qkv_params)
    return _moments_reference(qkv, positional, num_heads, cross_features,
                              use_single_softmax)


def essential_block_reference(qkv1, qkv2, positional, num_heads,
                              cross_features=False, use_single_softmax=False):
    """Plain version of #4: ``qkv1, qkv2 (B, N, 3C)``."""
    return _moments_reference(torch.stack([qkv1, qkv2], 1), positional,
                              num_heads, cross_features, use_single_softmax)


def _needs_grad(*tensors):
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _on_card(name, x):
    """True for a CUDA tensor; False for a CPU tensor (the plain version);
    a raise for any other device."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    return True


def _flags(positional, cross_features, use_single_softmax):
    return (int(positional is not None), int(bool(use_single_softmax)),
            int(bool(cross_features)))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _f_out(B, num_heads, positional, device):
    e = HEAD_DIM + (POS_COLS if positional is not None else 0)
    return torch.empty((B, 2, num_heads, e, e), dtype=torch.float32,
                       device=device)


# ------------------------------------------------------------- #2, pair --

def fused_essential_block_pair(xpair, ln_params, qkv_params, positional,
                               num_heads, cross_features=False,
                               use_single_softmax=False):
    """#2; see the module docstring for the dispatch."""
    args = (xpair, *ln_params, *qkv_params, positional)
    flags = (num_heads, cross_features, use_single_softmax)
    if _needs_grad(*args):
        return _EssentialBlockPair.apply(*args, *flags)
    return _pair_forward(*args, *flags)


def _pair_forward(xpair, lns, lnb, w, b, positional, num_heads,
                  cross_features, use_single_softmax):
    if not _on_card("fused_essential_block_pair", xpair):
        return essential_block_pair_reference(
            xpair, (lns, lnb), (w, b), positional, num_heads,
            cross_features, use_single_softmax)
    cdt = xpair.dtype
    B, _, N, C = xpair.shape
    lns, lnb = (t.float().contiguous() for t in (lns, lnb))
    w = w.to(cdt).contiguous()
    b = b.float().contiguous()
    pos = None if positional is None else positional.to(cdt).contiguous()
    _check_inputs(xpair, (lns, lnb, w, b, pos), num_heads)
    f = _f_out(B, num_heads, positional, xpair.device)
    y = torch.empty((2 * B * N, C), dtype=cdt, device=xpair.device)
    qkv = torch.empty((2 * B * N, 3 * C), dtype=cdt, device=xpair.device)
    stream = _build.prepare_launch(xpair.device)
    err = _build.library().rp_essential_block_pair(
        xpair.data_ptr(), lns.data_ptr(), lnb.data_ptr(), w.data_ptr(),
        b.data_ptr(), _ptr(pos), f.data_ptr(), y.data_ptr(), qkv.data_ptr(),
        B, N, C, num_heads,
        *_flags(positional, cross_features, use_single_softmax),
        int(cdt == torch.bfloat16), stream)
    _build.check(err, "rp_essential_block_pair")
    fused_essential_block_pair.launches += 1
    return f


fused_essential_block_pair.launches = 0


class _EssentialBlockPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xpair, lns, lnb, w, b, positional, num_heads,
                cross_features, use_single_softmax):
        ctx.save_for_backward(xpair, lns, lnb, w, b, positional)
        ctx.flags = (num_heads, cross_features, use_single_softmax)
        return _pair_forward(xpair, lns, lnb, w, b, positional, *ctx.flags)

    @staticmethod
    def backward(ctx, g):
        xpair, lns, lnb, w, b, positional = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (xpair, lns, lnb)]
            y = layernorm(*leaves)                          # (B, 2, N, C)
        qkv = linear_rounded(y.detach(), w, b)
        dqkv, dpos = _moments_bwd(qkv, positional, g, *ctx.flags)
        dy = torch.matmul(dqkv, w.to(xpair.dtype).float()).to(xpair.dtype)
        dxpair, dlns, dlnb = torch.autograd.grad(y, leaves, dy)
        dw, db = _linear_grads(dqkv, y.detach(), w, b)
        return dxpair, dlns, dlnb, dw, db, dpos, None, None, None


def _moments_bwd(qkv, positional, g, num_heads, cross_features,
                 use_single_softmax):
    """dqkv (fp32) and the positional cotangent (None without a table) of
    the moments, through :func:`fused_essential_block_bwd`."""
    pos = None if positional is None else positional.to(qkv.dtype)
    dqkv, dpos_part = fused_essential_block_bwd(
        qkv, pos, g.float().contiguous(), num_heads, cross_features,
        use_single_softmax)
    dpos = (None if positional is None
            else sum_dpos(dpos_part).to(positional.dtype))
    return dqkv.float(), dpos


def _linear_grads(dqkv, x, w, b):
    """The qkv Linear's weight and bias gradients from fp32 ``dqkv (B, 2,
    N, 3C)`` and its input ``x (B, 2, N, C)``."""
    dw = torch.einsum("binq,binc->qc", dqkv, x.float())
    return dw.to(w.dtype), dqkv.sum((0, 1, 2)).to(b.dtype)


def sum_dpos(dpos_part):
    """``(B, 2, h, N, 6)`` per-combo positional cotangents -> ``(B, N, 6)``,
    summed in a fixed order (direction-major, then head)."""
    parts = dpos_part.flatten(1, 2).unbind(1)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


# ------------------------------------------------- #3, qkv Linear inside --

def fused_essential_block_x(x1, x2, qkv_params, positional, num_heads,
                            cross_features=False, use_single_softmax=False):
    """#3: pre-normed ``x1, x2 (B, N, C)`` and the qkv Linear ``(weight
    (3C, C), bias (3C,))``; see the module docstring for the dispatch."""
    args = (x1, x2, *qkv_params, positional)
    flags = (num_heads, cross_features, use_single_softmax)
    if _needs_grad(*args):
        return _EssentialBlockX.apply(*args, *flags)
    return _x_forward(*args, *flags)


def _x_forward(x1, x2, w, b, positional, num_heads, cross_features,
               use_single_softmax):
    if not _on_card("fused_essential_block_x", x1):
        return essential_block_x_reference(
            x1, x2, (w, b), positional, num_heads, cross_features,
            use_single_softmax)
    cdt = x1.dtype
    B, N, C = x1.shape
    w = w.to(cdt).contiguous()
    b = b.float().contiguous()
    pos = None if positional is None else positional.to(cdt).contiguous()
    _check_pair(x1, x2, pos, C, num_heads)
    want = ((w, (3 * C, C)), (b, (3 * C,)))
    for t, shape in want:
        if tuple(t.shape) != shape or t.device != x1.device:
            raise ValueError(f"fused_essential_block_x: got a "
                             f"{tuple(t.shape)} tensor on {t.device}, "
                             f"expected {shape} on {x1.device}")
    f = _f_out(B, num_heads, positional, x1.device)
    qkv = torch.empty((2, B, N, 3 * C), dtype=cdt, device=x1.device)
    stream = _build.prepare_launch(x1.device)
    err = _build.library().rp_essential_block_x(
        x1.data_ptr(), x2.data_ptr(), w.data_ptr(), b.data_ptr(), _ptr(pos),
        f.data_ptr(), qkv.data_ptr(), B, N, C, num_heads,
        *_flags(positional, cross_features, use_single_softmax),
        int(cdt == torch.bfloat16), stream)
    _build.check(err, "rp_essential_block_x")
    fused_essential_block_x.launches += 1
    return f


fused_essential_block_x.launches = 0


class _EssentialBlockX(torch.autograd.Function):
    """After ``_ebx_bwd`` (``pallas_essential_block.py:524-553``)."""

    @staticmethod
    def forward(ctx, x1, x2, w, b, positional, num_heads, cross_features,
                use_single_softmax):
        ctx.save_for_backward(x1, x2, w, b, positional)
        ctx.flags = (num_heads, cross_features, use_single_softmax)
        return _x_forward(x1, x2, w, b, positional, *ctx.flags)

    @staticmethod
    def backward(ctx, g):
        x1, x2, w, b, positional = ctx.saved_tensors
        x = torch.stack([x1, x2], 1)                        # (B, 2, N, C)
        qkv = linear_rounded(x, w, b)
        dqkv, dpos = _moments_bwd(qkv, positional, g, *ctx.flags)
        dx = torch.matmul(dqkv, w.to(x.dtype).float()).to(x.dtype)
        dw, db = _linear_grads(dqkv, x, w, b)
        return dx[:, 0], dx[:, 1], dw, db, dpos, None, None, None


# ------------------------------------------------- #4, precomputed qkv --

def fused_essential_block(qkv1, qkv2, positional, num_heads,
                          cross_features=False, use_single_softmax=False):
    """#4: precomputed ``qkv1, qkv2 (B, N, 3C)``; see the module docstring
    for the dispatch."""
    args = (qkv1, qkv2, positional)
    flags = (num_heads, cross_features, use_single_softmax)
    if _needs_grad(*args):
        return _EssentialBlock.apply(*args, *flags)
    return _block_forward(*args, *flags)


def _block_forward(qkv1, qkv2, positional, num_heads, cross_features,
                   use_single_softmax):
    if not _on_card("fused_essential_block", qkv1):
        return essential_block_reference(qkv1, qkv2, positional, num_heads,
                                         cross_features, use_single_softmax)
    cdt = qkv1.dtype
    B, N, C3 = qkv1.shape
    pos = None if positional is None else positional.to(cdt).contiguous()
    _check_pair(qkv1, qkv2, pos, C3 // 3, num_heads)
    f = _f_out(B, num_heads, positional, qkv1.device)
    stream = _build.prepare_launch(qkv1.device)
    err = _build.library().rp_essential_block(
        qkv1.data_ptr(), qkv2.data_ptr(), _ptr(pos), f.data_ptr(), B, N,
        C3 // 3, num_heads,
        *_flags(positional, cross_features, use_single_softmax),
        int(cdt == torch.bfloat16), stream)
    _build.check(err, "rp_essential_block")
    fused_essential_block.launches += 1
    return f


fused_essential_block.launches = 0


class _EssentialBlock(torch.autograd.Function):
    """After ``_eb_bwd`` (``pallas_essential_block.py:461-473``)."""

    @staticmethod
    def forward(ctx, qkv1, qkv2, positional, num_heads, cross_features,
                use_single_softmax):
        ctx.save_for_backward(qkv1, qkv2, positional)
        ctx.flags = (num_heads, cross_features, use_single_softmax)
        return _block_forward(qkv1, qkv2, positional, *ctx.flags)

    @staticmethod
    def backward(ctx, g):
        qkv1, qkv2, positional = ctx.saved_tensors
        dqkv, dpos = _moments_bwd(torch.stack([qkv1, qkv2], 1), positional,
                                  g, *ctx.flags)
        return (dqkv[:, 0].to(qkv1.dtype), dqkv[:, 1].to(qkv2.dtype), dpos,
                None, None, None)


# ------------------------------------------- #4 as 2 B heads slices of #8 --

def essential_block_head_stacked(qkv1, qkv2, positional, num_heads,
                                 cross_features=False,
                                 use_single_softmax=False):
    """#4's function composed from one per-head bilinear op over the
    ``G = 2 B heads`` (direction, pair, head) slices, as
    ``_head_stacked_impl`` (``pallas_essential_block.py:420-458``) does:
    the heads split, the positional table broadcast to ``(B, h, N, 6)`` and
    appended to v, the directions stacked (q = [q2; q1], k = [k1; k2], vb =
    [v1; v2], va = [v2; v1] with ``cross_features``, else vb), one
    :func:`~rel_pose_tpu_torch.ops.bilinear.fused_bilinear_attention` (#8)
    and ``(2, B, h, e, e)`` back to ``(B, 2, h, e, e)``.  Differentiable in
    qkv1, qkv2 and positional by autograd through #8's Function: a second
    route to the moments' forward and backward, beside #4 and #6."""
    B, N, C3 = qkv1.shape
    d = C3 // 3 // num_heads

    def heads(qkv):                                  # 3 x (B, h, N, d)
        return qkv.reshape(B, N, 3, num_heads, d).permute(2, 0, 3, 1, 4)

    q1, k1, v1 = heads(qkv1)
    q2, k2, v2 = heads(qkv2)
    if positional is not None:
        pos = positional.to(v1.dtype)[:, None].expand(B, num_heads, N,
                                                      POS_COLS)
        v1, v2 = torch.cat([v1, pos], -1), torch.cat([v2, pos], -1)
    e = v1.shape[-1]
    stack = lambda a, b, w: torch.stack([a, b]).reshape(2 * B * num_heads,
                                                        N, w)
    vb = stack(v1, v2, e)
    f = fused_bilinear_attention(
        stack(q2, q1, d), stack(k1, k2, d),
        stack(v2, v1, e) if cross_features else vb, vb, d ** -0.5,
        use_single_softmax)
    return f.view(2, B, num_heads, e, e).transpose(0, 1)


# ------------------------------------------------------------ backward --

def essential_block_bwd_reference(qkv, positional, df, num_heads,
                                  cross_features=False,
                                  use_single_softmax=False):
    """Plain backward of the moments from the pair's rounded ``qkv (B, 2,
    N, 3C)``, ``positional (B, N, 6)`` or None and ``df (B, 2, h, e, e)``
    fp32 -> ``(dqkv (B, 2, N, 3C) in qkv.dtype, dpos_part (B, 2, h, N, 6)
    fp32, or None without a table)``.  It repeats
    ``_essential_block_bwd_kernel`` (``pallas_essential_block_bwd.py:
    39-144``) with its T roundings of A, dF, vb dF^T, va dF and ds: s = q k^T
    d^-1/2 log2e, R and Cmat the normalized row and column softmaxes, A = R
    Cmat (R with a single softmax), dva = A T(vb dF^T), dvb = A^T T(va dF),
    dA = T(va dF) vb^T, ds = R (dR - rowsum(dR R)) + Cmat (dC - colsum(dC
    Cmat)) with dR = dA Cmat, dC = dA R (ds = R (dA - rowsum(dA R)) with a
    single softmax), dq = T(ds d^-1/2) k, dk = T(ds d^-1/2)^T q.  dvb goes
    to the attended image's v slot; dva too, summed in fp32 (dv = T(dvb +
    dva)), or with cross features to the query image's v slot, added in T
    as the Pallas kernel does: image 1's v = T(T(dvb_0) + T(dva_1)).  The
    positional columns of dvb and dva stay per combo."""
    cdt = qkv.dtype
    C = qkv.shape[-1] // 3
    d = C // num_heads
    rnd = lambda t: t.to(cdt).float()
    q, k, vs = _split(qkv, positional, num_heads)        # (B, img, h, N, .)
    q = q.flip(1)               # direction 0: q of image 2 against image 1
    va = vs.flip(1) if cross_features else vs
    s = torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5 * LOG2E)
    er = torch.exp2(s - s.amax(-1, keepdim=True))
    R = er / er.sum(-1, keepdim=True)
    if use_single_softmax:
        Ab = rnd(R)
    else:
        ec = torch.exp2(s - s.amax(-2, keepdim=True))
        Cm = ec / ec.sum(-2, keepdim=True)
        Ab = rnd(R * Cm)
    dfb = rnd(df)
    dva = torch.matmul(Ab, rnd(torch.matmul(vs, dfb.transpose(-1, -2))))
    vadf_b = rnd(torch.matmul(va, dfb))
    dvb = torch.matmul(Ab.transpose(-1, -2), vadf_b)
    dA = torch.matmul(vadf_b, vs.transpose(-1, -2))
    if use_single_softmax:
        ds = R * (dA - (dA * R).sum(-1, keepdim=True))
    else:
        dR = dA * Cm
        dC = dA * R
        ds = (R * (dR - (dR * R).sum(-1, keepdim=True))
              + Cm * (dC - (dC * Cm).sum(-2, keepdim=True)))
    dsb = rnd(ds * d ** -0.5)
    dq = torch.matmul(dsb, k).flip(1)                 # back to image order
    dk = torch.matmul(dsb.transpose(-1, -2), q)
    if cross_features:
        dv = rnd(rnd(dvb[..., :d]) + rnd(dva.flip(1)[..., :d]))
        dpos_part = dvb[..., d:] + dva[..., d:]
    else:
        dv = dvb + dva
        dv, dpos_part = dv[..., :d], dv[..., d:]
    B, _, N, C3 = qkv.shape
    dqkv = torch.stack([dq, dk, dv], 2).permute(0, 1, 4, 2, 3, 5)
    return (dqkv.reshape(B, 2, N, C3).to(cdt),
            None if positional is None else dpos_part)


def fused_essential_block_bwd(qkv, positional, df, num_heads,
                              cross_features=False, use_single_softmax=False):
    """Backward of the moments; see :func:`essential_block_bwd_reference`
    for the arguments.  CPU tensors take that plain version, CUDA tensors
    the kernel (or a raise)."""
    if not _on_card("fused_essential_block_bwd", qkv):
        return essential_block_bwd_reference(
            qkv, positional, df, num_heads, cross_features,
            use_single_softmax)
    B, _, N, C3 = qkv.shape
    C = C3 // 3
    has_pos = positional is not None
    e = HEAD_DIM + (POS_COLS if has_pos else 0)
    pos = positional.to(qkv.dtype).contiguous() if has_pos else None
    if (qkv.dtype not in (torch.float32, torch.bfloat16)
            or not qkv.is_contiguous() or C != HEAD_DIM * num_heads
            or (has_pos and tuple(pos.shape) != (B, N, POS_COLS))
            or tuple(df.shape) != (B, 2, num_heads, e, e)
            or df.dtype != torch.float32 or not df.is_contiguous()):
        raise ValueError(
            "fused_essential_block_bwd: needs a contiguous fp32/bf16 qkv "
            f"(B, 2, N, 3*64*heads), pos (B, N, 6) or None and fp32 dF (B, "
            f"2, h, {e}, {e}); got {tuple(qkv.shape)} {qkv.dtype}, "
            f"{None if pos is None else tuple(pos.shape)}, "
            f"{tuple(df.shape)} {df.dtype}")
    lib = _build.library()
    dqkv = torch.empty_like(qkv)
    dpos_part = (torch.empty((B, 2, num_heads, N, POS_COLS),
                             dtype=torch.float32, device=qkv.device)
                 if has_pos else None)
    dva = (torch.empty((B, 2, N, C), dtype=qkv.dtype, device=qkv.device)
           if cross_features else None)
    ws = torch.empty(lib.rp_essential_block_bwd_workspace(
        B, N, num_heads, int(has_pos)), dtype=torch.uint8, device=qkv.device)
    stream = _build.prepare_launch(qkv.device)
    err = lib.rp_essential_block_bwd(
        qkv.data_ptr(), _ptr(pos), df.data_ptr(), dqkv.data_ptr(),
        _ptr(dva), _ptr(dpos_part), ws.data_ptr(), B, N, C, num_heads,
        *_flags(positional, cross_features, use_single_softmax),
        int(qkv.dtype == torch.bfloat16), stream)
    _build.check(err, "rp_essential_block_bwd")
    fused_essential_block_bwd.launches += 1
    if cross_features:       # each image's v: T(T(dvb) + T(dva)), in T
        dqkv[..., 2 * C:] += dva
    return dqkv, dpos_part


fused_essential_block_bwd.launches = 0


# -------------------------------------------------------------- checks --

def _check_inputs(xpair, params, num_heads):
    """#2's launch checks; ``params`` = (ln scale, ln bias, w, b, pos or
    None)."""
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
    if C != HEAD_DIM * num_heads:
        raise ValueError("fused_essential_block_pair: the kernel needs "
                         f"head_dim 64, got C={C} with {num_heads} heads")
    want = [(lns, (C,)), (lnb, (C,)), (w, (3 * C, C)), (b, (3 * C,))]
    if pos is not None:
        want.append((pos, (B, N, POS_COLS)))
    for t, shape in want:
        if tuple(t.shape) != shape or t.device != xpair.device:
            raise ValueError(f"fused_essential_block_pair: got a "
                             f"{tuple(t.shape)} tensor on {t.device}, "
                             f"expected {shape} on {xpair.device}")


def _check_pair(a, b, pos, C, num_heads):
    """#3's and #4's launch checks: two contiguous (B, N, width) tensors of
    one fp32 / bf16 dtype and device, head_dim 64, pos (B, N, 6) or None."""
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise TypeError(f"essential block: dtypes {a.dtype}, {b.dtype} "
                        "(both fp32 or both bf16)")
    if (a.dim() != 3 or a.shape != b.shape or not a.is_contiguous()
            or not b.is_contiguous() or b.device != a.device):
        raise ValueError("essential block: needs two contiguous (B, N, "
                         f"width) tensors, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if C != HEAD_DIM * num_heads:
        raise ValueError("essential block: the kernel needs head_dim 64, "
                         f"got C={C} with {num_heads} heads")
    if pos is not None and (tuple(pos.shape) != a.shape[:2] + (POS_COLS,)
                            or pos.device != a.device):
        raise ValueError(f"essential block: pos {tuple(pos.shape)} on "
                         f"{pos.device}, expected {a.shape[:2] + (6,)}")
