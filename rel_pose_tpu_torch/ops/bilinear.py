"""Per-head bilinear attention moments over (G, N, *) slices, forward and
backward.

Counterpart of ``rel_pose_tpu/ops/pallas_essential.py`` (Pallas kernel #8).
``fused_bilinear_attention(q, k, va, vb, scale)`` is ``F = va^T A vb`` with
``A = softmax_row(s) * softmax_col(s)`` of ``s = q k^T scale`` (the row
softmax alone with ``single_softmax``), ``(G, N, d)``, ``(G, N, d)``, ``(G,
N, e)``, ``(G, N, e)`` -> ``(G, e, e)`` fp32:

  * on CPU tensors it is the plain PyTorch version,
    :func:`bilinear_attention_reference`;
  * on CUDA tensors it launches ``rp_bilinear_fwd`` of ``csrc/bilinear.cu``
    (which replaces ``_fwd_kernel``) or raises.

Under autograd it is a ``torch.autograd.Function``, as the Pallas op is a
``custom_vjp`` (``_bilinear_pallas``, ``pallas_essential.py:203-217``): the
residuals are the inputs, and the backward is
:func:`fused_bilinear_attention_bwd`, which recomputes -- the plain
:func:`bilinear_attention_bwd_reference` on the CPU, ``rp_bilinear_bwd`` of
``csrc/bilinear_bwd.cu`` (which replaces ``_bwd_kernel``) on CUDA.  When va
and vb are one tensor (the non-cross wiring) autograd adds dva and dvb into
it, as JAX adds the custom VJP's two cotangents.  The kernels take d = 64,
e = 64 or 70, fp32 or bf16, contiguous tensors and any G, N and scale.

The JAX package's one caller is ``_head_stacked_impl``
(``pallas_essential_block.py:420-458``); the port's is
:func:`rel_pose_tpu_torch.ops.essential_block.essential_block_head_stacked`.
"""

import torch

from . import _build

LOG2E = 1.4426950408889634
HEAD_DIM = 64
WIDTHS = (64, 70)       # e without and with the positional columns


def _scores(q, k, scale):
    """fp32 ``q k^T * scale * log2(e)``."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        scale * LOG2E)


def bilinear_attention_reference(q, k, va, vb, scale, single_softmax=False):
    """Plain forward with ``_fwd_kernel``'s rounding
    (``pallas_essential.py:72-97``), T the inputs' dtype: s2 = q k^T scale
    log2e in fp32, P = T(exp2(s2 - mr) exp2(s2 - mc)), vb_n = T(vb / lc),
    av = T((P vb_n) / lr), F = va^T av summed in fp32; with a single
    softmax P = T(exp2(s2 - mr)) and vb_n = vb."""
    cdt = q.dtype
    s = _scores(q, k, scale)
    er = torch.exp2(s - s.amax(-1, keepdim=True))
    lr = er.sum(-1, keepdim=True)                          # (G, N, 1)
    if single_softmax:
        p = er.to(cdt).float()
        vb_n = vb.float()
    else:
        ec = torch.exp2(s - s.amax(-2, keepdim=True))
        lc = ec.sum(-2, keepdim=True)                      # (G, 1, N)
        p = (er * ec).to(cdt).float()
        vb_n = (vb.float() / lc.transpose(-1, -2)).to(cdt).float()
    av = (torch.matmul(p, vb_n) / lr).to(cdt).float()
    return torch.matmul(va.float().transpose(-1, -2), av)


def bilinear_attention_bwd_reference(q, k, va, vb, df, scale,
                                     single_softmax=False):
    """Plain backward ``(dq, dk, dva, dvb)`` in the inputs' dtypes, with
    ``_bwd_kernel``'s T roundings (``pallas_essential.py:100-141``): Ab =
    T(A) of the normalized softmaxes R, Cmat; dva = T(Ab T(vb T(dF)^T)),
    vadf = T(va T(dF)), dvb = T(Ab^T vadf), dA = vadf vb^T in fp32; ds =
    R (dR - rowsum(dR R)) + Cmat (dC - colsum(dC Cmat)) with dR = dA Cmat,
    dC = dA R (R (dA - rowsum(dA R)) with a single softmax); dsb =
    T(ds scale), dq = T(dsb k), dk = T(dsb^T q)."""
    cdt = q.dtype
    rnd = lambda t: t.to(cdt).float()
    s = _scores(q, k, scale)
    er = torch.exp2(s - s.amax(-1, keepdim=True))
    R = er / er.sum(-1, keepdim=True)
    if single_softmax:
        A = R
    else:
        ec = torch.exp2(s - s.amax(-2, keepdim=True))
        Cm = ec / ec.sum(-2, keepdim=True)
        A = R * Cm
    Ab, dfb = rnd(A), rnd(df)
    va_f, vb_f = va.float(), vb.float()
    dva = torch.matmul(Ab, rnd(torch.matmul(vb_f, dfb.transpose(-1, -2))))
    vadf = rnd(torch.matmul(va_f, dfb))
    dvb = torch.matmul(Ab.transpose(-1, -2), vadf)
    dA = torch.matmul(vadf, vb_f.transpose(-1, -2))
    if single_softmax:
        ds = R * (dA - (dA * R).sum(-1, keepdim=True))
    else:
        dR = dA * Cm
        dC = dA * R
        ds = (R * (dR - (dR * R).sum(-1, keepdim=True))
              + Cm * (dC - (dC * Cm).sum(-2, keepdim=True)))
    dsb = rnd(ds * scale)
    dq = torch.matmul(dsb, k.float())
    dk = torch.matmul(dsb.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dva.to(va.dtype), dvb.to(vb.dtype)


def fused_bilinear_attention(q, k, va, vb, scale, single_softmax=False):
    """``F = va^T A vb`` over ``(G, N, *)`` slices, ``(G, e, e)`` fp32; see
    the module docstring for the dispatch."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k, va, vb)):
        return _Bilinear.apply(q, k, va, vb, scale, single_softmax)
    return _forward(q, k, va, vb, scale, single_softmax)


def _forward(q, k, va, vb, scale, single_softmax):
    if q.device.type == "cpu":
        return bilinear_attention_reference(q, k, va, vb, scale,
                                            single_softmax)
    G, N, e = _check_inputs("fused_bilinear_attention", q, k, va, vb)
    f = torch.empty((G, e, e), dtype=torch.float32, device=q.device)
    stream = _build.prepare_launch(q.device)
    err = _build.library().rp_bilinear_fwd(
        q.data_ptr(), k.data_ptr(), va.data_ptr(), vb.data_ptr(),
        f.data_ptr(), G, N, e, int(bool(single_softmax)), scale * LOG2E,
        int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "rp_bilinear_fwd")
    fused_bilinear_attention.launches += 1
    return f


fused_bilinear_attention.launches = 0


class _Bilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, va, vb, scale, single_softmax):
        ctx.save_for_backward(q, k, va, vb)
        ctx.flags = (scale, single_softmax)
        return _forward(q, k, va, vb, scale, single_softmax)

    @staticmethod
    def backward(ctx, df):
        q, k, va, vb = ctx.saved_tensors
        return (*fused_bilinear_attention_bwd(
            q, k, va, vb, df.float().contiguous(), *ctx.flags), None, None)


def fused_bilinear_attention_bwd(q, k, va, vb, df, scale,
                                 single_softmax=False):
    """``(dq, dk, dva, dvb)`` for the fp32 cotangent ``df (G, e, e)``:
    :func:`bilinear_attention_bwd_reference` on CPU tensors,
    ``rp_bilinear_bwd`` on CUDA tensors (or a raise)."""
    if q.device.type == "cpu":
        return bilinear_attention_bwd_reference(q, k, va, vb, df, scale,
                                                single_softmax)
    G, N, e = _check_inputs("fused_bilinear_attention_bwd", q, k, va, vb)
    if (tuple(df.shape) != (G, e, e) or df.dtype != torch.float32
            or df.device != q.device or not df.is_contiguous()):
        raise ValueError("fused_bilinear_attention_bwd: needs a contiguous "
                         f"fp32 dF {(G, e, e)} on {q.device}, got "
                         f"{tuple(df.shape)} {df.dtype} on {df.device}")
    lib = _build.library()
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    dva, dvb = torch.empty_like(va), torch.empty_like(vb)
    ws = torch.empty(lib.rp_bilinear_bwd_workspace(G, N, e),
                     dtype=torch.uint8, device=q.device)
    stream = _build.prepare_launch(q.device)
    err = lib.rp_bilinear_bwd(
        q.data_ptr(), k.data_ptr(), va.data_ptr(), vb.data_ptr(),
        df.data_ptr(), dq.data_ptr(), dk.data_ptr(), dva.data_ptr(),
        dvb.data_ptr(), ws.data_ptr(), G, N, e, int(bool(single_softmax)),
        scale * LOG2E, scale, int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "rp_bilinear_bwd")
    fused_bilinear_attention_bwd.launches += 1
    return dq, dk, dva, dvb


fused_bilinear_attention_bwd.launches = 0


def _check_inputs(what, q, k, va, vb):
    """The kernels' launch checks -> (G, N, e)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {q.dtype} (fp32 or bf16)")
    if q.dim() != 3 or va.dim() != 3:
        raise ValueError(f"{what}: needs (G, N, d) and (G, N, e) tensors, "
                         f"got {tuple(q.shape)}, {tuple(va.shape)}")
    G, N, d = q.shape
    e = va.shape[-1]
    if d != HEAD_DIM or e not in WIDTHS:
        raise ValueError(f"{what}: the kernels take d = {HEAD_DIM} and e in "
                         f"{WIDTHS}, got d = {d}, e = {e}")
    for t, shape in ((q, (G, N, d)), (k, (G, N, d)), (va, (G, N, e)),
                     (vb, (G, N, e))):
        if (tuple(t.shape) != shape or t.dtype != q.dtype
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{what}: every input must be contiguous "
                             f"{q.dtype} on {q.device} with q, k {(G, N, d)}"
                             f" and va, vb {(G, N, e)}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return G, N, e
