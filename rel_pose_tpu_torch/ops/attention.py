"""Softmax attention over (G, N, d) heads, forward and backward.

Counterpart of ``rel_pose_tpu/ops/pallas_attention.py`` (Pallas kernel #7,
the --noess cross block's attention).  ``fused_mhsa(q, k, v, scale)`` is
``softmax(q k^T scale) v``:

  * on CPU tensors it is the plain PyTorch version, :func:`mhsa_reference`;
  * on CUDA tensors it launches ``rp_mhsa_fwd`` of ``csrc/mhsa.cu`` (which
    replaces ``_fwd_kernel``) or raises.

Under autograd (grad enabled and an input that requires grad) it is a
``torch.autograd.Function``, as the Pallas op is a ``custom_vjp``
(``pallas_attention.py:146-161``): the forward saves q, k, v and the
backward is :func:`fused_mhsa_bwd` -- the plain :func:`mhsa_bwd_reference`
on the CPU, ``rp_mhsa_bwd`` (which replaces ``_bwd_kernel``) on CUDA.  The
kernels take head width d = 64, fp32 or bf16, contiguous tensors.
"""

import torch

from . import _build

LOG2E = 1.4426950408889634


def mhsa_reference(q, k, v, scale):
    """Plain version of ``mhsa_reference`` (``pallas_attention.py:41-45``):
    scores in the input dtype, an fp32 softmax rounded to it, ``p @ v``."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def mhsa_bwd_reference(q, k, v, do, scale):
    """``(dq, dk, dv)`` as ``_bwd_kernel`` (``pallas_attention.py:69-99``)
    forms them: e = exp2(s - max) of the fp32 scores s = q k^T scale
    log2(e) and its fp32 row sum l recomputed; every product takes operands
    in the input dtype T and sums in fp32; dv = T(e)^T T(do / l),
    dp = do v^T, c = rowsum(dp e) / l, ds = T(e (dp - c) (scale / l)),
    dq = ds k, dk = ds^T q, each rounded to T."""
    cdt = q.dtype
    rnd = lambda t: t.to(cdt).float()
    q, k, v, do = (t.float() for t in (q, k, v, do))
    s = torch.matmul(q, k.transpose(-1, -2)) * (scale * LOG2E)
    e = torch.exp2(s - s.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True)
    dv = torch.matmul(rnd(e).transpose(-1, -2), rnd(do / l))
    dp = torch.matmul(do, v.transpose(-1, -2))
    c = (dp * e).sum(-1, keepdim=True) / l
    ds = rnd(e * ((dp - c) * (scale / l)))
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return dq.to(cdt), dk.to(cdt), dv.to(cdt)


def fused_mhsa(q, k, v, scale):
    """``softmax(q k^T scale) v`` over ``(G, N, d)``; see the module
    docstring for the dispatch."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Mhsa.apply(q, k, v, scale)
    if q.device.type == "cpu":
        return mhsa_reference(q, k, v, scale)
    return _launch_fwd(q, k, v, scale)


fused_mhsa.launches = 0


class _Mhsa(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if q.device.type == "cpu":
            return mhsa_reference(q, k, v, scale)
        return _launch_fwd(q, k, v, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*fused_mhsa_bwd(q, k, v, do.contiguous(), ctx.scale), None)


def fused_mhsa_bwd(q, k, v, do, scale):
    """``(dq, dk, dv)``: :func:`mhsa_bwd_reference` on CPU tensors,
    ``rp_mhsa_bwd`` on CUDA tensors (or a raise)."""
    if q.device.type == "cpu":
        return mhsa_bwd_reference(q, k, v, do, scale)
    _check_inputs("fused_mhsa_bwd", q, k, v, do)
    G, N, d = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty((G, N, 3), dtype=torch.float32, device=q.device)
    stream = _build.prepare_launch(q.device)
    err = _build.library().rp_mhsa_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        G, N, d, scale, int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "rp_mhsa_bwd")
    fused_mhsa_bwd.launches += 1
    return dq, dk, dv


fused_mhsa_bwd.launches = 0


def _launch_fwd(q, k, v, scale):
    """``rp_mhsa_fwd`` on CUDA tensors."""
    _check_inputs("fused_mhsa", q, k, v)
    G, N, d = q.shape
    o = torch.empty_like(q)
    stream = _build.prepare_launch(q.device)
    err = _build.library().rp_mhsa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), G, N, d,
        scale, int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "rp_mhsa_fwd")
    fused_mhsa.launches += 1
    return o


def _check_inputs(what, q, *others):
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {q.dtype} (fp32 or bf16)")
    if q.dim() != 3 or q.shape[-1] != 64:
        raise ValueError(f"{what}: the kernel takes (G, N, 64) heads, got "
                         f"{tuple(q.shape)}")
    for t in (q, *others):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{what}: every input must be a contiguous "
                             f"{tuple(q.shape)} {q.dtype} tensor on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
