"""Softmax attention over (G, N, d) heads, forward and backward.

Counterpart of ``rel_pose_tpu/ops/pallas_attention.py`` (Pallas kernel #7,
the --noess cross block's attention).  ``fused_mhsa(q, k, v, scale)`` is
``softmax(q k^T scale) v``:

  * on CPU tensors it is the plain PyTorch version, :func:`mhsa_reference`;
  * on CUDA tensors it launches ``rp_mhsa_fwd`` of ``csrc/mhsa.cu`` (which
    replaces ``_fwd_kernel``: wgmma + TMA kernels, one pass with online
    rescaling, bf16 on ``csrc/attention_wgmma.cuh``, fp32 as 3xTF32 on the
    TF32 ones of ``csrc/attention_wgmma_f32.cuh``) or raises.

Under autograd (grad enabled and an input that requires grad) it is a
``torch.autograd.Function``, as the Pallas op is a ``custom_vjp``
(``pallas_attention.py:146-161``): the forward saves q, k, v and the
backward is :func:`fused_mhsa_bwd` -- the plain :func:`mhsa_bwd_reference`
on the CPU, ``rp_mhsa_bwd`` (which replaces ``_bwd_kernel``) on CUDA.  The
Pallas backward recomputes each row's score max m and sum l; the kernels'
forward writes them under autograd (3 G N fp32 values, the third slot the
backward's) and saves its output o beside them, and the backward reads
both (c = do . o in place of rowsum(dp e) / l, equal in exact arithmetic,
so that the dq kernel makes one pass over the keys).  Called without
them, the backward first runs the forward with statistics: the same bits
either way.  The kernels take head width d = 64, fp32 or bf16, contiguous
tensors and at most 65,535 heads (the launch grid's third dimension:
10,922 pairs of the --noess model, 6 heads a pair).
"""

import torch

from . import _build

LOG2E = 1.4426950408889634
MAX_HEADS = 65535
_KERNEL_DEVICE = "cuda"   # the device type the kernels launch on


def mhsa_reference(q, k, v, scale):
    """Plain version of ``mhsa_reference`` (``pallas_attention.py:41-45``):
    scores in the input dtype, an fp32 softmax rounded to it, ``p @ v``."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def _exp_scores(q, k, scale):
    """``(e, m, l)``: the fp32 scores s = q k^T scale log2(e), their row
    max m, e = exp2(s - m) and its row sum l, as ``_fwd_kernel`` and
    ``_bwd_kernel`` form them (``pallas_attention.py:58-62``, ``:79-82``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * LOG2E)
    m = s.amax(-1, keepdim=True)
    e = torch.exp2(s - m)
    return e, m, e.sum(-1, keepdim=True)


def mhsa_stats_reference(q, k, scale):
    """``(G, N, 2)`` fp32: each query row's (m, l), the statistics that the
    kernels' forward keeps in the first two slots of ``stats``."""
    _, m, l = _exp_scores(q, k, scale)
    return torch.cat([m, l], -1)


def mhsa_bwd_reference(q, k, v, do, scale):
    """``(dq, dk, dv)`` as ``_bwd_kernel`` (``pallas_attention.py:69-99``)
    forms them: e = exp2(s - max) of the fp32 scores s = q k^T scale
    log2(e) and its fp32 row sum l recomputed; every product takes operands
    in the input dtype T and sums in fp32; dv = T(e)^T T(do / l),
    dp = do v^T, c = rowsum(dp e) / l, ds = T(e (dp - c) (scale / l)),
    dq = ds k, dk = ds^T q, each rounded to T."""
    cdt = q.dtype
    rnd = lambda t: t.to(cdt).float()
    e, _, l = _exp_scores(q, k, scale)
    q, k, v, do = (t.float() for t in (q, k, v, do))
    dv = torch.matmul(rnd(e).transpose(-1, -2), rnd(do / l))
    dp = torch.matmul(do, v.transpose(-1, -2))
    c = (dp * e).sum(-1, keepdim=True) / l
    ds = rnd(e * ((dp - c) * (scale / l)))
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return dq.to(cdt), dk.to(cdt), dv.to(cdt)


def _plain(t):
    """CPU tensors take the plain versions -- unless the launchers are
    pointed at the CPU (``_KERNEL_DEVICE``, as the route tests do with a
    stand-in kernel library)."""
    return t.device.type == "cpu" and _KERNEL_DEVICE != "cpu"


def fused_mhsa(q, k, v, scale):
    """``softmax(q k^T scale) v`` over ``(G, N, d)``; see the module
    docstring for the dispatch."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Mhsa.apply(q, k, v, scale)
    if _plain(q):
        return mhsa_reference(q, k, v, scale)
    return _launch_fwd(q, k, v, scale)[0]


fused_mhsa.launches = 0


class _Mhsa(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        if _plain(q):
            o, stats = mhsa_reference(q, k, v, scale), None
        else:
            o, stats = _launch_fwd(q, k, v, scale, stats=True)
        ctx.save_for_backward(q, k, v, stats,
                              o if stats is not None else None)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, stats, o = ctx.saved_tensors
        return (*fused_mhsa_bwd(q, k, v, do.contiguous(), ctx.scale, stats,
                                o), None)


def fused_mhsa_bwd(q, k, v, do, scale, stats=None, o=None):
    """``(dq, dk, dv)``: :func:`mhsa_bwd_reference` on CPU tensors,
    ``rp_mhsa_bwd`` on CUDA tensors (or a raise).  ``stats``: the
    ``(G, N, 3)`` fp32 statistics that ``_launch_fwd(..., stats=True)``
    wrote, with ``o``, the output it returned with them; without them the
    backward runs ``rp_mhsa_fwd`` with statistics first.  The backward
    writes each row's c into the third slot of ``stats``."""
    if _plain(q):
        return mhsa_bwd_reference(q, k, v, do, scale)
    _check_inputs("fused_mhsa_bwd", q, k, v, do)
    G, N, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    if stats is not None and not (
            stats.shape == (G, N, 3) and stats.dtype == torch.float32
            and stats.device == q.device and stats.is_contiguous()):
        raise ValueError(f"fused_mhsa_bwd: stats must be the forward's "
                         f"contiguous ({G}, {N}, 3) float32 tensor on "
                         f"{q.device}, got {tuple(stats.shape)} "
                         f"{stats.dtype} on {stats.device}")
    if (stats is None) != (o is None):
        raise ValueError("fused_mhsa_bwd: the backward takes the forward's "
                         "stats and o together, or neither")
    if o is not None:
        _check_inputs("fused_mhsa_bwd (o)", q, o)
    lib = _build.library()
    stream = _build.prepare_launch(q.device)
    if stats is None:
        o, stats = _fwd(q, k, v, scale, True)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dnb = torch.empty_like(q)   # T(do / l)
    err = lib.rp_mhsa_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        dnb.data_ptr(), o.data_ptr(), G, N, d, scale, int(bf16), stream)
    _build.check(err, "rp_mhsa_bwd")
    fused_mhsa_bwd.launches += 1
    return dq, dk, dv


fused_mhsa_bwd.launches = 0


def _launch_fwd(q, k, v, scale, stats=False):
    """``rp_mhsa_fwd`` -> ``(o, stats)``: with ``stats`` also the
    ``(G, N, 3)`` fp32 row statistics for :func:`fused_mhsa_bwd`, else
    None.  Counts one launch of ``fused_mhsa``."""
    _check_inputs("fused_mhsa", q, k, v)
    out = _fwd(q, k, v, scale, stats)
    fused_mhsa.launches += 1
    return out


def _fwd(q, k, v, scale, stats):
    """``rp_mhsa_fwd`` on checked inputs, uncounted (a backward's own
    forward counts as its launch)."""
    G, N, d = q.shape
    o = torch.empty_like(q)
    st = (torch.empty((G, N, 3), dtype=torch.float32, device=q.device)
          if stats else None)
    stream = _build.prepare_launch(q.device)
    err = _build.library().rp_mhsa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        st.data_ptr() if stats else None, G, N, d, scale,
        int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "rp_mhsa_fwd")
    return o, st


def _check_inputs(what, q, *others):
    if q.device.type != _KERNEL_DEVICE:
        raise ValueError(f"{what}: no kernel for {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {q.dtype} (fp32 or bf16)")
    if q.dim() != 3 or q.shape[-1] != 64:
        raise ValueError(f"{what}: the kernel takes (G, N, 64) heads, got "
                         f"{tuple(q.shape)}")
    if q.shape[0] > MAX_HEADS:
        raise ValueError(f"{what}: G = {q.shape[0]} heads exceed the launch "
                         f"grid's {MAX_HEADS}")
    for t in (q, *others):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{what}: every input must be a contiguous "
                             f"{tuple(q.shape)} {q.dtype} tensor on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
