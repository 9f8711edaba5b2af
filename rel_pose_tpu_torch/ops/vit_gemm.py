"""One GEMM of the ViT stack's ``wgmma`` bodies alone.

Kernels #1 and #5 (``ops/vit_stack.py``) run their GEMMs inside
``rp_vit_stack`` / ``rp_vit_stack_bwd``: bf16 on ``csrc/gemm_wgmma.cuh``,
fp32 as 3xTF32 on ``csrc/gemm_wgmma_f32.cuh``.  :func:`vit_gemm` runs one of
them on its own through the test-only C entries ``rp_gemm_bf16`` and
``rp_gemm_f32``, so that ``chip_smoke.py`` can hold each GEMM shape and
epilogue to its plain version and time it beside one library call.  The
model path never calls it.  The operands' dtype picks the body; T below is
that dtype.

  * ``op="fwd"``: ``out = epilogue(a @ b.T)``, ``a (M, K)``, ``b (N, K)``
    (a Linear weight), ``bias (N)`` fp32; epilogues ``bias``,
    ``bias_gelu``, ``bias_resid`` (with ``resid (M, N)`` in T) and
    ``bias_gelu_split`` (also the fp32 ``acc + bias``); T out;
  * ``op="dx"``: ``out = epilogue(a @ b)`` in fp32, ``a (M, K)`` the
    cotangent (bf16: its bf16 copy), ``b (K, N)`` the weight; epilogues
    ``plain`` and ``gelu_grad`` (times the GELU derivative of ``aux (M,
    N)``, fp32); with ``outb`` (bf16 only) also ``T(out)``;
  * ``op="dw"``: ``dW = a.T @ b`` and ``db = dy.sum(0)`` in fp32, ``a (M, N)``
    the cotangent (bf16: its bf16 copy), ``b = X (M, K)``, ``dy (M, N)`` the
    fp32 cotangent (fp32: ``a`` itself).

fp32's plain version multiplies in full fp32 (the port's default precision,
TF32 off) and takes the exact-erf GELU.  On CPU tensors it is
:func:`vit_gemm_reference`; on CUDA tensors it launches the kernel or
raises.
"""

import torch
import torch.nn.functional as F

from . import _build
from .vit_stack import _gelu_grad

# common.cuh's Epilogue and DxEpilogue values
FWD_EPILOGUES = {"bias": 0, "bias_gelu": 1, "bias_resid": 2,
                 "bias_gelu_split": 4}
DX_EPILOGUES = {"plain": 0, "gelu_grad": 1}
OPS = {"fwd": 0, "dx": 1, "dw": 2}
DW_CHUNK = 1024          # common.cuh kDwChunk: rows per dW partial
_KERNEL_DEVICE = "cuda"  # the device type the kernel launches on


def vit_gemm_reference(op, epilogue, a, b, bias=None, resid=None, aux=None,
                       dy=None, outb=False):
    """Plain version of :func:`vit_gemm`: fp32 products of the operands and
    the kernel's rounding points (bf16: the tanh GELU; fp32: exact erf, and
    nothing rounds between the product and the output)."""
    t = a.dtype
    gelu = "tanh" if t == torch.bfloat16 else "none"
    if op == "fwd":
        h = torch.matmul(a.float(), b.float().t()) + bias.float()
        if epilogue == "bias":
            return (h.to(t),)
        if epilogue == "bias_gelu":
            return (F.gelu(h.to(t).float(), approximate=gelu).to(t),)
        if epilogue == "bias_resid":
            return ((resid.float() + h).to(t),)
        return F.gelu(h, approximate=gelu).to(t), h
    if op == "dx":
        out = torch.matmul(a.float(), b.float())
        if epilogue == "gelu_grad":
            out = out * _gelu_grad(aux, t)
        return (out, out.to(t)) if outb else (out,)
    return torch.matmul(a.float().t(), b.float()), dy.float().sum(0)


def vit_gemm(op, epilogue, a, b, bias=None, resid=None, aux=None, dy=None,
             outb=False):
    """One GEMM of the body of ``a``'s dtype; see the module docstring.
    Returns a tuple: ``(out,)``, ``(out, aux)`` for ``bias_gelu_split``,
    ``(out, T(out))`` for ``dx`` with ``outb``, ``(dW, db)`` for ``dw``."""
    if a.device.type == "cpu":
        _check(op, epilogue, a, b, bias, resid, aux, dy, outb)
        return vit_gemm_reference(op, epilogue, a, b, bias, resid, aux, dy,
                                  outb)
    return _launch(op, epilogue, a, b, bias, resid, aux, dy, outb)


vit_gemm.launches = 0


def _launch(op, epilogue, a, b, bias=None, resid=None, aux=None, dy=None,
            outb=False):
    """``rp_gemm_bf16`` or ``rp_gemm_f32`` on CUDA tensors."""
    if a.device.type != _KERNEL_DEVICE:
        raise ValueError(f"vit_gemm: no kernel for {a.device}")
    _check(op, epilogue, a, b, bias, resid, aux, dy, outb)
    M = a.shape[0]
    dev = a.device
    f32 = dict(dtype=torch.float32, device=dev)
    bf16 = a.dtype == torch.bfloat16
    part = bpart = ob = xaux = None
    if op == "fwd":
        N, K = b.shape
        out = torch.empty((M, N), dtype=a.dtype, device=dev)
        if epilogue == "bias_gelu_split":
            xaux = torch.empty((M, N), **f32)
        f, res = bias, (out, xaux)
    elif op == "dx":
        K, N = b.shape
        out = torch.empty((M, N), **f32)
        if outb:
            ob = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
        f, res = None, (out, ob)
        xaux = aux
    else:
        N, K = a.shape[1], b.shape[1]
        S = -(-M // DW_CHUNK)
        out = torch.empty((N, K), **f32)
        xaux = torch.empty((N,), **f32)      # db
        part = torch.empty((S, N, K), **f32)
        bpart = torch.empty((S, N), **f32)
        f, res = dy, (out, xaux)
    # bf16: T(out) or none; fp32: the weight's TF32 hi / lo split
    extra = ob if bf16 or op == "dw" else torch.empty((2 * N, K), **f32)
    epi = (FWD_EPILOGUES if op == "fwd" else DX_EPILOGUES).get(epilogue, 0)
    name = "rp_gemm_bf16" if bf16 else "rp_gemm_f32"
    stream = _build.prepare_launch(dev)
    ptr = lambda t: None if t is None else t.data_ptr()   # noqa: E731
    err = getattr(_build.library(), name)(
        OPS[op], epi, ptr(a), ptr(b), ptr(f), ptr(resid), ptr(out),
        ptr(xaux), ptr(extra), ptr(part), ptr(bpart), M, N, K, stream)
    _build.check(err, name)
    vit_gemm.launches += 1
    return tuple(t for t in res if t is not None)


def _check(op, epilogue, a, b, bias, resid, aux, dy, outb=False):
    """Raise before any launch on what the kernel does not take."""
    if op not in OPS:
        raise ValueError(f"vit_gemm: op {op!r} (fwd, dx or dw)")
    names = FWD_EPILOGUES if op == "fwd" else DX_EPILOGUES
    if op != "dw" and epilogue not in names:
        raise ValueError(f"vit_gemm: {op} epilogue {epilogue!r}, one of "
                         f"{sorted(names)}")
    if a.dtype not in (torch.bfloat16, torch.float32) or b.dtype != a.dtype:
        raise TypeError(f"vit_gemm: bf16 or fp32 operands of one dtype, got "
                        f"{a.dtype}, {b.dtype}")
    if outb and a.dtype != torch.bfloat16:
        raise ValueError("vit_gemm: outb (T(out)) is bf16's")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] < 1:
        raise ValueError(f"vit_gemm: 2-D operands, got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    M = a.shape[0]
    if op == "fwd":
        (N, K), want = b.shape, {"bias": (b.shape[0],)}
        if a.shape[1] != K:
            raise ValueError(f"vit_gemm: A {tuple(a.shape)} against W "
                             f"{tuple(b.shape)}")
        if epilogue == "bias_resid":
            want["resid"] = (M, N)
    elif op == "dx":
        (K, N), want = b.shape, {}
        if a.shape[1] != K:
            raise ValueError(f"vit_gemm: dY {tuple(a.shape)} against W "
                             f"{tuple(b.shape)}")
        if epilogue == "gelu_grad":
            want["aux"] = (M, N)
    else:
        (N, K), want = (a.shape[1], b.shape[1]), {"dy": (M, a.shape[1])}
        if b.shape[0] != M:
            raise ValueError(f"vit_gemm: dY {tuple(a.shape)} against X "
                             f"{tuple(b.shape)}")
    if N % 64 or K % 64:
        raise ValueError(f"vit_gemm: widths must be multiples of 64, got "
                         f"N={N}, K={K}")
    given = {"bias": bias, "resid": resid, "aux": aux, "dy": dy}
    tensors = [a, b]
    for name, shape in want.items():
        t = given[name]
        dtype = a.dtype if name == "resid" else torch.float32
        if t is None or tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"vit_gemm: {name} must be {dtype} {shape}, got "
                             f"{None if t is None else tuple(t.shape)}")
        tensors.append(t)
    for t in tensors:
        if t.device != a.device or not t.is_contiguous():
            raise ValueError("vit_gemm: contiguous tensors on one device")
        if t.data_ptr() % 16:
            raise ValueError("vit_gemm: TMA and the 16-byte epilogue "
                             "accesses need 16-byte aligned tensors")
