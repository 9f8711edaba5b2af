"""The fusion transformer's self-attention block stack, forward and backward.

Counterpart of ``rel_pose_tpu/ops/pallas_vit.py`` and ``pallas_vit_bwd.py``.
``fused_vit_stack`` runs all stacked blocks, with the positional-embedding
add fused into block 0:

  * on a CPU tensor it is the plain PyTorch version,
    :func:`vit_stack_reference`;
  * on a CUDA tensor it launches the hand kernels of ``csrc/vit_stack.cu``
    (which replace the Pallas ``_vit_stack_kernel``) or raises.

The dtype picks the kernels: bf16 runs on the tensor cores
(``csrc/gemm_tc.cuh``, ``csrc/attention_tc.cuh``), fp32 on the SIMT
kernels of ``csrc/common.cuh`` and ``csrc/attention.cuh`` (the tensor cores
have no fp32 product, and TF32 would change fp32 results).

Under autograd (grad enabled and an input that requires grad) the stack is
a ``torch.autograd.Function``, as the Pallas op is a ``custom_vjp``
(``pallas_vit.py:417-458``): the forward also writes the stash ``xs``, every
block's input with ``xs[0]`` after the positional add, and the backward is
:func:`fused_vit_stack_bwd` -- the plain :func:`vit_stack_bwd_reference` on
the CPU, the backward kernels (which replace ``_vit_stack_bwd_kernel``) on
CUDA.  It returns ``dx``, every stacked gradient summed in fp32 and returned
in the stacked tensor's dtype, and ``dpos``, the fp32 sum of ``dx`` over the
sequences.  Under ``no_grad`` no stash is written.

Stacked weights follow PyTorch's Linear layout ``(depth, out, in)`` and are
in the activation dtype: the model casts every stacked parameter to it, as
the Pallas path does (``pallas_vit.py:476-477``), while the master weights
stay fp32.
"""

import math

import torch
import torch.nn.functional as F

from ..nn.transformer import LOG2E, vit_block
from . import _build

# (stacked name, key inside one ``nn.transformer.Block``)
STACK_FIELDS = (
    ("ln1_scale", "norm1.weight"), ("ln1_bias", "norm1.bias"),
    ("qkv_w", "attn.qkv.weight"), ("qkv_b", "attn.qkv.bias"),
    ("proj_w", "attn.proj.weight"), ("proj_b", "attn.proj.bias"),
    ("ln2_scale", "norm2.weight"), ("ln2_bias", "norm2.bias"),
    ("fc1_w", "mlp.fc1.weight"), ("fc1_b", "mlp.fc1.bias"),
    ("fc2_w", "mlp.fc2.weight"), ("fc2_b", "mlp.fc2.bias"),
)
_NAMES = tuple(name for name, _ in STACK_FIELDS)
_WEIGHTS = ("qkv_w", "proj_w", "fc1_w", "fc2_w")


def stack_block_params(blocks, dtype=None):
    """``Block`` modules -> dict of ``(depth, ...)`` tensors named as
    :data:`STACK_FIELDS`, cast to ``dtype`` when given.  Built from the
    parameters themselves, so gradients flow back to each block."""
    out = {name: torch.stack([b.get_parameter(key) for b in blocks])
           for name, key in STACK_FIELDS}
    if dtype is not None:
        out = {k: v.to(dtype) for k, v in out.items()}
    return out


def vit_stack_reference(x, stacked, num_heads, pos=None, stash=None):
    """Plain version: ``x (G, N, C)`` (+ ``pos (1, N, C)``) through every
    stacked block, with the Pallas kernel's rounding (``nn.transformer``).
    A list passed as ``stash`` receives every block's input."""
    if pos is not None:
        x = x + pos.to(x.dtype)
    for i in range(stacked["qkv_w"].shape[0]):
        if stash is not None:
            stash.append(x)
        x = vit_block(x, {k: v[i] for k, v in stacked.items()}, num_heads)
    return x


def fused_vit_stack(x, stacked, num_heads, pos=None):
    """All stacked blocks over ``x (G, N, C)``; see the module docstring
    for the dispatch.  ``pos`` is an optional ``(1, N, C)`` embedding added
    before block 0."""
    if pos is None:
        pos = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
    values = tuple(stacked[n] for n in _NAMES)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, pos) + values):
        return _VitStack.apply(x, pos, num_heads, *values)
    if x.device.type == "cpu":
        return vit_stack_reference(x, stacked, num_heads, pos)
    return _launch_forward(x, stacked, num_heads, pos, stash=False)[0]


fused_vit_stack.launches = 0


class _VitStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pos, num_heads, *values):
        stacked = dict(zip(_NAMES, values))
        if x.device.type == "cpu":
            xs = []
            out = vit_stack_reference(x, stacked, num_heads, pos, stash=xs)
            xs = torch.stack(xs)
        else:
            out, xs = _launch_forward(x, stacked, num_heads, pos, stash=True)
        ctx.save_for_backward(xs, *values)
        ctx.num_heads = num_heads
        ctx.pos_meta = (pos.shape, pos.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        xs, *values = ctx.saved_tensors
        stacked = dict(zip(_NAMES, values))
        dx, grads = fused_vit_stack_bwd(xs, g.contiguous(), stacked,
                                        ctx.num_heads)
        shape, dtype = ctx.pos_meta
        dpos = dx.float().sum(0).reshape(shape).to(dtype)
        return (dx, dpos, None,
                *(grads[n].to(v.dtype) for n, v in zip(_NAMES, values)))


_KERNEL_DEVICE = "cuda"   # the device type the kernels launch on


def _launch_forward(x, stacked, num_heads, pos, stash):
    """``rp_vit_stack`` on CUDA tensors -> (out, xs or None)."""
    if x.device.type != _KERNEL_DEVICE:
        raise ValueError(f"fused_vit_stack: no kernel for {x.device}")
    G, N, C = x.shape
    depth, hidden = stacked["fc1_w"].shape[:2]
    pos = pos.reshape(N, C).to(x.dtype).contiguous()
    args = _c_params(stacked)
    _check_inputs(x, args, num_heads)
    if pos.device != x.device:
        raise ValueError("fused_vit_stack: pos on another device")
    M = G * N
    out = torch.empty_like(x)
    xs = (torch.empty((depth, G, N, C), dtype=x.dtype, device=x.device)
          if stash else None)
    scratch = [torch.empty((M, w), dtype=x.dtype, device=x.device)
               for w in (C, 3 * C, C, hidden)]       # y, qkv, attn, hid
    stream = _build.prepare_launch(x.device)
    err = _build.library().rp_vit_stack(
        x.data_ptr(), pos.data_ptr(), out.data_ptr(),
        xs.data_ptr() if stash else None,
        *(args[name].data_ptr() for name in _NAMES),
        *(t.data_ptr() for t in scratch),
        G, N, C, num_heads, hidden, depth, int(x.dtype == torch.bfloat16),
        stream)
    _build.check(err, "rp_vit_stack")
    fused_vit_stack.launches += 1
    return out, xs


def _c_params(stacked):
    """The C ABI takes weights in x.dtype and every vector as fp32."""
    return {k: (v if k in _WEIGHTS else v.float()).contiguous()
            for k, v in stacked.items()}


# ---------------------------------------------------------------- backward --

def _gelu_grad(h, cdt):
    """d gelu / dh of the fp32 pre-activation ``h`` under the GELU policy
    (``ops/kernel_gelu.py:55``): the tanh form for bf16, exact erf for
    fp32."""
    if cdt == torch.bfloat16:
        c = math.sqrt(2.0 / math.pi)
        t = torch.tanh(c * (h + 0.044715 * h * h * h))
        du = c * (1.0 + 3.0 * 0.044715 * h * h)
        return 0.5 * (1.0 + t) + h * (0.5 * (1.0 - t * t)) * du
    phi = torch.exp(-0.5 * h * h) * (1.0 / math.sqrt(2.0 * math.pi))
    return 0.5 * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0)))) + h * phi


def _ln_fwd(x, scale, bias):
    """(y in fp32, xhat, 1/sigma) of the port's two-pass LayerNorm."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    inv = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + 1e-6)
    xhat = (xf - mean) * inv
    return xhat * scale.float() + bias.float(), xhat, inv


def _ln_bwd(dy, xhat, inv, scale):
    """(dx, dscale, dbias) of y = xhat * scale + bias
    (``pallas_vit_bwd.py:62-71``); weight sums over every row."""
    dscale = (dy * xhat).sum((0, 1))
    dbias = dy.sum((0, 1))
    dxhat = dy * scale.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return inv * (dxhat - m1 - xhat * m2), dscale, dbias


def _dense(x, w, b):
    return torch.matmul(x.float(), w.float().t()) + b.float()


def _wgrad(dy_b, x):
    """sum over (G, N) of dy_b^T x: the (out, in) weight gradient."""
    return torch.einsum("gno,gni->oi", dy_b, x.float())


def vit_stack_bwd_reference(xs, g, stacked, num_heads):
    """Plain backward of the stack from the stash ``xs (depth, G, N, C)``
    and the output cotangent ``g (G, N, C)`` -> ``(dx, grads)``: dx in
    xs.dtype and a dict of fp32 stacked gradients.  It repeats
    ``_vit_stack_bwd_kernel`` (``pallas_vit_bwd.py:171-239``) block by
    block, with its rounding points: every product takes T-rounded
    operands and accumulates in fp32, the residual cotangent stays fp32,
    the MLP pre-activation h1 is recomputed unrounded.  Two differences
    from the Pallas bf16 path, as in the forward: the LayerNorm variance is
    two-pass and the softmax row sum is the fp32 sum of exp2."""
    cdt = xs.dtype
    depth, G, N, C = xs.shape
    d = C // num_heads
    scale = d ** -0.5 * LOG2E
    rnd = lambda t: t.to(cdt).float()
    grads = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
             for k, v in stacked.items()}
    dxo = g.float()
    for i in reversed(range(depth)):
        p = {k: v[i] for k, v in stacked.items()}
        x_in = xs[i]
        # recompute block i's forward pieces
        y1, xhat1, inv1 = _ln_fwd(x_in, p["ln1_scale"], p["ln1_bias"])
        y1 = y1.to(cdt)
        qkv = rnd(_dense(y1, p["qkv_w"], p["qkv_b"]))
        q, k, v = qkv.view(G, N, 3, num_heads, d).permute(2, 0, 3, 1, 4)
        s = torch.matmul(q, k.transpose(-1, -2)) * scale
        e = torch.exp2(s - s.amax(-1, keepdim=True))
        l = e.sum(-1, keepdim=True)
        o = torch.matmul(rnd(e), v) * (1.0 / l)
        attn = o.transpose(1, 2).reshape(G, N, C).to(cdt)
        xa = (x_in.float() + _dense(attn, p["proj_w"], p["proj_b"])).to(cdt)
        y2, xhat2, inv2 = _ln_fwd(xa, p["ln2_scale"], p["ln2_bias"])
        y2 = y2.to(cdt)
        h1 = _dense(y2, p["fc1_w"], p["fc1_b"])
        hg = F.gelu(h1, approximate="tanh" if cdt == torch.bfloat16
                    else "none").to(cdt)

        # MLP branch: x_out = xa + fc2(gelu(fc1(LN2(xa))))
        dout_b = rnd(dxo)
        grads["fc2_w"][i] = _wgrad(dout_b, hg)
        grads["fc2_b"][i] = dxo.sum((0, 1))
        dh1 = torch.matmul(dout_b, p["fc2_w"].float()) * _gelu_grad(h1, cdt)
        dh1_b = rnd(dh1)
        grads["fc1_w"][i] = _wgrad(dh1_b, y2)
        grads["fc1_b"][i] = dh1.sum((0, 1))
        dy2 = torch.matmul(dh1_b, p["fc1_w"].float())
        dxa_ln, grads["ln2_scale"][i], grads["ln2_bias"][i] = _ln_bwd(
            dy2, xhat2, inv2, p["ln2_scale"])
        dxa = dxo + dxa_ln

        # attention branch: xa = x_in + proj(attention(qkv(LN1(x_in))))
        dproj_b = rnd(dxa)
        grads["proj_w"][i] = _wgrad(dproj_b, attn)
        grads["proj_b"][i] = dxa.sum((0, 1))
        dattn = torch.matmul(dproj_b, p["proj_w"].float())
        do = dattn.view(G, N, num_heads, d).transpose(1, 2)
        dv = torch.matmul(rnd(e).transpose(-1, -2), rnd(do / l))
        dp = torch.matmul(rnd(do), v.transpose(-1, -2))
        c = (dp * e).sum(-1, keepdim=True) / l
        dsb = rnd(e * ((dp - c) / l) * math.log(2.0) * scale)
        dq = torch.matmul(dsb, k)
        dk = torch.matmul(dsb.transpose(-1, -2), q)
        dqkv = torch.stack([dq, dk, dv], 2).permute(0, 3, 2, 1, 4) \
            .reshape(G, N, 3 * C)
        dqkv_b = rnd(dqkv)
        grads["qkv_w"][i] = _wgrad(dqkv_b, y1)
        grads["qkv_b"][i] = dqkv.sum((0, 1))
        dy1 = torch.matmul(dqkv_b, p["qkv_w"].float())
        dx_ln, grads["ln1_scale"][i], grads["ln1_bias"][i] = _ln_bwd(
            dy1, xhat1, inv1, p["ln1_scale"])
        dxo = dxa + dx_ln
    return dxo.to(cdt), grads


def fused_vit_stack_bwd(xs, g, stacked, num_heads):
    """Backward of the stack: :func:`vit_stack_bwd_reference` on CPU
    tensors, the kernels of ``csrc/vit_stack.cu`` on CUDA tensors (or a
    raise).  Returns ``(dx, grads)`` with fp32 ``grads``."""
    if xs.device.type == "cpu":
        return vit_stack_bwd_reference(xs, g, stacked, num_heads)
    return _launch_backward(xs, g, stacked, num_heads)


def _launch_backward(xs, g, stacked, num_heads):
    """``rp_vit_stack_bwd`` on CUDA tensors -> (dx, grads)."""
    if xs.device.type != _KERNEL_DEVICE:
        raise ValueError(f"fused_vit_stack_bwd: no kernel for {xs.device}")
    depth, G, N, C = xs.shape
    hidden = stacked["fc1_w"].shape[1]
    args = _c_params(stacked)
    _check_inputs(xs[0], args, num_heads)
    if g.shape != xs.shape[1:] or g.dtype != xs.dtype \
            or not g.is_contiguous() or not xs.is_contiguous():
        raise ValueError(f"fused_vit_stack_bwd: g {tuple(g.shape)} "
                         f"{g.dtype} against xs {tuple(xs.shape)} "
                         f"{xs.dtype}, both contiguous")
    lib = _build.library()
    dx = torch.empty_like(g)
    grads = {k: torch.empty(v.shape, dtype=torch.float32, device=xs.device)
             for k, v in stacked.items()}
    bf16 = int(xs.dtype == torch.bfloat16)
    ws = torch.empty(lib.rp_vit_stack_bwd_workspace(G, N, C, num_heads,
                                                    hidden, bf16),
                     dtype=torch.uint8, device=xs.device)
    stream = _build.prepare_launch(xs.device)
    err = lib.rp_vit_stack_bwd(
        xs.data_ptr(), g.data_ptr(),
        *(args[name].data_ptr() for name in _NAMES), dx.data_ptr(),
        *(grads[name].data_ptr() for name in _NAMES), ws.data_ptr(),
        G, N, C, num_heads, hidden, depth, bf16, stream)
    _build.check(err, "rp_vit_stack_bwd")
    fused_vit_stack_bwd.launches += 1
    return dx, grads


fused_vit_stack_bwd.launches = 0


# The tensor-core kernels' tiles: GEMM outputs in 64-column tiles, GEMM
# rows in 128-row tiles on the grid's second axis (at most 65,535), one
# attention block per (tile, head, sequence) with sequences on the third.
_TC_ROW_TILE, _TC_MAX_GRID = 128, 65535


def _check_inputs(x, args, num_heads):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_vit_stack: dtype {x.dtype} (fp32 or bf16)")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("fused_vit_stack: x must be a contiguous (G, N, C) "
                         f"tensor, got shape {tuple(x.shape)}")
    G, N, C = x.shape
    if C != 64 * num_heads:
        raise ValueError(f"fused_vit_stack: the kernel needs head_dim 64, "
                         f"got C={C} with {num_heads} heads")
    depth, hidden = args["fc1_w"].shape[:2]
    want = {"ln1_scale": (depth, C), "ln1_bias": (depth, C),
            "qkv_w": (depth, 3 * C, C), "qkv_b": (depth, 3 * C),
            "proj_w": (depth, C, C), "proj_b": (depth, C),
            "ln2_scale": (depth, C), "ln2_bias": (depth, C),
            "fc1_w": (depth, hidden, C), "fc1_b": (depth, hidden),
            "fc2_w": (depth, C, hidden), "fc2_b": (depth, C)}
    for name, shape in want.items():
        t = args[name]
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"fused_vit_stack: {name} is "
                             f"{tuple(t.shape)} on {t.device}, expected "
                             f"{shape} on {x.device}")
        if name in _WEIGHTS and t.dtype != x.dtype:
            raise TypeError(f"fused_vit_stack: {name} is {t.dtype}, x is "
                            f"{x.dtype} (stack_block_params(blocks, "
                            "x.dtype))")
    if x.dtype == torch.bfloat16:   # the tensor-core kernels
        if hidden % 64:
            raise ValueError(f"fused_vit_stack: bf16 needs the MLP width to "
                             f"be a multiple of 64, got {hidden}")
        if -(-G * N // _TC_ROW_TILE) > _TC_MAX_GRID or G > _TC_MAX_GRID:
            raise ValueError(f"fused_vit_stack: {G} sequences of {N} tokens "
                             "exceed the bf16 kernels' grid")
