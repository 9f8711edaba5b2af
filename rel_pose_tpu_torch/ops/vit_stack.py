"""The fusion transformer's self-attention block stack.

Counterpart of ``rel_pose_tpu/ops/pallas_vit.py``.  ``fused_vit_stack``
runs all stacked blocks, with the positional-embedding add fused into
block 0:

  * on a CPU tensor it is the plain PyTorch version,
    :func:`vit_stack_reference`;
  * on a CUDA tensor it launches the hand kernels of ``csrc/vit_stack.cu``
    (which replace the Pallas ``_vit_stack_kernel``) or raises.

Stacked weights follow PyTorch's Linear layout ``(depth, out, in)`` and are
in the activation dtype: the model casts every stacked parameter to it, as
the Pallas path does (``pallas_vit.py:476-477``), while the master weights
stay fp32.  Eval only: the kernels refuse inputs that require grad.
"""

import torch

from ..nn.transformer import vit_block
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
_WEIGHTS = ("qkv_w", "proj_w", "fc1_w", "fc2_w")


def stack_block_params(blocks, dtype=None):
    """``Block`` modules -> dict of ``(depth, ...)`` tensors named as
    :data:`STACK_FIELDS`, cast to ``dtype`` when given."""
    sds = [b.state_dict() for b in blocks]
    out = {name: torch.stack([sd[key] for sd in sds])
           for name, key in STACK_FIELDS}
    if dtype is not None:
        out = {k: v.to(dtype) for k, v in out.items()}
    return out


def vit_stack_reference(x, stacked, num_heads, pos=None):
    """Plain version: ``x (G, N, C)`` (+ ``pos (1, N, C)``) through every
    stacked block, with the Pallas kernel's rounding (``nn.transformer``)."""
    if pos is not None:
        x = x + pos.to(x.dtype)
    for i in range(stacked["qkv_w"].shape[0]):
        x = vit_block(x, {k: v[i] for k, v in stacked.items()}, num_heads)
    return x


def fused_vit_stack(x, stacked, num_heads, pos=None):
    """All stacked blocks over ``x (G, N, C)``; see the module docstring
    for the dispatch.  ``pos`` is an optional ``(1, N, C)`` embedding added
    before block 0."""
    if x.device.type == "cpu":
        return vit_stack_reference(x, stacked, num_heads, pos)
    if x.device.type != "cuda":
        raise ValueError(f"fused_vit_stack: no kernel for {x.device}")
    G, N, C = x.shape
    depth, hidden = stacked["fc1_w"].shape[:2]
    if pos is None:
        pos = torch.zeros((N, C), dtype=x.dtype, device=x.device)
    pos = pos.reshape(N, C).to(x.dtype).contiguous()
    # the C ABI takes weights in x.dtype and every vector as fp32
    args = {k: (v if k in _WEIGHTS else v.float()).contiguous()
            for k, v in stacked.items()}
    _check_inputs(x, pos, args, num_heads)
    M = G * N
    out = torch.empty_like(x)
    scratch = [torch.empty((M, w), dtype=x.dtype, device=x.device)
               for w in (C, 3 * C, C, hidden)]       # y, qkv, attn, hid
    stream = _build.prepare_launch(x.device)
    err = _build.library().rp_vit_stack(
        x.data_ptr(), pos.data_ptr(), out.data_ptr(),
        *(args[name].data_ptr() for name, _ in STACK_FIELDS),
        *(t.data_ptr() for t in scratch),
        G, N, C, num_heads, hidden, depth, int(x.dtype == torch.bfloat16),
        stream)
    _build.check(err, "rp_vit_stack")
    fused_vit_stack.launches += 1
    return out


fused_vit_stack.launches = 0


def _check_inputs(x, pos, args, num_heads):
    if torch.is_grad_enabled() and (x.requires_grad or pos.requires_grad or
                                    any(v.requires_grad
                                        for v in args.values())):
        raise RuntimeError("fused_vit_stack is eval-only: its CUDA kernels "
                           "have no backward (run under torch.no_grad())")
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
    if pos.device != x.device:
        raise ValueError("fused_vit_stack: pos on another device")
