"""PyTorch port vs the JAX package: the self-attention block stack.

The JAX Pallas kernel ``_vit_stack_call`` runs in interpret mode, as its own
tests run it on the CPU (tests/test_pallas_vit.py); the port's side is its
plain version ``vit_stack_reference``, which the CUDA kernels are held
against on the GPU.  Inputs come from a numpy seed.

Tolerances: fp32 1e-5 -- the same fp32 arithmetic in another summation
order, with the Pallas fp32 GELU a polynomial erf good to 1.5e-7.  bf16
2e-2 * max|ref| -- the Pallas bf16 path also takes TPU-only shortcuts
(single-pass LN variance, the softmax row sum carried through a bf16
product) that move roundings by an ulp (2^-8 relative), and two stacked
blocks carry such flips on.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rel_pose_tpu.ops.pallas_vit import _vit_stack_call
from rel_pose_tpu.ops.pallas_vit import stack_block_params as jstack
from rel_pose_tpu.ops.pallas_vit import vit_stack_reference as jreference
from rel_pose_tpu_torch.nn.init import seeded_state_dict
from rel_pose_tpu_torch.nn.transformer import Block
from rel_pose_tpu_torch.ops import vit_stack as tv

RNG = np.random.default_rng(11)


def _stacked_np(depth, C, hidden):
    """Torch-layout (depth, out, in) params drawn from numpy."""
    def n(*shape, scale=1.0):
        return (RNG.standard_normal(shape) * scale).astype(np.float32)
    return {"ln1_scale": 1 + n(depth, C, scale=0.1),
            "ln1_bias": n(depth, C, scale=0.1),
            "qkv_w": n(depth, 3 * C, C, scale=C ** -0.5),
            "qkv_b": n(depth, 3 * C, scale=0.1),
            "proj_w": n(depth, C, C, scale=C ** -0.5),
            "proj_b": n(depth, C, scale=0.1),
            "ln2_scale": 1 + n(depth, C, scale=0.1),
            "ln2_bias": n(depth, C, scale=0.1),
            "fc1_w": n(depth, hidden, C, scale=C ** -0.5),
            "fc1_b": n(depth, hidden, scale=0.1),
            "fc2_w": n(depth, C, hidden, scale=hidden ** -0.5),
            "fc2_b": n(depth, C, scale=0.1)}


def _to_jax(stacked, dtype):
    """(depth, out, in) -> the JAX package's (depth, in, out)."""
    return {k: jnp.asarray(np.swapaxes(v, 1, 2) if v.ndim == 3 else v)
            .astype(dtype) for k, v in stacked.items()}


def _to_torch(stacked, dtype):
    return {k: torch.from_numpy(v).to(dtype) for k, v in stacked.items()}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_reference_matches_pallas_kernel(dtype, tol):
    """Narrow width: G=2, N=64, C=48, 3 heads (d=16), depth 2, with the
    positional embedding fused into block 0."""
    G, N, C, heads, depth = 2, 64, 48, 3, 2
    st = _stacked_np(depth, C, 4 * C)
    x = RNG.standard_normal((G, N, C)).astype(np.float32)
    pos = (0.5 * RNG.standard_normal((1, N, C))).astype(np.float32)
    want = np.asarray(_vit_stack_call(
        jnp.asarray(x).astype(dtype), _to_jax(st, dtype), depth, heads,
        interpret=True, pos=jnp.asarray(pos).astype(dtype)), np.float32)
    tdt = getattr(torch, dtype)
    got = tv.vit_stack_reference(torch.from_numpy(x).to(tdt),
                                 _to_torch(st, tdt), heads,
                                 torch.from_numpy(pos).to(tdt))
    assert got.dtype == tdt and got.shape == (G, N, C)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_full_width_block_matches_jax_reference():
    """One block at the model's widths (576 tokens x 192, 3 heads of 64)
    against the JAX package's unfused reference, fp32."""
    G, N, C, heads = 1, 576, 192, 3
    st = _stacked_np(1, C, 4 * C)
    x = RNG.standard_normal((G, N, C)).astype(np.float32)
    want = np.asarray(jreference(jnp.asarray(x), _to_jax(st, jnp.float32),
                                 1, heads))
    got = tv.vit_stack_reference(torch.from_numpy(x),
                                 _to_torch(st, torch.float32), heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_stack_block_params_layout():
    """Stacking Block modules gives torch-layout tensors that equal the
    JAX stacking of the same blocks, transposed."""
    C, depth = 48, 3
    blocks = [Block(C) for _ in range(depth)]
    for i, b in enumerate(blocks):
        b.load_state_dict(seeded_state_dict(b, i))
    stacked = tv.stack_block_params(blocks, torch.bfloat16)
    assert stacked["qkv_w"].shape == (depth, 3 * C, C)
    assert all(v.dtype == torch.bfloat16 for v in stacked.values())
    jblocks = [{"norm1": {"scale": jnp.asarray(b.norm1.weight.detach()),
                          "bias": jnp.asarray(b.norm1.bias.detach())},
                "qkv": {"w": jnp.asarray(b.attn.qkv.weight.detach().T),
                        "b": jnp.asarray(b.attn.qkv.bias.detach())},
                "proj": {"w": jnp.asarray(b.attn.proj.weight.detach().T),
                         "b": jnp.asarray(b.attn.proj.bias.detach())},
                "norm2": {"scale": jnp.asarray(b.norm2.weight.detach()),
                          "bias": jnp.asarray(b.norm2.bias.detach())},
                "mlp": {"fc1": {"w": jnp.asarray(b.mlp.fc1.weight.detach().T),
                                "b": jnp.asarray(b.mlp.fc1.bias.detach())},
                        "fc2": {"w": jnp.asarray(b.mlp.fc2.weight.detach().T),
                                "b": jnp.asarray(b.mlp.fc2.bias.detach())}}}
               for b in blocks]
    want = jstack(jblocks)
    fp32 = tv.stack_block_params(blocks)
    for name, _ in tv.STACK_FIELDS:
        w = np.asarray(want[name])
        if w.ndim == 3:
            w = np.swapaxes(w, 1, 2)
        np.testing.assert_array_equal(fp32[name].detach().numpy(), w)


def test_cpu_tensor_dispatches_to_plain_version():
    G, N, C, heads = 2, 16, 48, 3
    st = _to_torch(_stacked_np(2, C, 4 * C), torch.float32)
    x = torch.from_numpy(RNG.standard_normal((G, N, C)).astype(np.float32))
    pos = torch.zeros(1, N, C)
    before = tv.fused_vit_stack.launches
    got = tv.fused_vit_stack(x, st, heads, pos)
    torch.testing.assert_close(got, tv.vit_stack_reference(x, st, heads,
                                                           pos),
                               rtol=0, atol=0)
    assert tv.fused_vit_stack.launches == before   # no kernel launched


def test_other_device_raises():
    st = _to_torch(_stacked_np(1, 192, 768), torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        tv.fused_vit_stack(torch.empty(1, 8, 192, device="meta"), st, 3)


def test_launch_checks():
    """The CUDA route's argument checks, exercised on CPU tensors.  Inputs
    that require grad are accepted (the stack is an autograd Function); the
    shape, dtype and head_dim checks still raise."""
    C = 192
    st = {k: v.contiguous() for k, v in
          _to_torch(_stacked_np(1, C, 4 * C), torch.float32).items()}
    x = torch.zeros(2, 8, C)
    tv._check_inputs(x, st, 3)                             # accepted
    tv._check_inputs(x.clone().requires_grad_(), st, 3)    # autograd route
    with pytest.raises(TypeError):
        tv._check_inputs(x.half(), st, 3)
    with pytest.raises(ValueError, match="head_dim 64"):
        tv._check_inputs(x, st, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tv._check_inputs(x.transpose(0, 1), st, 3)
    bad = dict(st, proj_w=st["proj_w"][:, :, :8])
    with pytest.raises(ValueError, match="proj_w"):
        tv._check_inputs(x, bad, 3)
    with pytest.raises(TypeError, match="fc1_w"):
        tv._check_inputs(x, dict(st, fc1_w=st["fc1_w"].double()), 3)
    xg = torch.zeros(1, 8, C, requires_grad=True)
    with pytest.raises(ValueError, match="no kernel"):
        tv.fused_vit_stack_bwd(xg.detach().to("meta")[None], xg.to("meta"),
                               st, 3)
