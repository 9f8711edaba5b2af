"""PyTorch port: what the ViT stack's wrappers do in Python around kernels
#1 and #5 (``ops/vit_stack.py``), on the CPU.

  * the dtype picks the products: the wrappers pass bf16 = 1 (bf16
    tensor-core products) or 0 (fp32, 3xTF32 tensor-core products) to the
    C entry points;
  * the kernels' shape checks (MLP width, grid size: both dtypes'
    sequences) raise before any launch; a CPU tensor reaches no kernel;
  * with a stand-in for the kernel library, each wrapper passes as many
    arguments as the C signature has and adds one to its launch counter
    per launch, and only then;
  * CPU tensors take the plain versions and leave the counters alone.

The kernels themselves run only on the card (``chip_smoke.py`` phases 3
and 3b hold them to the plain versions).
"""

import numpy as np
import pytest
import torch

from rel_pose_tpu_torch.ops import _build
from rel_pose_tpu_torch.ops import vit_stack as tv

C, HEADS, DEPTH, N = 64, 1, 2, 8


def stacked(dtype, hidden=4 * C):
    rng = np.random.default_rng(3)

    def t(*shape, scale=0.2):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    p = {"ln1_scale": 1 + t(DEPTH, C), "ln1_bias": t(DEPTH, C),
         "qkv_w": t(DEPTH, 3 * C, C), "qkv_b": t(DEPTH, 3 * C),
         "proj_w": t(DEPTH, C, C), "proj_b": t(DEPTH, C),
         "ln2_scale": 1 + t(DEPTH, C), "ln2_bias": t(DEPTH, C),
         "fc1_w": t(DEPTH, hidden, C), "fc1_b": t(DEPTH, hidden),
         "fc2_w": t(DEPTH, C, hidden), "fc2_b": t(DEPTH, C)}
    return {k: v.to(dtype) for k, v in p.items()}


def tokens(dtype, G=2):
    rng = np.random.default_rng(4)
    return torch.from_numpy(
        rng.standard_normal((G, N, C)).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bf16_shape_checks(fake_lib, dtype):
    """Both dtypes' tensor-core kernels need an MLP width in whole
    64-column tiles (fp32 too, since its products moved from the SIMT
    kernels to 3xTF32 on the tensor cores); such a width launches."""
    x = tokens(dtype)
    p = stacked(dtype, hidden=96)
    pos = torch.zeros((1, N, C), dtype=dtype)
    with pytest.raises(ValueError, match="multiple of 64"):
        tv._launch_forward(x, p, HEADS, pos, stash=False)
    with pytest.raises(ValueError, match="multiple of 64"):
        tv._launch_backward(torch.stack([x] * DEPTH), x, p, HEADS)
    assert fake_lib.calls == []
    p = stacked(dtype, hidden=128)
    tv._launch_forward(x, p, HEADS, pos, stash=False)
    tv._launch_backward(torch.stack([x] * DEPTH), x, p, HEADS)
    assert [name for name, _ in fake_lib.calls] == [
        "rp_vit_stack", "rp_vit_stack_bwd_workspace", "rp_vit_stack_bwd"]


@pytest.mark.parametrize("G,ok_bf16,ok_fp32", [(70000, False, False),
                                               (20000, True, True),
                                               (14000, True, True)])
def test_bf16_grid_check(G, ok_bf16, ok_fp32):
    """The sequences must fit the attention grid's 65,535 blocks in both
    dtypes; both dtypes' persistent wgmma GEMMs take any row count (G =
    20,000: 90,000 row tiles of 128)."""
    args = {k: v.to("meta") for k, v in stacked(torch.bfloat16).items()}
    x = torch.empty((G, 576, C), dtype=torch.bfloat16, device="meta")
    for dtype, ok in ((torch.bfloat16, ok_bf16), (torch.float32, ok_fp32)):
        a = {k: v.to(dtype) for k, v in args.items()}
        if ok:
            tv._check_inputs(x.to(dtype), a, HEADS)
        else:
            with pytest.raises(ValueError, match="grid"):
                tv._check_inputs(x.to(dtype), a, HEADS)


def test_cpu_tensor_reaches_no_kernel():
    """Past the CPU dispatch (``fused_vit_stack`` takes the plain version
    for CPU tensors), the launchers raise for any device but CUDA."""
    x = tokens(torch.bfloat16)
    pos = torch.zeros((1, N, C), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel for cpu"):
        tv._launch_forward(x, stacked(torch.bfloat16), HEADS, pos,
                           stash=False)
    xs = torch.stack([x] * DEPTH)
    with pytest.raises(ValueError, match="no kernel for cpu"):
        tv._launch_backward(xs, x, stacked(torch.bfloat16), HEADS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_checks_raise(fake_lib, dtype):
    xs = torch.stack([tokens(dtype)] * DEPTH)
    g = tokens(dtype)
    with pytest.raises(ValueError, match="g .* against xs"):
        tv._launch_backward(xs, g[:1], stacked(dtype), HEADS)
    with pytest.raises(TypeError, match="fc1_w"):
        tv._launch_backward(xs, g, dict(stacked(dtype), fc1_w=stacked(
            torch.float16)["fc1_w"]), HEADS)
    assert fake_lib.calls == []


class FakeLibrary:
    """Records each entry point's arguments and returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 256 if name.endswith("_workspace") else 0
        return entry


@pytest.fixture
def fake_lib(monkeypatch):
    lib = FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "prepare_launch", lambda device: 0)
    monkeypatch.setattr(tv, "_KERNEL_DEVICE", "cpu")
    return lib


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_launch_and_count(fake_lib, dtype):
    x = tokens(dtype)
    pos = torch.zeros((1, N, C), dtype=dtype)
    before = tv.fused_vit_stack.launches
    out, xs = tv._launch_forward(x, stacked(dtype), HEADS, pos, stash=True)
    assert tv.fused_vit_stack.launches == before + 1
    (name, args), = fake_lib.calls
    assert name == "rp_vit_stack"
    assert len(args) == len(_build.SIGNATURES[name][0])
    # ..., G, N, C, heads, hidden, depth, bf16, stream
    assert args[-8:-1] == (2, N, C, HEADS, 4 * C, DEPTH,
                           int(dtype == torch.bfloat16))
    assert args[3] == xs.data_ptr() and xs.shape == (DEPTH, 2, N, C)
    assert out.shape == x.shape and out.dtype == dtype
    tv._launch_forward(x, stacked(dtype), HEADS, pos, stash=False)
    assert fake_lib.calls[1][1][3] is None   # no stash without autograd
    assert tv.fused_vit_stack.launches == before + 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_launch_and_count(fake_lib, dtype):
    xs = torch.stack([tokens(dtype)] * DEPTH)
    g = tokens(dtype)
    before = tv.fused_vit_stack_bwd.launches
    dx, grads = tv._launch_backward(xs, g, stacked(dtype), HEADS)
    assert tv.fused_vit_stack_bwd.launches == before + 1
    (wname, wargs), (name, args) = fake_lib.calls
    assert wname == "rp_vit_stack_bwd_workspace"
    assert wargs == (2, N, C, HEADS, 4 * C, int(dtype == torch.bfloat16))
    assert name == "rp_vit_stack_bwd"
    assert len(args) == len(_build.SIGNATURES[name][0])
    assert args[-8:-1] == (2, N, C, HEADS, 4 * C, DEPTH,
                           int(dtype == torch.bfloat16))
    assert dx.shape == g.shape and dx.dtype == dtype
    assert all(v.dtype == torch.float32 for v in grads.values())


def test_failed_checks_do_not_count(fake_lib):
    x = tokens(torch.bfloat16)
    pos = torch.zeros((1, N, C), dtype=torch.bfloat16)
    before = tv.fused_vit_stack.launches
    with pytest.raises(ValueError):
        tv._launch_forward(x, stacked(torch.bfloat16, hidden=96), HEADS, pos,
                           stash=False)
    assert tv.fused_vit_stack.launches == before
    assert fake_lib.calls == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_versions(dtype):
    """No library is loaded for CPU tensors and no counter moves: the
    forward and the backward are the plain versions."""
    x = tokens(dtype)
    p = stacked(dtype)
    pos = torch.zeros((1, N, C), dtype=dtype)
    f0, b0 = tv.fused_vit_stack.launches, tv.fused_vit_stack_bwd.launches
    out = tv.fused_vit_stack(x, p, HEADS, pos)
    torch.testing.assert_close(out, tv.vit_stack_reference(x, p, HEADS, pos),
                               rtol=0, atol=0)
    xs = torch.stack([x] * DEPTH)
    dx, grads = tv.fused_vit_stack_bwd(xs, x, p, HEADS)
    rdx, rgrads = tv.vit_stack_bwd_reference(xs, x, p, HEADS)
    torch.testing.assert_close(dx, rdx, rtol=0, atol=0)
    assert tv.fused_vit_stack.launches == f0
    assert tv.fused_vit_stack_bwd.launches == b0
