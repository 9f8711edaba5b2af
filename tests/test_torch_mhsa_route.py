"""PyTorch port: what kernel #7's wrappers do in Python around the kernels
(``ops/attention.py``), on the CPU.

  * the dtype picks the kernels: the wrappers pass bf16 = 1 (bf16
    products on the wgmma + TMA kernels of ``csrc/attention_wgmma.cuh``)
    or 0 (fp32 products as 3xTF32 on the TF32 wgmma + TMA kernels of
    ``csrc/attention_wgmma_f32.cuh``) to the C entry points;
  * with a stand-in for the kernel library (the launchers pointed at the
    CPU), each wrapper passes as many arguments as the C signature has;
  * under autograd the forward asks its kernel for the row statistics and
    the backward hands the same buffer on, and the forward's output o,
    with no forward of its own; called without them, the backward runs
    ``rp_mhsa_fwd`` with statistics first, into the buffers it then hands
    to ``rp_mhsa_bwd``; o is never the T(do / l) scratch;
  * the head-count limit of the launch grid and the shape, dtype and
    contiguity checks, of the statistics and of o too, raise before any
    launch;
  * each wrapper adds one to its launch counter per launch, and only then
    (the backward's own forward counts as the backward's);
  * CPU tensors take the plain versions, load no library and leave the
    counters alone.

The kernels themselves run only on the card (``chip_smoke.py`` phase 3c
holds them to the plain versions).
"""

import numpy as np
import pytest
import torch

from rel_pose_tpu_torch.ops import _build
from rel_pose_tpu_torch.ops import attention as ta

G, N, D = 3, 10, 64
SCALE = D ** -0.5
DTYPES = [torch.bfloat16, torch.float32]


def heads(dtype, n=4, shape=(G, N, D)):
    rng = np.random.default_rng(7)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for _ in range(n)]


class FakeLibrary:
    """Records each entry point's arguments and returns ``err``."""

    def __init__(self, err=0):
        self.calls = []
        self.err = err

    def __getattr__(self, name):
        def entry(*args):
            if name == "rp_error_string":
                return b"stand-in error"
            self.calls.append((name, args))
            return self.err
        return entry

    def names(self):
        return [name for name, _ in self.calls]


@pytest.fixture
def fake_lib(monkeypatch):
    lib = FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "prepare_launch", lambda device: 0)
    monkeypatch.setattr(ta, "_KERNEL_DEVICE", "cpu")
    return lib


def check_arity(lib):
    for name, args in lib.calls:
        assert len(args) == len(_build.SIGNATURES[name][0]), name


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_passes_dtype_and_sizes(fake_lib, dtype):
    q, k, v = heads(dtype, 3)
    o, stats = ta._launch_fwd(q, k, v, SCALE)
    (name, args), = fake_lib.calls
    assert name == "rp_mhsa_fwd"
    check_arity(fake_lib)
    # q, k, v, o, stats; G, N, d, scale, bf16; stream
    assert args[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), None)
    assert args[5:10] == (G, N, D, SCALE, int(dtype == torch.bfloat16))
    assert stats is None and o.shape == q.shape and o.dtype == dtype


def test_forward_keeps_stats_on_request(fake_lib):
    q, k, v = heads(torch.bfloat16, 3)
    o, stats = ta._launch_fwd(q, k, v, SCALE, stats=True)
    (name, args), = fake_lib.calls
    assert stats.shape == (G, N, 3) and stats.dtype == torch.float32
    assert args[4] == stats.data_ptr()


@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_without_stats(fake_lib, dtype):
    """Both dtypes run the forward with statistics and pass its statistics
    and output on, and a T(do / l) scratch of their own."""
    q, k, v, do = heads(dtype)
    f0 = ta.fused_mhsa.launches
    dq, dk, dv = ta.fused_mhsa_bwd(q, k, v, do, SCALE)
    check_arity(fake_lib)
    bwd = dict(fake_lib.calls)["rp_mhsa_bwd"]
    # q, k, v, do, dq, dk, dv, stats, dnb, o; G, N, d, scale, bf16; stream
    assert bwd[:7] == tuple(t.data_ptr() for t in (q, k, v, do, dq, dk, dv))
    assert bwd[10:15] == (G, N, D, SCALE, int(dtype == torch.bfloat16))
    assert bwd[8] is not None and bwd[8] not in bwd[:8]
    assert fake_lib.names() == ["rp_mhsa_fwd", "rp_mhsa_bwd"]
    fwd = fake_lib.calls[0][1]
    assert fwd[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert fwd[5:10] == (G, N, D, SCALE, int(dtype == torch.bfloat16))
    assert fwd[4] is not None and bwd[7] == fwd[4]
    assert bwd[9] == fwd[3] and bwd[9] != bwd[8]
    assert ta.fused_mhsa.launches == f0
    assert all(g.shape == q.shape and g.dtype == dtype for g in (dq, dk, dv))


def test_backward_with_stats_takes_no_stats_pass(fake_lib):
    """bf16 given the forward's statistics and output: one launch, which
    reads both."""
    q, k, v, do, o = heads(torch.bfloat16, 5)
    stats = torch.zeros((G, N, 3))
    ta.fused_mhsa_bwd(q, k, v, do, SCALE, stats, o)
    (name, args), = fake_lib.calls
    assert name == "rp_mhsa_bwd" and args[7] == stats.data_ptr()
    assert args[9] == o.data_ptr() and args[8] != o.data_ptr()
    assert args[14] == 1


def test_fp32_backward_with_stats_and_o_runs_no_forward(fake_lib):
    """fp32 given the forward's statistics and output: one launch, which
    reads both; its T(do / l) scratch is a buffer of its own."""
    q, k, v, do, o = heads(torch.float32, 5)
    stats = torch.zeros((G, N, 3))
    ta.fused_mhsa_bwd(q, k, v, do, SCALE, stats, o)
    check_arity(fake_lib)
    (name, args), = fake_lib.calls
    assert name == "rp_mhsa_bwd"
    assert args[7] == stats.data_ptr() and args[9] == o.data_ptr()
    assert args[8] not in (o.data_ptr(), stats.data_ptr(), *args[:7])
    assert args[14] == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_autograd_hands_the_forward_stats_on(fake_lib, dtype):
    """Under autograd the forward writes (m, l) and the backward reads that
    buffer and the forward's output as o, with no forward of its own."""
    leaves = [t.requires_grad_() for t in heads(dtype, 3)]
    out = ta.fused_mhsa(*leaves, SCALE)
    grads = torch.autograd.grad(out, leaves, torch.ones_like(out))
    check_arity(fake_lib)
    assert fake_lib.names() == ["rp_mhsa_fwd", "rp_mhsa_bwd"]
    fwd, bwd = (args for _, args in fake_lib.calls)
    assert fwd[4] is not None and bwd[7] == fwd[4]
    assert fwd[3] == out.data_ptr() and bwd[9] == fwd[3]
    assert bwd[8] != bwd[9]
    assert [g.shape for g in grads] == [(G, N, D)] * 3


@pytest.mark.parametrize("case", ["fp32 heads", "shape", "dtype", "forward"])
def test_stats_checks(fake_lib, case):
    """The statistics must be the forward's (G, N, 3) fp32 buffer, taken
    only with o (fp32 heads here; bf16 in test_o_checks); the fp32 forward
    keeps them as the bf16 one does."""
    q, k, v, do = heads(torch.bfloat16)
    stats = torch.zeros((G, N, 3))
    if case == "fp32 heads":
        with pytest.raises(ValueError, match="stats"):
            ta.fused_mhsa_bwd(*(t.float() for t in (q, k, v, do)), SCALE,
                              stats)
    elif case == "shape":
        with pytest.raises(ValueError, match="stats"):
            ta.fused_mhsa_bwd(q, k, v, do, SCALE, stats[:, :, :2])
    elif case == "dtype":
        with pytest.raises(ValueError, match="stats"):
            ta.fused_mhsa_bwd(q, k, v, do, SCALE, stats.double())
    else:
        o, st = ta._launch_fwd(*(t.float() for t in (q, k, v)), SCALE,
                               stats=True)
        (name, args), = fake_lib.calls
        assert st.shape == (G, N, 3) and st.dtype == torch.float32
        assert args[4] == st.data_ptr() and args[3] == o.data_ptr()
        return
    assert fake_lib.calls == []


@pytest.mark.parametrize("case", ["bf16 heads", "no stats", "shape",
                                  "dtype", "not contiguous"])
def test_o_checks(fake_lib, case):
    """o: with the statistics, a contiguous tensor of the heads' shape and
    dtype (an fp32 o for bf16 heads raises); a bad one raises before any
    launch."""
    q, k, v, do, o = heads(torch.float32, 5)
    stats = torch.zeros((G, N, 3))
    f0, b0 = ta.fused_mhsa.launches, ta.fused_mhsa_bwd.launches
    if case == "bf16 heads":
        args = [t.bfloat16() for t in (q, k, v, do)] + [SCALE, stats, o]
    elif case == "no stats":
        args = [q, k, v, do, SCALE, None, o]
    elif case == "shape":
        args = [q, k, v, do, SCALE, stats, o[:, :-1].contiguous()]
    elif case == "dtype":
        args = [q, k, v, do, SCALE, stats, o.bfloat16()]
    else:
        args = [q, k, v, do, SCALE, stats,
                o.transpose(0, 1).contiguous().transpose(0, 1)]
    with pytest.raises(ValueError, match=r"\bo\b"):
        ta.fused_mhsa_bwd(*args)
    assert fake_lib.calls == []
    assert (ta.fused_mhsa.launches, ta.fused_mhsa_bwd.launches) == (f0, b0)


@pytest.mark.parametrize("G_,ok", [(ta.MAX_HEADS, True),
                                   (ta.MAX_HEADS + 1, False)])
@pytest.mark.parametrize("which", ["forward", "backward"])
def test_grid_limit(fake_lib, G_, ok, which):
    """At most 65,535 heads: the launch grid's third dimension."""
    q, k, v, do = (torch.empty((G_, 1, D), dtype=torch.bfloat16)
                   for _ in range(4))
    call = ((lambda: ta._launch_fwd(q, k, v, SCALE)) if which == "forward"
            else (lambda: ta.fused_mhsa_bwd(q, k, v, do, SCALE)))
    if ok:
        call()
        assert fake_lib.calls
    else:
        with pytest.raises(ValueError, match="65535"):
            call()
        assert fake_lib.calls == []


@pytest.mark.parametrize("case,exc", [
    ("float16", TypeError), ("width 32", ValueError),
    ("not contiguous", ValueError), ("other shape", ValueError),
    ("other dtype", ValueError)])
def test_input_checks_raise_before_any_launch(fake_lib, case, exc):
    q, k, v, do = heads(torch.bfloat16)
    if case == "float16":
        q, k, v, do = (t.half() for t in (q, k, v, do))
    elif case == "width 32":
        q, k, v, do = (t[..., :32].contiguous() for t in (q, k, v, do))
    elif case == "not contiguous":
        k = k.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "other shape":
        v = v[:, :-1].contiguous()
    else:
        v = v.float()
    f0, b0 = ta.fused_mhsa.launches, ta.fused_mhsa_bwd.launches
    with pytest.raises(exc):
        ta._launch_fwd(q, k, v, SCALE)
    with pytest.raises(exc):
        ta.fused_mhsa_bwd(q, k, v, do, SCALE)
    assert fake_lib.calls == []
    assert (ta.fused_mhsa.launches, ta.fused_mhsa_bwd.launches) == (f0, b0)


def test_counters_rise_once_per_launch(fake_lib):
    """The forward counts its launch; the backward counts once per call,
    its own forward included."""
    q, k, v, do = heads(torch.bfloat16)
    f0, b0 = ta.fused_mhsa.launches, ta.fused_mhsa_bwd.launches
    ta.fused_mhsa(q, k, v, SCALE)
    ta._launch_fwd(q, k, v, SCALE, stats=True)
    assert ta.fused_mhsa.launches == f0 + 2
    ta.fused_mhsa_bwd(q, k, v, do, SCALE)
    assert ta.fused_mhsa_bwd.launches == b0 + 1
    assert ta.fused_mhsa.launches == f0 + 2
    assert len(fake_lib.calls) == 4


def test_failed_launch_raises_and_does_not_count(fake_lib):
    fake_lib.err = 1
    q, k, v, do = heads(torch.bfloat16)
    f0, b0 = ta.fused_mhsa.launches, ta.fused_mhsa_bwd.launches
    with pytest.raises(RuntimeError, match="rp_mhsa_fwd"):
        ta.fused_mhsa(q, k, v, SCALE)
    with pytest.raises(RuntimeError, match="rp_mhsa_fwd"):
        ta.fused_mhsa_bwd(q, k, v, do, SCALE)
    assert (ta.fused_mhsa.launches, ta.fused_mhsa_bwd.launches) == (f0, b0)


def test_fp32_backward_counts_its_forward_once(fake_lib):
    """fp32 without statistics: the forward it runs first counts as the
    backward's one launch; a failed forward there raises and counts
    nothing."""
    q, k, v, do = heads(torch.float32)
    f0, b0 = ta.fused_mhsa.launches, ta.fused_mhsa_bwd.launches
    ta.fused_mhsa_bwd(q, k, v, do, SCALE)
    assert (ta.fused_mhsa.launches, ta.fused_mhsa_bwd.launches) == (f0,
                                                                    b0 + 1)
    fake_lib.err = 1
    with pytest.raises(RuntimeError, match="rp_mhsa_fwd"):
        ta.fused_mhsa_bwd(q, k, v, do, SCALE)
    assert (ta.fused_mhsa.launches, ta.fused_mhsa_bwd.launches) == (f0,
                                                                    b0 + 1)
    assert fake_lib.names() == ["rp_mhsa_fwd", "rp_mhsa_bwd", "rp_mhsa_fwd"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_tensors_take_the_plain_versions(monkeypatch, dtype):
    """No library is loaded for CPU tensors and no counter moves."""
    def no_library():
        raise AssertionError("kernel library loaded for CPU tensors")
    monkeypatch.setattr(_build, "library", no_library)
    q, k, v, do = heads(dtype)
    f0, b0 = ta.fused_mhsa.launches, ta.fused_mhsa_bwd.launches
    torch.testing.assert_close(ta.fused_mhsa(q, k, v, SCALE),
                               ta.mhsa_reference(q, k, v, SCALE),
                               rtol=0, atol=0)
    for g, want in zip(ta.fused_mhsa_bwd(q, k, v, do, SCALE),
                       ta.mhsa_bwd_reference(q, k, v, do, SCALE)):
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    assert (ta.fused_mhsa.launches, ta.fused_mhsa_bwd.launches) == (f0, b0)
