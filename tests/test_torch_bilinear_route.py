"""PyTorch port: kernels #8 (``ops/bilinear.py``) and #9
(``ops/cross_variants.py``) around their launches, and a plain mirror of
their tensor-core decomposition, on the CPU.

  * both dtypes take the tensor-core bodies -- #8 and #9's modes the
    mma.sync body of ``csrc/essential_tc.cuh`` / ``essential_tc_bwd.cuh``
    (bf16 m16n8k16, fp32 3xTF32), #9's s #4's wgmma moments
    (``csrc/essential_wgmma.cuh``, ``essential_wgmma_f32.cuh``): the
    wrappers pass bf16 = 1 or 0 to the C entry points, after asking
    ``rp_bilinear_fwd_workspace``, ``rp_bilinear_bwd_workspace`` or
    ``rp_cross_variants_workspace`` for the scratch of those arguments, and
    hand on a buffer of that size, fp32 its own scratch too; every call has
    the C signature's arity;
  * the slice limit (65,535, the launch grid's second dimension) in both
    dtypes, bad shapes, dtypes and operands off the boundaries their loads
    need (16 bytes; 8 for fp32 va, vb of e = 70) raise before any launch;
  * a failed launch raises and does not count; each counter rises once per
    launch; ``essential_block_s`` / ``essential_block_variant`` pass S and
    the mode;
  * CPU tensors take the plain versions and load no library.
The launchers are pointed at the CPU (``_KERNEL_DEVICE``) with a stand-in
library, as tests/test_torch_essential_route.py does.

Then the decomposition the kernels compute, written out in PyTorch at
their 64-row tiles by tests/test_torch_essential_route.py's
``tc_slice_moments`` / ``tc_slice_bwd`` with the kernels' products
(``mirror_matmul``: fp32 as 3xTF32): on #8's slice layout (va != vb, a
runtime scale, e = 64 and 70, dual and single softmax) against the Pallas
``_fwd_call`` / ``_bwd_call`` in interpret mode and the port's plain
versions, and in #9's modes (``mxu_sums``: exact column maxima and sums of
bf16 exps; ``bf16_mul``: P as one bf16 product) against ``_variant_kernel``
in interpret mode, at N = 64, 100 (a ragged tile) and 576 for one case.
Tolerances as in the existing files: F relative to max|F| 1e-5 fp32, 1e-2
bf16 (#9's modes 1e-3); backward ||err|| / ||ref|| 1e-5 fp32, 1e-2 bf16.
And #8's fp32 mirror held to the float64 bar of ``chip_smoke.py`` phase 3b
(``chip_smoke.bilinear_f64``): at N = 576 and 100, e = 70 and 64, dual and
single softmax, its max |err| from float64 at most twice the fp32 plain
version's for F, dq, dk, dva and dvb; a mirror with single TF32 products
fails it.  The kernels themselves run only on the card (``chip_smoke.py``
3b, 3e, 3f).
"""

import functools
import importlib.util
import pathlib

import chip_smoke
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from rel_pose_tpu.ops import pallas_essential as jpe
from rel_pose_tpu_torch.ops import _build
from rel_pose_tpu_torch.ops import bilinear as tb
from rel_pose_tpu_torch.ops import cross_variants as cv
from rel_pose_tpu_torch.ops import essential_block as te
from rel_pose_tpu_torch.ops.vit_stack import tf32x3_matmul
from test_torch_essential_route import (WS_BYTES, FakeLibrary, _normrel,
                                        _slices, check_arity, mirror_matmul,
                                        tc_slice_bwd, tc_slice_moments,
                                        tf32_matmul)

REPO = pathlib.Path(__file__).resolve().parent.parent
G, N, HEADS = 3, 10, 3
C = 64 * HEADS
SIGMA = 0.1           # a softmax scale other than d^-1/2: the runtime scale
DTYPES = [torch.bfloat16, torch.float32]
BOOLS = [False, True]


def _n(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32))


def bilinear_args(dtype, e=70, same=False, g=G, n=N, seed=0):
    """q, k (g, n, 64), va, vb (g, n, e) in dtype (va is vb with
    ``same``), dF (g, e, e) fp32."""
    rng = np.random.default_rng(seed)
    q, k, vb = (_n(rng, g, n, w).to(dtype) for w in (64, 64, e))
    va = vb if same else _n(rng, g, n, e).to(dtype)
    return q, k, va, vb, _n(rng, g, e, e, scale=0.1)


def pair_args(dtype, b=2, n=N):
    rng = np.random.default_rng(7)
    return (_n(rng, b, n, 3 * C).to(dtype), _n(rng, b, n, 3 * C).to(dtype),
            _n(rng, b, n, 6))


@pytest.fixture
def fake_lib(monkeypatch):
    lib = FakeLibrary(fp32_ws=True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "prepare_launch", lambda device: 0)
    monkeypatch.setattr(tb, "_KERNEL_DEVICE", "cpu")
    monkeypatch.setattr(te, "_KERNEL_DEVICE", "cpu")
    return lib


# ----------------------------------------------------------- #8 routes --

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e", [70, 64])
@pytest.mark.parametrize("single", BOOLS, ids=["dual", "single"])
@pytest.mark.parametrize("same", BOOLS, ids=["va!=vb", "va=vb"])
def test_forward_route(fake_lib, dtype, e, single, same):
    q, k, va, vb, _ = bilinear_args(dtype, e, same)
    f = tb.fused_bilinear_attention(q, k, va, vb, SIGMA, single)
    check_arity(fake_lib)
    assert fake_lib.names() == ["rp_bilinear_fwd_workspace",
                                "rp_bilinear_fwd"]
    (_, query), (_, args) = fake_lib.calls
    bf16 = int(dtype == torch.bfloat16)
    assert query == (G, N, e, bf16)
    # q, k, va, vb, F, ws; G, N, e, single, scale * log2e, bf16; stream
    assert args[:5] == (q.data_ptr(), k.data_ptr(), va.data_ptr(),
                        vb.data_ptr(), f.data_ptr())
    assert (args[2] == args[3]) == same
    assert args[5] is not None      # fp32 passes its scratch too
    assert args[6:10] == (G, N, e, int(single))
    assert args[10] == pytest.approx(SIGMA * tb.LOG2E)
    assert args[11] == bf16
    assert f.shape == (G, e, e) and f.dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("e", [70, 64])
@pytest.mark.parametrize("single", BOOLS, ids=["dual", "single"])
def test_backward_route(fake_lib, dtype, e, single):
    q, k, va, vb, df = bilinear_args(dtype, e)
    grads = tb.fused_bilinear_attention_bwd(q, k, va, vb, df, SIGMA, single)
    check_arity(fake_lib)
    assert fake_lib.names() == ["rp_bilinear_bwd_workspace",
                                "rp_bilinear_bwd"]
    (_, query), (_, args) = fake_lib.calls
    bf16 = int(dtype == torch.bfloat16)
    assert query == (G, N, e, bf16)
    # q, k, va, vb, dF, dq, dk, dva, dvb, ws; G, N, e, single,
    # scale * log2e, scale, bf16; stream
    assert args[:5] == (q.data_ptr(), k.data_ptr(), va.data_ptr(),
                        vb.data_ptr(), df.data_ptr())
    assert args[5:9] == tuple(g.data_ptr() for g in grads)
    assert args[9] is not None      # fp32 passes its scratch too
    assert args[10:14] == (G, N, e, int(single))
    assert args[14] == pytest.approx(SIGMA * tb.LOG2E)
    assert args[15] == pytest.approx(SIGMA) and args[16] == bf16
    for g, x in zip(grads, (q, k, va, vb)):
        assert g.shape == x.shape and g.dtype == x.dtype


@pytest.mark.parametrize("same", BOOLS, ids=["va!=vb", "va=vb"])
def test_autograd_route(fake_lib, same):
    """Under autograd the Function launches the forward, then the
    backward on the saved inputs; va = vb receives both cotangents."""
    q, k, va, vb, _ = bilinear_args(torch.bfloat16, same=same)
    leaves = [t.clone().requires_grad_() for t in (q, k, vb)]
    va_leaf = leaves[2] if same else va.clone().requires_grad_()
    f = tb.fused_bilinear_attention(leaves[0], leaves[1], va_leaf, leaves[2],
                                    SIGMA)
    f.backward(torch.zeros_like(f))
    assert fake_lib.names() == ["rp_bilinear_fwd_workspace",
                                "rp_bilinear_fwd",
                                "rp_bilinear_bwd_workspace",
                                "rp_bilinear_bwd"]
    assert all(t.grad is not None for t in leaves + [va_leaf])


def test_workspace_buffer_has_the_answered_size(fake_lib, monkeypatch):
    """The buffers handed on are uint8 tensors of the answered size, in
    either dtype."""
    sizes = []
    real = torch.empty

    def empty(*shape, **kw):
        t = real(*shape, **kw)
        if kw.get("dtype") == torch.uint8:
            sizes.append(t.numel())
        return t
    monkeypatch.setattr(torch, "empty", empty)
    for dtype in DTYPES:
        q, k, va, vb, df = bilinear_args(dtype)
        tb.fused_bilinear_attention(q, k, va, vb, SIGMA)
        tb.fused_bilinear_attention_bwd(q, k, va, vb, df, SIGMA)
        cv.essential_block_s(*pair_args(dtype), 2)
    assert sizes == [WS_BYTES] * 6
    assert [a[-1] for n, a in fake_lib.calls if n.endswith("_workspace")] \
        == [1, 1, 1, 0, 0, 0]


# (entry point, dtype, G, launches): a passing backward call would need a
# (G, 64, 64) fp32 dF of 1 GB, so the backward is held to the raise only
@pytest.mark.parametrize("which,dtype,g,ok", [
    ("fwd", torch.bfloat16, 65535, True),
    ("fwd", torch.bfloat16, 65536, False),
    ("fwd", torch.float32, 65536, False),
    ("bwd", torch.bfloat16, 65536, False),
    ("bwd", torch.float32, 65536, False)])
def test_slice_limit(fake_lib, which, dtype, g, ok):
    """At most 65,535 slices in the grid, in either dtype."""
    q = torch.empty((g, 1, 64), dtype=dtype)
    df = torch.empty((1, 64, 64))       # never read: the limit raises first
    call = ((lambda: tb.fused_bilinear_attention(q, q, q, q, SIGMA))
            if which == "fwd" else
            (lambda: tb.fused_bilinear_attention_bwd(q, q, q, q, df, SIGMA)))
    if ok:
        call()
        assert fake_lib.calls
    else:
        with pytest.raises(ValueError, match="65535"):
            call()
        assert fake_lib.calls == []


CHECK_CASES = [("float16", TypeError), ("head width", ValueError),
               ("e", ValueError), ("not contiguous", ValueError),
               ("k shape", ValueError), ("vb dtype", ValueError),
               ("unaligned", ValueError), ("unaligned fp32", ValueError),
               ("dF shape", ValueError), ("dF dtype", ValueError)]


@pytest.mark.parametrize("case,exc", CHECK_CASES,
                         ids=[c for c, _ in CHECK_CASES])
def test_input_checks_raise_before_any_launch(fake_lib, case, exc):
    q, k, va, vb, df = bilinear_args(torch.bfloat16)
    if case == "float16":
        q, k, va, vb = (t.half() for t in (q, k, va, vb))
    elif case == "head width":
        q, k = q[..., :32].contiguous(), k[..., :32].contiguous()
    elif case == "e":
        va = vb = vb[..., :66].contiguous()
        df = df[:, :66, :66].contiguous()
    elif case == "not contiguous":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "k shape":
        k = k[:, :-1].contiguous()
    elif case == "vb dtype":
        vb = vb.float()
    elif case == "unaligned":
        flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
        q = flat[1:].view(q.shape)
        assert q.is_contiguous() and q.data_ptr() % 16
    elif case == "unaligned fp32":
        # an fp32 va of e = 70 one value in: off the 8 bytes of its loads
        q, k, vb = q.float(), k.float(), vb.float()
        flat = torch.zeros(va.numel() + 1)
        va = flat[1:].view(va.shape)
        assert va.is_contiguous() and va.data_ptr() % 8
    elif case == "dF shape":
        df = df[:, :64, :64].contiguous()
    else:
        df = df.double()
    counters = (tb.fused_bilinear_attention.launches,
                tb.fused_bilinear_attention_bwd.launches)
    if not case.startswith("dF"):
        with pytest.raises(exc, match={"unaligned": "16-byte",
                                       "unaligned fp32": "8-byte"}.get(case)):
            tb.fused_bilinear_attention(q, k, va, vb, SIGMA)
    with pytest.raises(exc):
        tb.fused_bilinear_attention_bwd(q, k, va, vb, df, SIGMA)
    assert fake_lib.calls == []
    assert counters == (tb.fused_bilinear_attention.launches,
                        tb.fused_bilinear_attention_bwd.launches)


@pytest.mark.parametrize("which,e,offset,ok", [
    ("va", 70, 2, True), ("vb", 70, 2, True), ("q", 70, 2, False),
    ("va", 64, 2, False)], ids=["va-e70-8B", "vb-e70-8B", "q-8B",
                                "va-e64-8B"])
def test_fp32_operand_alignment(fake_lib, which, e, offset, ok):
    """fp32 va and vb of e = 70 load two values (8 bytes) a copy: 8 bytes
    in launches; q, k and e = 64 rows load 16 bytes a copy and raise
    there, forward and backward."""
    args = list(bilinear_args(torch.float32, e))
    i = "q k va vb".split().index(which)
    flat = torch.zeros(args[i].numel() + offset)
    args[i] = flat[offset:].view(args[i].shape).copy_(args[i])
    assert args[i].data_ptr() % 16 == 8
    calls = (lambda: tb.fused_bilinear_attention(*args[:4], SIGMA),
             lambda: tb.fused_bilinear_attention_bwd(*args, SIGMA))
    for call in calls:
        if ok:
            call()
        else:
            with pytest.raises(ValueError, match="16-byte"):
                call()
    assert len(fake_lib.calls) == (4 if ok else 0)


def test_counters_rise_once_per_launch(fake_lib):
    q, k, va, vb, df = bilinear_args(torch.bfloat16)
    q1, q2, pos = pair_args(torch.bfloat16)
    ops = (tb.fused_bilinear_attention, tb.fused_bilinear_attention_bwd,
           cv.essential_block_s, cv.essential_block_variant)
    before = [op.launches for op in ops]
    tb.fused_bilinear_attention(q, k, va, vb, SIGMA)
    tb.fused_bilinear_attention_bwd(q, k, va, vb, df, SIGMA)
    cv.essential_block_s(q1, q2, pos, 2)
    cv.essential_block_variant(q1, q2, pos, "mxu_sums")
    assert [op.launches - b for op, b in zip(ops, before)] == [1, 1, 1, 1]


def test_failed_launch_raises_and_does_not_count(fake_lib):
    fake_lib.err = 1
    q, k, va, vb, df = bilinear_args(torch.bfloat16)
    q1, q2, pos = pair_args(torch.bfloat16)
    ops = (tb.fused_bilinear_attention, tb.fused_bilinear_attention_bwd,
           cv.essential_block_s, cv.essential_block_variant)
    before = [op.launches for op in ops]
    with pytest.raises(RuntimeError, match="rp_bilinear_fwd"):
        tb.fused_bilinear_attention(q, k, va, vb, SIGMA)
    with pytest.raises(RuntimeError, match="rp_bilinear_bwd"):
        tb.fused_bilinear_attention_bwd(q, k, va, vb, df, SIGMA)
    with pytest.raises(RuntimeError, match="rp_essential_block_s"):
        cv.essential_block_s(q1, q2, pos, 2)
    with pytest.raises(RuntimeError, match="rp_essential_block_variant"):
        cv.essential_block_variant(q1, q2, pos, "bf16_mul")
    assert before == [op.launches for op in ops]


# ----------------------------------------------------------- #9 routes --

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [1, 2])
def test_essential_block_s_route(fake_lib, dtype, S):
    q1, q2, pos = pair_args(dtype)
    f = cv.essential_block_s(q1, q2, pos, S)
    check_arity(fake_lib)
    assert fake_lib.names() == ["rp_cross_variants_workspace",
                                "rp_essential_block_s"]
    (_, query), (_, args) = fake_lib.calls
    bf16 = int(dtype == torch.bfloat16)
    assert query == (2, N, HEADS, bf16)
    # qkv1, qkv2, pos, F, ws; B, N, C, heads, S, bf16; stream
    assert args[:2] == (q1.data_ptr(), q2.data_ptr())
    assert args[3] == f.data_ptr()
    assert args[4] is not None      # fp32 passes its scratch too
    assert args[5:11] == (2, N, C, HEADS, S, bf16)
    assert f.shape == (2, 2, HEADS, 70, 70)


@pytest.mark.parametrize("mode", cv.MODES)
def test_essential_block_variant_route(fake_lib, mode):
    q1, q2, pos = pair_args(torch.bfloat16)
    f = cv.essential_block_variant(q1, q2, pos, mode)
    check_arity(fake_lib)
    assert fake_lib.names() == ["rp_cross_variants_workspace",
                                "rp_essential_block_variant"]
    (_, query), (_, args) = fake_lib.calls
    assert query == (2, N, HEADS, 1)
    # qkv1, qkv2, pos, F, ws; B, N, C, heads, mode; stream
    assert args[3] == f.data_ptr() and args[4] is not None
    assert args[5:10] == (2, N, C, HEADS, cv.MODES.index(mode))


def test_cross_variants_checks_raise_before_any_launch(fake_lib):
    """At most 65,535 slices (2 B heads) in either dtype; S must divide B;
    the modes take bf16 only."""
    for dtype in DTYPES:
        big = torch.empty((65535 // (2 * HEADS) + 1, 1, 3 * C), dtype=dtype)
        with pytest.raises(ValueError, match="65535"):
            cv.essential_block_s(big, big,
                                 torch.zeros(big.shape[:2] + (6,)), 1)
    q1, q2, pos = pair_args(torch.bfloat16)
    with pytest.raises(ValueError, match="divide"):
        cv.essential_block_s(q1, q2, pos, 3)
    with pytest.raises(TypeError, match="bf16"):
        cv.essential_block_variant(q1.float(), q2.float(), pos, "mxu_sums")
    assert fake_lib.calls == []


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_tensors_take_the_plain_versions(monkeypatch, dtype):
    """No library is loaded for CPU tensors and no counter moves."""
    def no_library():
        raise AssertionError("kernel library loaded for CPU tensors")
    monkeypatch.setattr(_build, "library", no_library)
    q, k, va, vb, df = bilinear_args(dtype)
    q1, q2, pos = pair_args(dtype)
    ops = (tb.fused_bilinear_attention, tb.fused_bilinear_attention_bwd,
           cv.essential_block_s, cv.essential_block_variant)
    before = [op.launches for op in ops]
    exact = functools.partial(torch.testing.assert_close, rtol=0, atol=0)
    exact(tb.fused_bilinear_attention(q, k, va, vb, SIGMA),
          tb.bilinear_attention_reference(q, k, va, vb, SIGMA))
    for a, b in zip(tb.fused_bilinear_attention_bwd(q, k, va, vb, df, SIGMA),
                    tb.bilinear_attention_bwd_reference(q, k, va, vb, df,
                                                        SIGMA)):
        exact(a, b)
    exact(cv.essential_block_s(q1, q2, pos, 2),
          te.essential_block_reference(q1, q2, pos, HEADS))
    if dtype == torch.bfloat16:
        exact(cv.essential_block_variant(q1, q2, pos, "bf16_mul"),
              cv.essential_block_variant_reference(q1, q2, pos, "bf16_mul"))
    assert before == [op.launches for op in ops]


# --------------------------------------- the tensor-core decomposition --

# (N, e, single): #8's slice layout at the kernels' 64-row tiles
MIRROR_CASES = [(64, 70, False), (100, 70, False), (100, 70, True),
                (100, 64, False), (100, 64, True), (576, 70, False)]
MIRROR_IDS = [f"N={n}-e={e}-{'single' if s else 'dual'}"
              for n, e, s in MIRROR_CASES]
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _mirror_slices(n, e, dtype):
    """Two slices, the first with va = vb, the second with va != vb, in
    dtype; dF fp32."""
    rng = np.random.default_rng(n + e)
    q, k, vb = (_n(rng, 2, n, w, scale=1.5) for w in (64, 64, e))
    va = torch.cat([vb[:1], _n(rng, 1, n, e, scale=1.5)])
    return [t.to(dtype) for t in (q, k, va, vb)], _n(rng, 2, e, e, scale=0.1)


def _jax(dtype, *tensors):
    jdt = "bfloat16" if dtype == torch.bfloat16 else "float32"
    return [jnp.asarray(t.float().numpy()).astype(jdt) for t in tensors]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,e,single", MIRROR_CASES, ids=MIRROR_IDS)
def test_slice_moments_mirror_matches_pallas(n, e, single, dtype):
    """#8's forward decomposition against ``_fwd_call`` in interpret mode
    and the port's plain version, F relative to max|F|."""
    xs, _ = _mirror_slices(n, e, dtype)
    want = np.asarray(jpe._fwd_call(*_jax(dtype, *xs), SIGMA, single,
                                    interpret=True))
    got = tc_slice_moments(*(t.float() for t in xs),
                           np.float32(SIGMA * tb.LOG2E),
                           "single" if single else "dual", dtype,
                           mirror_matmul(dtype))
    plain = tb.bilinear_attention_reference(*xs, SIGMA, single)
    for ref in (want, plain.numpy()):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=TOL[dtype] * np.abs(ref).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,e,single", MIRROR_CASES, ids=MIRROR_IDS)
def test_slice_bwd_mirror_matches_pallas(n, e, single, dtype):
    """#8's backward decomposition (statistics, prologue, rho / gamma, the
    two gradient passes, dva and dvb each rounded by itself) against
    ``_bwd_call`` in interpret mode and the port's plain version."""
    xs, df = _mirror_slices(n, e, dtype)
    want = jpe._bwd_call(*_jax(dtype, *xs), jnp.asarray(df.numpy()), SIGMA,
                         single, interpret=True)
    got = [g.to(dtype) for g in tc_slice_bwd(
        *(t.float() for t in xs), df, np.float32(SIGMA * tb.LOG2E), SIGMA,
        single, dtype, mirror_matmul(dtype))]
    plain = tb.bilinear_attention_bwd_reference(*xs, df, SIGMA, single)
    for name, g, w, p in zip(("dq", "dk", "dva", "dvb"), got, want, plain):
        for ref in (np.asarray(w, np.float32), p.float()):
            assert _normrel(g.float(), ref) <= TOL[dtype], name


# ---------------------------------------------- the fp32 float64 bar --

def slice_f64_errors(n, e, single, mm=tf32x3_matmul):
    """{output: (the mirror's max |err|, the fp32 plain version's)} from
    #8 run in float64 (``chip_smoke.bilinear_f64``, gradients by autograd
    with va and vb separate leaves) on ``_mirror_slices`` (one slice va =
    vb, one va != vb), for F, dq, dk, dva and dvb."""
    xs, df = _mirror_slices(n, e, torch.float32)
    scale = np.float32(SIGMA * tb.LOG2E)
    got = [tc_slice_moments(*xs, scale, "single" if single else "dual",
                            torch.float32, mm),
           *tc_slice_bwd(*xs, df, scale, SIGMA, single, torch.float32, mm)]
    plain = [tb.bilinear_attention_reference(*xs, SIGMA, single),
             *tb.bilinear_attention_bwd_reference(*xs, df, SIGMA, single)]
    leaves = [t.double().requires_grad_() for t in xs]
    f64 = chip_smoke.bilinear_f64(*leaves, SIGMA, single)
    ref = [f64.detach(), *torch.autograd.grad((f64 * df.double()).sum(),
                                              leaves)]
    err = lambda t, r: (t.double() - r).abs().max().item()
    return {part: (err(g, r), err(p, r)) for part, g, p, r in zip(
        ("F", "dq", "dk", "dva", "dvb"), got, plain, ref)}


F64_CASES = [(n, e, s) for n in (576, 100) for e in (70, 64)
             for s in (False, True)]


@pytest.mark.parametrize("n,e,single", F64_CASES,
                         ids=[f"N={n}-e={e}-{'single' if s else 'dual'}"
                              for n, e, s in F64_CASES])
def test_fp32_slice_mirror_within_float64_bar(n, e, single):
    """#8's fp32 mirror (3xTF32 products): its max |err| from float64 at
    most ``chip_smoke.F64_BAR`` (2) times the fp32 plain version's, per
    output."""
    for part, (got, plain) in slice_f64_errors(n, e, single).items():
        assert got <= chip_smoke.F64_BAR * plain, (part, got, plain)


def test_tf32_slice_mirror_fails_float64_bar():
    """The same mirror with single TF32 products (hi . hi) is far outside
    the bar, for every output: the bar tells TF32 from 3xTF32 on #8 too."""
    for part, (got, plain) in slice_f64_errors(576, 70, False,
                                               tf32_matmul).items():
        assert got > 10 * chip_smoke.F64_BAR * plain, (part, got, plain)


@pytest.fixture(scope="module")
def bench_cross():
    mp = pytest.MonkeyPatch()
    mp.setenv("RELPOSE_NO_CACHE", "1")
    try:
        spec = importlib.util.spec_from_file_location(
            "bench_cross", REPO / "scripts" / "bench_cross.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        mp.undo()
    return module


@pytest.mark.parametrize("n", [64, 100])
@pytest.mark.parametrize("mode", cv.MODES)
def test_variant_mode_mirror_matches_pallas(bench_cross, mode, n):
    """#9's modes in the tensor-core decomposition (kEbMxuSums: the max
    walk, then the sums of bf16 exps; kEbBf16Mul: one bf16 product)
    against ``_variant_kernel`` in interpret mode, |err| <= 1e-3 max|F|."""
    b = 1
    rng = np.random.default_rng(n)
    qkv1, qkv2 = (_n(rng, b, n, 3 * C, scale=1.5).to(torch.bfloat16)
                  for _ in range(2))
    pos = _n(rng, b, n, 6).to(torch.bfloat16)
    spec = lambda *shape: pl.BlockSpec(
        shape, lambda i: (i,) + (0,) * (len(shape) - 1))
    want = np.asarray(pl.pallas_call(
        functools.partial(bench_cross._variant_kernel, num_heads=HEADS,
                          head_dim=64, mode=mode),
        out_shape=jax.ShapeDtypeStruct((b, 2, HEADS, 70, 70), jnp.float32),
        grid=(b,), in_specs=[spec(1, n, 3 * C), spec(1, n, 3 * C),
                             spec(1, n, 6)],
        out_specs=spec(1, 2, HEADS, 70, 70), interpret=True)(
            *_jax(torch.bfloat16, qkv1, qkv2, pos)))
    q, k, vb, va = _slices(torch.stack([qkv1, qkv2], 1), pos, HEADS, False)
    scale = np.float32(0.125) * np.float32(tb.LOG2E)
    got = tc_slice_moments(q, k, va, vb, scale, mode, torch.bfloat16)
    got = got.view(b, 2, HEADS, 70, 70).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 * np.abs(want).max())
