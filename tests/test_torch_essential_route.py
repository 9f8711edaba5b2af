"""PyTorch port: the essential block's kernels (#2, #3, #4 and #6,
``ops/essential_block.py``) around their launches, and a plain mirror of
the tensor-core decomposition, on the CPU.

  * both dtypes take the wgmma kernels (bf16 ``csrc/essential_wgmma.cuh``,
    which tests/test_torch_essential_wgmma_bf16.py mirrors, fp32 the TF32
    wgmma body of ``csrc/essential_wgmma_f32.cuh``, which
    tests/test_torch_essential_wgmma_f32.py mirrors): the wrappers
    pass bf16 = 1 or 0 to the C entry points, after asking
    ``rp_essential_block_workspace`` / ``rp_essential_block_bwd_workspace``
    for the scratch of those arguments, and hand on a buffer of that size;
    every call has the C signature's arity;
  * every (e, SINGLE, CROSS) reaches the entry points with its flags,
    shapes and contiguous operands; the bwd buffers (dva with cross
    features, the positional partials) are there exactly when needed;
  * the launch grids' limits (65,535 slices, the qkv GEMM's 2^31 - 1
    rows in either dtype),
    operands off the 16-byte grid, bad shapes and dtypes raise before any
    launch;
  * each wrapper adds one to its launch counter per launch, only then;
  * CPU tensors take the plain versions and load no library.

Then the decomposition the mma.sync kernels computed (#2 and #6 before
their wgmma bodies; #8 and #9's modes still), written out in PyTorch at
their 64-row tiles (``tc_moments_mirror``, ``tc_bwd_mirror`` on the pair
layout, over the slice-level ``tc_slice_moments`` / ``tc_slice_bwd`` that
tests/test_torch_bilinear_route.py holds to kernels #8 and #9): column
statistics merged online over query tiles of the transposed product, the
exact row max, P vb_n per key tile and per-tile F partials summed in
order; the backward's statistics, prologue, rho / gamma passes and the two
gradient passes as one template whose own and walked sides swap.  In fp32
every product goes through ``ops.vit_stack.tf32x3_matmul``, the plain
model of the kernels' 3xTF32.  Both are held to the Pallas kernels in
interpret mode (``_essential_block_call``, ``essential_block_bwd_call``)
and to the port's plain versions at N = 64, 100 (a ragged last tile) and
576.  Tolerances are those of tests/test_torch_essential_ablations.py: F
relative to max|F| 1e-5 fp32, 1e-2 bf16; backward ||err|| / ||ref|| 1e-5
fp32, 1e-2 bf16 (a sum-order difference can flip one bf16 rounding by an
ulp).  And the fp32 mirror's float64 bar, that of ``chip_smoke.py`` phase
3b: at N = 576, one pair, each flag set, its max |err| from the moments
run in float64 at most twice the fp32 plain version's, for F, dq, dk, dv
and dpos; a mirror with single TF32 products (hi . hi) fails it.  The
kernels themselves run only on the card (``chip_smoke.py`` phases 3b,
3d).
"""

import itertools
import pathlib

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rel_pose_tpu.ops.pallas_essential_block import _essential_block_call
from rel_pose_tpu.ops.pallas_essential_block_bwd import \
    essential_block_bwd_call
from rel_pose_tpu_torch.nn.transformer import LOG2E
from rel_pose_tpu_torch.ops import _build
from rel_pose_tpu_torch.ops import essential_block as te
from rel_pose_tpu_torch.ops.vit_stack import tf32_rna, tf32x3_matmul

CSRC = pathlib.Path(te.__file__).resolve().parent.parent / "csrc"

B, N, HEADS = 2, 10, 3
C = 64 * HEADS
DTYPES = [torch.bfloat16, torch.float32]
# (has_pos, cross_features, use_single_softmax)
VARIANTS = list(itertools.product((True, False), repeat=3))
VARIANT_IDS = [f"{'pos' if p else 'nopos'}-{'cross' if x else 'self'}-"
               f"{'single' if s else 'dual'}" for p, x, s in VARIANTS]
WS_BYTES = 4096       # the stand-in's answer to a workspace query


def _n(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32))


def pair_args(dtype, has_pos=True, b=B, n=N):
    rng = np.random.default_rng(5)
    return (_n(rng, b, 2, n, C).to(dtype),
            (1 + _n(rng, C, scale=0.1), _n(rng, C, scale=0.1)),
            (_n(rng, 3 * C, C, scale=C ** -0.5), _n(rng, 3 * C, scale=0.1)),
            _n(rng, b, n, 6) if has_pos else None)


class FakeLibrary:
    """Records each entry point's arguments; the workspace queries answer
    ``WS_BYTES`` for bf16 and, with ``fp32_ws``, for fp32 too (else 0), the
    launchers ``err``."""

    def __init__(self, err=0, fp32_ws=False):
        self.calls = []
        self.err = err
        self.fp32_ws = fp32_ws

    def __getattr__(self, name):
        def entry(*args):
            if name == "rp_error_string":
                return b"stand-in error"
            self.calls.append((name, args))
            if name.endswith("_workspace"):
                return WS_BYTES if args[-1] or self.fp32_ws else 0
            return self.err
        return entry

    def names(self):
        return [name for name, _ in self.calls]


@pytest.fixture
def fake_lib(monkeypatch):
    lib = FakeLibrary(fp32_ws=True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "prepare_launch", lambda device: 0)
    monkeypatch.setattr(te, "_KERNEL_DEVICE", "cpu")
    return lib


def check_arity(lib):
    for name, args in lib.calls:
        assert len(args) == len(_build.SIGNATURES[name][0]), name


def check_workspace(lib, query, launch_args, ws_index, has_pos, bf16,
                    b=B, n=N):
    """The workspace query carries (B, N, heads, has_pos, bf16) and the
    launch the buffer of the size it answered: both dtypes have one."""
    (qname, qargs), = [(k, a) for k, a in lib.calls if k == query]
    assert qargs == (b, n, HEADS, int(has_pos), int(bf16))
    assert launch_args[ws_index] is not None


# ----------------------------------------------------------- the routes --

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("has_pos,cross,single", VARIANTS, ids=VARIANT_IDS)
def test_pair_route(fake_lib, has_pos, cross, single, dtype):
    """#2: LN, the qkv Linear and the moments in one entry point."""
    xpair, ln, qkvp, pos = pair_args(dtype, has_pos)
    f = te.fused_essential_block_pair(xpair, ln, qkvp, pos, HEADS,
                                      cross_features=cross,
                                      use_single_softmax=single)
    check_arity(fake_lib)
    assert fake_lib.names() == ["rp_essential_block_workspace",
                                "rp_essential_block_pair"]
    args = fake_lib.calls[1][1]
    # xpair, lns, lnb, w, b, pos, F, y, qkv, ws; B, N, C, heads, flags,
    # bf16; stream
    assert args[0] == xpair.data_ptr() and args[6] == f.data_ptr()
    assert (args[5] is None) == (not has_pos)
    assert args[10:18] == (B, N, C, HEADS, int(has_pos), int(single),
                           int(cross), int(dtype == torch.bfloat16))
    check_workspace(fake_lib, "rp_essential_block_workspace", args, 9,
                    has_pos, dtype == torch.bfloat16)
    e = 64 + 6 * has_pos
    assert f.shape == (B, 2, HEADS, e, e) and f.dtype == torch.float32


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("has_pos,cross,single", VARIANTS, ids=VARIANT_IDS)
def test_block_route(fake_lib, has_pos, cross, single, dtype):
    """#4: precomputed qkv1, qkv2 to ``rp_essential_block``."""
    rng = np.random.default_rng(6)
    q1, q2 = (_n(rng, B, N, 3 * C).to(dtype) for _ in range(2))
    pos = _n(rng, B, N, 6) if has_pos else None
    f = te.fused_essential_block(q1, q2, pos, HEADS, cross_features=cross,
                                 use_single_softmax=single)
    check_arity(fake_lib)
    assert fake_lib.names() == ["rp_essential_block_workspace",
                                "rp_essential_block"]
    args = fake_lib.calls[1][1]
    # qkv1, qkv2, pos, F, ws; B, N, C, heads, flags, bf16; stream
    assert args[:2] == (q1.data_ptr(), q2.data_ptr())
    assert args[3] == f.data_ptr() and (args[2] is None) == (not has_pos)
    assert args[5:13] == (B, N, C, HEADS, int(has_pos), int(single),
                          int(cross), int(dtype == torch.bfloat16))
    check_workspace(fake_lib, "rp_essential_block_workspace", args, 4,
                    has_pos, dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_x_route(fake_lib, dtype):
    """#3: pre-normed x1, x2 to ``rp_essential_block_x``."""
    xpair, _, qkvp, pos = pair_args(dtype)
    x1, x2 = xpair[:, 0].contiguous(), xpair[:, 1].contiguous()
    f = te.fused_essential_block_x(x1, x2, qkvp, pos, HEADS)
    check_arity(fake_lib)
    args = dict(fake_lib.calls)["rp_essential_block_x"]
    # x1, x2, w, b, pos, F, qkv, ws; B, N, C, heads, flags, bf16; stream
    assert args[:2] == (x1.data_ptr(), x2.data_ptr())
    assert args[5] == f.data_ptr()
    assert args[8:16] == (B, N, C, HEADS, 1, 0, 0,
                          int(dtype == torch.bfloat16))
    check_workspace(fake_lib, "rp_essential_block_workspace", args, 7, True,
                    dtype == torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("has_pos,cross,single", VARIANTS, ids=VARIANT_IDS)
def test_bwd_route(fake_lib, has_pos, cross, single, dtype):
    """#6: qkv, dF and the buffers each variant needs."""
    rng = np.random.default_rng(8)
    qkv = _n(rng, B, 2, N, 3 * C).to(dtype)
    e = 64 + 6 * has_pos
    df = _n(rng, B, 2, HEADS, e, e)
    pos = _n(rng, B, N, 6).to(dtype) if has_pos else None
    dqkv, dpos = te.fused_essential_block_bwd(
        qkv, pos, df, HEADS, cross_features=cross, use_single_softmax=single)
    check_arity(fake_lib)
    assert fake_lib.names() == ["rp_essential_block_bwd_workspace",
                                "rp_essential_block_bwd"]
    args = fake_lib.calls[1][1]
    # qkv, pos, dF, dqkv, dva, dpos_part, ws; B, N, C, heads, flags, bf16
    assert args[0] == qkv.data_ptr() and args[2] == df.data_ptr()
    assert args[3] == dqkv.data_ptr()
    assert (args[4] is None) == (not cross)
    assert (args[5] is None) == (not has_pos) == (dpos is None)
    assert args[7:15] == (B, N, C, HEADS, int(has_pos), int(single),
                          int(cross), int(dtype == torch.bfloat16))
    # the tensor-core passes' statistics and operand rows, both dtypes
    check_workspace(fake_lib, "rp_essential_block_bwd_workspace", args, 6,
                    has_pos, dtype == torch.bfloat16)
    assert dqkv.shape == qkv.shape and dqkv.dtype == dtype
    if has_pos:
        assert dpos.shape == (B, 2, HEADS, N, 6)


def test_workspace_buffer_has_the_answered_size(fake_lib, monkeypatch):
    """The buffer handed on is a uint8 tensor of the answered size."""
    sizes = []
    real = torch.empty

    def empty(*shape, **kw):
        t = real(*shape, **kw)
        if kw.get("dtype") == torch.uint8:
            sizes.append(t.numel())
        return t
    monkeypatch.setattr(te.torch, "empty", empty)
    xpair, ln, qkvp, pos = pair_args(torch.bfloat16)
    te.fused_essential_block_pair(xpair, ln, qkvp, pos, HEADS)
    assert sizes == [WS_BYTES]


# ------------------------------------------------------------- checks --

@pytest.mark.parametrize("which", ["pair", "x", "block", "bwd"])
@pytest.mark.parametrize("dtype,b,ok", [
    (torch.bfloat16, 65535 // (2 * HEADS), True),
    (torch.bfloat16, 65535 // (2 * HEADS) + 1, False),
    (torch.float32, 65535 // (2 * HEADS), True),
    (torch.float32, 65535 // (2 * HEADS) + 1, False)])
def test_slice_limit(fake_lib, which, dtype, b, ok):
    """At most 65,535 slices (2 B heads) in the grid, either dtype."""
    n = 1
    if which in ("pair", "x"):
        xpair = torch.empty((b, 2, n, C), dtype=dtype)
        ln = (torch.ones(C), torch.zeros(C))
        qkvp = (torch.zeros(3 * C, C), torch.zeros(3 * C))
        if which == "pair":
            call = lambda: te.fused_essential_block_pair(xpair, ln, qkvp,
                                                         None, HEADS)
        else:
            x1, x2 = xpair[:, 0].contiguous(), xpair[:, 1].contiguous()
            call = lambda: te.fused_essential_block_x(x1, x2, qkvp, None,
                                                      HEADS)
    elif which == "block":
        q = torch.empty((b, n, 3 * C), dtype=dtype)
        call = lambda: te.fused_essential_block(q, q, None, HEADS)
    else:
        qkv = torch.empty((b, 2, n, 3 * C), dtype=dtype)
        df = torch.zeros((b, 2, HEADS, 64, 64))
        call = lambda: te.fused_essential_block_bwd(qkv, None, df, HEADS)
    if ok:
        call()
        assert fake_lib.calls
    else:
        with pytest.raises(ValueError, match="65535"):
            call()
        assert fake_lib.calls == []


@pytest.mark.parametrize("dtype,rows_per_tile", [(torch.bfloat16, 128),
                                                 (torch.float32, 128)])
def test_gemm_row_tile_limit(fake_lib, monkeypatch, dtype, rows_per_tile):
    """The qkv GEMM's limits on 2 B N rows, the same in both dtypes: the
    dtype's GEMM body (gemm_wgmma.cuh in bf16, gemm_wgmma_f32.cuh in fp32)
    is a persistent launch of ``rows_per_tile``-row tiles (BM = 64 kWG, two
    consumer warpgroups) with no grid row per tile, so #2 at the rows of
    65,536 row tiles reaches its launch (meta tensors: no memory), and the
    limit is a C int's 2^31 - 1 rows (checked on ``_check_grid`` itself: a
    tensor of that many rows does not fit a CPU test)."""
    header = {torch.bfloat16: "gemm_wgmma.cuh",
              torch.float32: "gemm_wgmma_f32.cuh"}[dtype]
    text = (CSRC / header).read_text()
    assert "static constexpr int BM = 64 * kWG;" in text
    assert "kWG = OP == kOpDw ? 1 : 2;" in text
    assert rows_per_tile == 64 * 2
    n = 65535 * rows_per_tile // 2 + 1      # once one tile too many, B = 1
    monkeypatch.setattr(te, "_KERNEL_DEVICE", "meta")
    meta = torch.device("meta")
    xpair = torch.empty((1, 2, n, C), dtype=dtype, device=meta)
    ln = (torch.ones(C, device=meta), torch.zeros(C, device=meta))
    qkvp = (torch.zeros(3 * C, C, device=meta),
            torch.zeros(3 * C, device=meta))
    before = te.fused_essential_block_pair.launches
    f = te.fused_essential_block_pair(xpair, ln, qkvp, None, HEADS)
    assert f.shape == (1, 2, HEADS, 64, 64) and f.device == meta
    assert te.fused_essential_block_pair.launches == before + 1
    (name, args), = [c for c in fake_lib.calls
                     if c[0] == "rp_essential_block_pair"]
    assert args[10:14] == (1, n, C, HEADS)
    assert args[-2] == int(dtype == torch.bfloat16)
    te._check_grid("pair", 1, HEADS, te.MAX_INT)
    with pytest.raises(ValueError, match="GEMM row"):
        te._check_grid("pair", 1, HEADS, te.MAX_INT + 1)


@pytest.mark.parametrize("case,exc", [
    ("float16", TypeError), ("width", ValueError),
    ("not contiguous", ValueError), ("pos shape", ValueError),
    ("dF shape", ValueError), ("dF dtype", ValueError)])
def test_input_checks_raise_before_any_launch(fake_lib, case, exc):
    xpair, ln, qkvp, pos = pair_args(torch.bfloat16)
    rng = np.random.default_rng(9)
    qkv = _n(rng, B, 2, N, 3 * C).to(torch.bfloat16)
    df = _n(rng, B, 2, HEADS, 70, 70)
    heads = HEADS
    if case == "float16":
        xpair, qkv = xpair.half(), qkv.half()
    elif case == "width":
        heads = HEADS + 1                   # C = 192 is not 64 * 4
    elif case == "not contiguous":
        xpair = xpair.transpose(2, 3).contiguous().transpose(2, 3)
        qkv = qkv.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "pos shape":
        pos = pos[:, :-1]
    elif case == "dF shape":
        df = df[..., :64, :64]
    else:
        df = df.double()
    counters = (te.fused_essential_block_pair.launches,
                te.fused_essential_block_bwd.launches)
    if not case.startswith("dF"):
        with pytest.raises(exc):
            te.fused_essential_block_pair(xpair, ln, qkvp, pos, heads)
    with pytest.raises(ValueError if exc is TypeError else exc):
        te.fused_essential_block_bwd(qkv, pos.to(qkv.dtype), df, heads)
    assert fake_lib.calls == []
    assert counters == (te.fused_essential_block_pair.launches,
                        te.fused_essential_block_bwd.launches)


@pytest.mark.parametrize("which", ["block", "bwd"])
def test_unaligned_bf16_operand_raises(fake_lib, which):
    """The bf16 kernels read 16-byte rows: an operand that starts off a
    16-byte boundary (a view one element in) raises before any launch."""
    rng = np.random.default_rng(13)
    flat = _n(rng, 2 * B * N * 3 * C + 1).to(torch.bfloat16)
    qkv = flat[1:].view(B, 2, N, 3 * C)
    assert qkv.is_contiguous() and qkv.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        if which == "block":
            q1 = flat[1:1 + B * N * 3 * C].view(B, N, 3 * C)
            te.fused_essential_block(q1, q1, None, HEADS)
        else:
            te.fused_essential_block_bwd(
                qkv, None, _n(rng, B, 2, HEADS, 64, 64), HEADS)
    assert fake_lib.calls == []


def test_unaligned_fp32_operand_raises(fake_lib):
    """fp32 operands load as 16-byte rows too (four values a cp.async): a
    view one element in raises before any launch, forward and backward."""
    rng = np.random.default_rng(14)
    flat = _n(rng, 2 * B * N * 3 * C + 1)
    qkv = flat[1:].view(B, 2, N, 3 * C)
    q1 = flat[1:1 + B * N * 3 * C].view(B, N, 3 * C)
    assert qkv.is_contiguous() and qkv.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        te.fused_essential_block(q1, q1, None, HEADS)
    with pytest.raises(ValueError, match="16-byte"):
        te.fused_essential_block_bwd(
            qkv, None, _n(rng, B, 2, HEADS, 64, 64), HEADS)
    assert fake_lib.calls == []


def test_counters_rise_once_per_launch(fake_lib):
    xpair, ln, qkvp, pos = pair_args(torch.bfloat16)
    rng = np.random.default_rng(10)
    qkv = _n(rng, B, 2, N, 3 * C).to(torch.bfloat16)
    df = _n(rng, B, 2, HEADS, 70, 70)
    ops = (te.fused_essential_block_pair, te.fused_essential_block_x,
           te.fused_essential_block, te.fused_essential_block_bwd)
    before = [op.launches for op in ops]
    te.fused_essential_block_pair(xpair, ln, qkvp, pos, HEADS)
    te.fused_essential_block_x(xpair[:, 0].contiguous(),
                               xpair[:, 1].contiguous(), qkvp, pos, HEADS)
    te.fused_essential_block(qkv[:, 0].contiguous(), qkv[:, 1].contiguous(),
                             pos, HEADS)
    te.fused_essential_block_bwd(qkv, pos.to(qkv.dtype), df, HEADS)
    assert [op.launches - b for op, b in zip(ops, before)] == [1, 1, 1, 1]


def test_failed_launch_raises_and_does_not_count(fake_lib):
    fake_lib.err = 1
    xpair, ln, qkvp, pos = pair_args(torch.bfloat16)
    rng = np.random.default_rng(11)
    qkv = _n(rng, B, 2, N, 3 * C).to(torch.bfloat16)
    df = _n(rng, B, 2, HEADS, 70, 70)
    before = (te.fused_essential_block_pair.launches,
              te.fused_essential_block_bwd.launches)
    with pytest.raises(RuntimeError, match="rp_essential_block_pair"):
        te.fused_essential_block_pair(xpair, ln, qkvp, pos, HEADS)
    with pytest.raises(RuntimeError, match="rp_essential_block_bwd"):
        te.fused_essential_block_bwd(qkv, pos.to(qkv.dtype), df, HEADS)
    assert before == (te.fused_essential_block_pair.launches,
                      te.fused_essential_block_bwd.launches)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_tensors_take_the_plain_versions(monkeypatch, dtype):
    """No library is loaded for CPU tensors and no counter moves."""
    def no_library():
        raise AssertionError("kernel library loaded for CPU tensors")
    monkeypatch.setattr(_build, "library", no_library)
    xpair, ln, qkvp, pos = pair_args(dtype)
    rng = np.random.default_rng(12)
    qkv = _n(rng, B, 2, N, 3 * C).to(dtype)
    df = _n(rng, B, 2, HEADS, 70, 70)
    before = (te.fused_essential_block_pair.launches,
              te.fused_essential_block_bwd.launches)
    torch.testing.assert_close(
        te.fused_essential_block_pair(xpair, ln, qkvp, pos, HEADS),
        te.essential_block_pair_reference(xpair, ln, qkvp, pos, HEADS),
        rtol=0, atol=0)
    got = te.fused_essential_block_bwd(qkv, pos, df, HEADS)
    want = te.essential_block_bwd_reference(qkv, pos, df, HEADS)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert before == (te.fused_essential_block_pair.launches,
                      te.fused_essential_block_bwd.launches)


# --------------------------------------- the tensor-core decomposition --

TILE = 64
SCALE = np.float32(0.125) * np.float32(LOG2E)   # kEbScale, in fp32


def _slices(qkv, pos, heads, cross):
    """q, k (G, N, 64), vb, va (G, N, e) in fp32 over the G = 2 B heads
    slices in the kernels' order (pair, direction, head); direction 0
    takes q from image 2."""
    q, k, v = te._split(qkv, pos, heads)          # (B, img, h, N, .)
    flat = lambda t: t.flatten(0, 2)
    va = v.flip(1) if cross else v
    return flat(q.flip(1)), flat(k), flat(v), flat(va)


def _online_stats(s):
    """Per row of s (G, rows, cols): the max m over the columns and 1 /
    sum exp2(s - m), the sum merged online over 64-column tiles (rescaled
    whenever the max grows), as eb_stats_kernel does."""
    m = torch.full(s.shape[:2], -float("inf"))
    l = torch.zeros(s.shape[:2])
    for c0 in range(0, s.shape[2], TILE):
        blk = s[..., c0:c0 + TILE]
        mn = torch.maximum(m, blk.amax(-1))
        l = l * torch.exp2(m - mn) + torch.exp2(blk - mn[..., None]).sum(-1)
        m = mn
    return m, 1.0 / l


def _exact_stats(s):
    """Per row of s (G, rows, cols): the exact max m, then 1 / sum
    T(exp2(s - m)) in fp32 (bf16 T), as eb_stats_kernel's second walk sums
    them on the tensor cores (kEbMxuSums)."""
    m = s.amax(-1)
    e = torch.exp2(s - m[..., None]).bfloat16().float()
    return m, 1.0 / e.sum(-1)


def tc_slice_moments(q, k, va, vb, scale, mode, cdt, mm=torch.matmul):
    """F (G, e, e) as the tensor-core moments compute it (essential_tc.cuh)
    on fp32 slices q, k (G, N, 64), va, vb (G, N, e) holding values of T =
    cdt, with fp32 sums and every product through ``mm``; ``scale`` the
    softmax scale times log2e in fp32; ``mode`` "dual", "single", or #9's
    "bf16_mul" (P = T(T(er) T(ec))) and "mxu_sums" (the same P, lr and lc
    summed over T(er), T(ec) against exact maxima)."""
    rnd = lambda t: t.to(cdt).float()
    hmul = mode in ("bf16_mul", "mxu_sums")
    n = q.shape[1]
    s = mm(q, k.transpose(1, 2)) * scale                     # (G, N, N)
    if mode == "single":
        vbn = vb
    else:
        stats = _exact_stats if mode == "mxu_sums" else _online_stats
        mc, lcinv = stats(s.transpose(1, 2))               # key statistics
        vbn = rnd(vb * lcinv[..., None])
    mr = s.amax(-1)                                       # the max pass
    f = 0.0
    for i0 in range(0, n, TILE):                          # query tiles
        o, lr = 0.0, 0.0
        for j0 in range(0, n, TILE):                      # key tiles
            blk = s[:, i0:i0 + TILE, j0:j0 + TILE]
            er = torch.exp2(blk - mr[:, i0:i0 + TILE, None])
            lr = lr + (rnd(er) if mode == "mxu_sums" else er).sum(-1)
            if mode == "single":
                p = er
            else:
                ec = torch.exp2(blk - mc[:, None, j0:j0 + TILE])
                p = rnd(er) * rnd(ec) if hmul else er * ec
            o = o + mm(rnd(p), vbn[:, j0:j0 + TILE])
        av = rnd(o * (1.0 / lr)[..., None])
        f = f + mm(va[:, i0:i0 + TILE].transpose(1, 2), av)
    return f


def mirror_matmul(cdt):
    """The kernels' product in T = cdt: bf16 operands multiply exactly in
    fp32, fp32 ones as 3xTF32 (``tf32x3_matmul``)."""
    return tf32x3_matmul if cdt == torch.float32 else torch.matmul


def tc_moments_mirror(qkv, pos, heads, cross, single, mm=None):
    """F (B, 2, heads, e, e) as the kernels compute it (essential_tc.cuh),
    on qkv (B, 2, N, 3C) in T with fp32 sums; every product through ``mm``
    (by default :func:`mirror_matmul`)."""
    q, k, vb, va = _slices(qkv, pos, heads, cross)
    f = tc_slice_moments(q, k, va, vb, SCALE,
                         "single" if single else "dual", qkv.dtype,
                         mm or mirror_matmul(qkv.dtype))
    return f.view(qkv.shape[0], 2, heads, *f.shape[1:])


def _pass(rows, grad, single, own, walk, scale, sigma, mm):
    """One pass of eb_bwd_pass_kernel over (own 64-row tile, walked tile)
    pairs: ``own`` = (X, Y, stats, the rounding to T), ``walk`` = (X, Y,
    Z, stats) with
    stats (m, 1/l, reduction) per row of that side; rows = the own side is
    the queries; s = X Xw^T scale, ds rounded after the factor sigma; every
    product through ``mm``.
    REDUCE returns the own reduction (rho or gamma), GRAD (out1, out2)."""
    (ox, oy, ost, rnd), (wx, wy, wz, wst) = own, walk
    G, n, _ = ox.shape
    red = torch.zeros(G, n)
    out1 = torch.zeros(G, n, wx.shape[-1])
    out2 = torch.zeros(G, n, wz.shape[-1])
    for r0 in range(0, n, TILE):
        r = slice(r0, r0 + TILE)
        for w0 in range(0, n, TILE):
            w = slice(w0, w0 + TILE)
            s = mm(ox[:, r], wx[:, w].transpose(1, 2)) * scale
            d = mm(oy[:, r], wy[:, w].transpose(1, 2))
            po = (torch.exp2(s - ost[0][:, r, None]) * ost[1][:, r, None]
                  if ost is not None else None)
            pw = (torch.exp2(s - wst[0][:, None, w]) * wst[1][:, None, w]
                  if wst is not None else None)
            R, Cm = (po, pw) if rows else (pw, po)
            if not grad:
                if single:
                    t = d * R
                else:
                    t = (d * Cm) * R if rows else (d * R) * Cm
                red[:, r] += t.sum(-1)
                continue
            ored = ost[2][:, r, None] if ost is not None else None
            wred = wst[2][:, None, w] if wst is not None else None
            rho = ored if rows else wred
            if single:
                ds, A = R * (d - rho), R
            else:
                gam = wred if rows else ored
                ds = R * (d * Cm - rho) + Cm * (d * R - gam)
                A = R * Cm
            out1[:, r] += mm(rnd(ds * sigma), wx[:, w])
            out2[:, r] += mm(rnd(A), wz[:, w])
    return red if not grad else (out1, out2)


def tc_slice_bwd(q, k, va, vb, df, scale, sigma, single, cdt,
                 mm=torch.matmul):
    """(dq, dk, dva, dvb) in fp32, before their last rounding, as the
    tensor-core passes compute them (essential_tc_bwd.cuh) on fp32 slices
    q, k (G, N, 64), va, vb (G, N, e) holding values of T = cdt and dF (G,
    e, e), every product through ``mm``; ``scale`` sigma log2e in fp32,
    sigma the softmax scale."""
    rnd = lambda t: t.to(cdt).float()
    s = mm(q, k.transpose(1, 2)) * scale
    mr, lrinv = _online_stats(s)
    qst = [mr, lrinv, None]
    kst = None if single else [*_online_stats(s.transpose(1, 2)), None]
    dfb = rnd(df)
    vbdft = rnd(mm(vb, dfb.transpose(1, 2)))                # the prologue
    vadf = rnd(mm(va, dfb))
    own_q = lambda st: (q, vadf, st, rnd)
    own_k = lambda st: (k, vb, st, rnd)
    args = (scale, sigma, mm)
    if not single:                                        # gamma, rho
        kst[2] = _pass(False, False, single, own_k(kst),
                       (q, vadf, vadf, qst), *args)
    qst[2] = _pass(True, False, single, own_q(qst), (k, vb, vbdft, kst),
                   *args)
    dq, dva = _pass(True, True, single, own_q(qst), (k, vb, vbdft, kst),
                    *args)
    dk, dvb = _pass(False, True, single, own_k(kst), (q, vadf, vadf, qst),
                    *args)
    return dq, dk, dva, dvb


def tc_bwd_mirror(qkv, pos, df, heads, cross, single, mm=None):
    """(dqkv (B, 2, N, 3C) in T, dpos_part (B, 2, h, N, 6) fp32 or None)
    as the tensor-core passes compute them (essential_tc_bwd.cuh), with
    the wrapper's add of the cross features' dva in T; every product
    through ``mm`` (by default :func:`mirror_matmul`)."""
    cdt = qkv.dtype
    rnd = lambda t: t.to(cdt).float()
    q, k, vb, va = _slices(qkv, pos, heads, cross)
    G, n, e = vb.shape
    dq, dk, dva, dvb = tc_slice_bwd(q, k, va, vb, df.reshape(G, e, e),
                                    SCALE, 0.125, single, cdt,
                                    mm or mirror_matmul(cdt))
    B_ = qkv.shape[0]
    shape = lambda t: t.view(B_, 2, heads, n, t.shape[-1])
    dq, dk, dva, dvb = map(shape, (dq, dk, dva, dvb))
    d = 64
    if cross:
        dv = rnd(rnd(dvb[..., :d]) + rnd(dva.flip(1)[..., :d]))
    else:
        dv = dvb[..., :d] + dva[..., :d]
    dpos = dvb[..., d:] + dva[..., d:]
    dqkv = torch.stack([dq.flip(1), dk, dv], 2).permute(0, 1, 4, 2, 3, 5)
    return (dqkv.reshape(B_, 2, n, 3 * heads * d).to(cdt),
            dpos if pos is not None else None)


MIRROR_CASES = [(64, True, False, False), (100, True, False, False),
                (100, False, True, True), (100, True, True, False),
                (576, True, False, False)]
MIRROR_IDS = [f"N={n}-{'pos' if p else 'nopos'}-"
              f"{'cross' if x else 'self'}-{'single' if s else 'dual'}"
              for n, p, x, s in MIRROR_CASES]
FWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _mirror_inputs(n, has_pos, heads=1, b=1):
    rng = np.random.default_rng(n + 3 * has_pos)
    e = 64 + 6 * has_pos
    return (_n(rng, b, 2, n, 3 * 64 * heads, scale=1.5), _n(rng, b, n, 6),
            _n(rng, b, 2, heads, e, e, scale=0.1))


def _normrel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,has_pos,cross,single", MIRROR_CASES,
                         ids=MIRROR_IDS)
def test_moments_mirror_matches_pallas(n, has_pos, cross, single, dtype):
    """The forward decomposition against #4 in interpret mode and the
    port's plain version, F relative to max|F|."""
    qkv, pos, _ = _mirror_inputs(n, has_pos)
    jdt = "bfloat16" if dtype == torch.bfloat16 else "float32"
    jq = jnp.asarray(qkv.numpy()).astype(jdt)
    want = np.asarray(_essential_block_call(
        jq[:, 0], jq[:, 1], jnp.asarray(pos.numpy()).astype(jdt), 1, cross,
        single, has_pos, interpret=True))
    t = qkv.to(dtype)
    p = pos if has_pos else None
    got = tc_moments_mirror(t, p, 1, cross, single)
    plain = te.essential_block_reference(t[:, 0], t[:, 1], p, 1, cross,
                                         single)
    for ref in (want, plain.numpy()):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=FWD_TOL[dtype] * np.abs(ref).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,has_pos,cross,single", MIRROR_CASES,
                         ids=MIRROR_IDS)
def test_bwd_mirror_matches_pallas(n, has_pos, cross, single, dtype):
    """The backward decomposition (statistics, prologue, rho / gamma, the
    two gradient passes with their sides swapped) against the Pallas
    backward in interpret mode and the port's plain version, per q, k, v
    slot and the positional cotangent."""
    qkv, pos, df = _mirror_inputs(n, has_pos)
    jdt = "bfloat16" if dtype == torch.bfloat16 else "float32"
    jq = jnp.asarray(qkv.numpy()).astype(jdt)
    want1, want2, want_pos = essential_block_bwd_call(
        jq[:, 0], jq[:, 1], jnp.asarray(pos.numpy()).astype(jdt),
        jnp.asarray(df.numpy()), 1, cross, single, has_pos, interpret=True)
    t = qkv.to(dtype)
    p = pos.to(dtype) if has_pos else None
    got, got_pos = tc_bwd_mirror(t, p, df, 1, cross, single)
    plain, plain_pos = te.essential_block_bwd_reference(t, p, df, 1, cross,
                                                        single)
    assert got.dtype == dtype and got.shape == qkv.shape
    for img, want in ((0, want1), (1, want2)):
        for slot in range(3):
            sl = slice(slot * 64, (slot + 1) * 64)
            for ref in (np.asarray(want, np.float32)[..., sl],
                        plain[:, img, :, sl].float()):
                assert _normrel(got[:, img, :, sl].float(), ref) \
                    <= BWD_TOL[dtype], (img, slot)
    if has_pos:
        assert _normrel(te.sum_dpos(got_pos),
                        np.asarray(want_pos, np.float32)) <= BWD_TOL[dtype]
        assert _normrel(got_pos, plain_pos) <= BWD_TOL[dtype]
    else:
        assert got_pos is None


# ---------------------------------------------- the fp32 float64 bar --

def tf32_matmul(a, b):
    """One TF32 product (hi . hi) in fp32: what 3xTF32 is not."""
    return torch.matmul(tf32_rna(a), tf32_rna(b))


def f64_errors(n, has_pos, cross, single, mm=None):
    """{output: (the mirror's max |err|, the fp32 plain version's)} from
    the moments run in float64 (``chip_smoke.essential_f64``, gradients by
    autograd) on one pair of N = n, for F, dq, dk, dv and, with positions,
    dpos (per slice)."""
    qkv, pos, df = _mirror_inputs(n, has_pos)
    pos = pos if has_pos else None
    f = tc_moments_mirror(qkv, pos, 1, cross, single, mm)
    dqkv, dpos = tc_bwd_mirror(qkv, pos, df, 1, cross, single, mm)
    pf = te.essential_block_reference(qkv[:, 0], qkv[:, 1], pos, 1, cross,
                                      single)
    pqkv, ppos = te.essential_block_bwd_reference(qkv, pos, df, 1, cross,
                                                  single)
    leaves = [qkv.double().requires_grad_()]
    if has_pos:
        leaves.append(pos.double()[:, None, None].expand(1, 2, 1, n, 6)
                      .clone().requires_grad_())
    f64 = chip_smoke.essential_f64(leaves[0], leaves[1] if has_pos else None,
                                   1, cross, single)
    g64 = torch.autograd.grad((f64 * df.double()).sum(), leaves)
    rows = {"F": (f, pf, f64.detach())}
    for i, part in enumerate(("dq", "dk", "dv")):
        sl = slice(64 * i, 64 * (i + 1))
        rows[part] = (dqkv[..., sl], pqkv[..., sl], g64[0][..., sl])
    if has_pos:
        rows["dpos"] = (dpos, ppos, g64[1])
    err = lambda t, ref: (t.double() - ref).abs().max().item()
    return {part: (err(got, ref), err(plain, ref))
            for part, (got, plain, ref) in rows.items()}


@pytest.mark.parametrize("has_pos,cross,single", VARIANTS, ids=VARIANT_IDS)
def test_fp32_mirror_within_float64_bar(has_pos, cross, single):
    """The fp32 mirror (3xTF32 products) at N = 576, one pair: its max
    |err| from float64 at most ``chip_smoke.F64_BAR`` (2) times the fp32
    plain version's, per output."""
    for part, (got, plain) in f64_errors(576, has_pos, cross,
                                         single).items():
        assert got <= chip_smoke.F64_BAR * plain, (part, got, plain)


def test_tf32_mirror_fails_float64_bar():
    """The same mirror with single TF32 products (hi . hi, about 3 decimal
    digits) is far outside the bar, for every output: the bar tells TF32
    from 3xTF32."""
    for part, (got, plain) in f64_errors(576, True, False, False,
                                         tf32_matmul).items():
        assert got > 10 * chip_smoke.F64_BAR * plain, (part, got, plain)
