"""PyTorch port: the bf16 GEMM body of kernels #1 and #5
(``csrc/gemm_wgmma.cuh``) as far as the CPU can check it.

  * (a) the descriptor walk: a numpy model of what the producer's TMA boxes
    write into shared memory (the 128-byte swizzle) and of the addresses
    wgmma reads through the kernel's shared-memory descriptors (start
    address, LBO, SBO, the per-16-deep-step advance), for the three
    operand layouts -- K-major (the forward's A and W, dX's dY'), MN-major
    B (dX's W, dW's X) and MN-major A (dW's dY'^T) -- at N = 64 and 192:
    every element each step reads is the one the product needs.  The
    constants and the transpose bits are read out of the headers;
  * (b) the route: with a stand-in for the kernel library, ``vit_gemm``
    (``ops/vit_gemm.py``, the test-only entry ``rp_gemm_bf16``) passes as
    many arguments as the C signature has, with common.cuh's epilogue
    codes, and adds one to its counter per launch; its shape and
    alignment checks, and the ViT stack's new bf16 ones, raise before any
    launch; CPU tensors take the plain version, which agrees with the JAX
    package's products (``jnp.dot`` in fp32, ``kernel_gelu``).

The kernels run only on the card (``chip_smoke.py`` phase 5f holds each
GEMM to its plain version, phases 3 and 3b the stacks).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rel_pose_tpu.ops.kernel_gelu import kernel_gelu, kernel_gelu_grad
from rel_pose_tpu_torch.ops import _build
from rel_pose_tpu_torch.ops import vit_gemm as vg
from rel_pose_tpu_torch.ops import vit_stack as tv

CSRC = Path(__file__).resolve().parent.parent / "rel_pose_tpu_torch" / "csrc"
SM90 = (CSRC / "sm90.cuh").read_text()
GEMM = (CSRC / "gemm_wgmma.cuh").read_text()
COMMON = (CSRC / "common.cuh").read_text()


def _const(text, name):
    """The value of ``constexpr int name = <expr>;`` in a header, its
    expression evaluated over the constants already read."""
    expr = re.search(rf"constexpr int {name} = ([^;]+);", text).group(1)
    expr = expr.split("//")[0]
    env = {k: v for k, v in _CONSTS.items()}
    return int(eval(expr, {}, env))


_CONSTS = {}
for _name in ("kRowBytes", "kSbo", "kStepK", "kStepMN"):
    _CONSTS[_name] = _const(SM90, _name)
for _name in ("kGemmK", "kBox", "kWideN"):
    _CONSTS[_name] = _const(GEMM, _name)
ROW, SBO, STEP_K, STEP_MN = (_CONSTS[k] for k in ("kRowBytes", "kSbo",
                                                  "kStepK", "kStepMN"))
BOX, GEMM_K, WIDE_N = _CONSTS["kBox"], _CONSTS["kGemmK"], _CONSTS["kWideN"]


def _transposed(which, op):
    """The kernel's transpose bit of operand ``which`` ("A" or "B") for an
    op ("kOpFwd", "kOpDx", "kOpDw"), from GemmCfg's kTA / kTB."""
    m = re.search(rf"static constexpr int kT{which} = OP (==|!=) (kOp\w+);",
                  GEMM)
    return (op == m.group(2)) == (m.group(1) == "==")


def _n_consumers(op):
    m = re.search(r"static constexpr int kWG = OP == kOpDw \? (\d+) : (\d+);",
                  GEMM)
    return int(m.group(1) if op == "kOpDw" else m.group(2))


# ------------------------------------------------------- (a) descriptors --

def swizzle(addr):
    """The 128-byte swizzle on a shared-memory byte address: the 16-byte
    chunk index (bits 4-6) XOR the row within the 1024-byte atom (bits
    7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_write(smem, base, tile):
    """A TMA box of ``tile`` (rows, 64) bf16 elements written from byte
    ``base`` in the 128-byte swizzle: row r at r * 128, its 16-byte chunk
    c // 8 moved to chunk (c // 8) ^ (r % 8)."""
    rows, cols = tile.shape
    assert cols * 2 == ROW
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    off = base + r * ROW + (((c // 8) ^ (r % 8)) << 4) + (c % 8) * 2
    smem[off // 2] = tile


def desc(addr, lbo=None):
    """The kernel's descriptor (sm90.cuh ``desc``): start >> 4 in bits
    0-13, LBO >> 4 at 16, SBO >> 4 at 32, the 128-byte swizzle (1) at
    62."""
    lbo = SBO if lbo is None else lbo
    return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | \
        ((SBO >> 4) << 32) | (1 << 62)


def test_desc_is_the_headers():
    body = re.search(r"uint64_t desc\(uint32_t addr, uint32_t lbo = kSbo\) "
                     r"\{\s*return (.*?);\s*\}", SM90, re.S).group(1)
    body = " ".join(body.split())
    assert body == ("(uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> "
                    "4) << 16) | ((uint64_t)(kSbo >> 4) << 32) | "
                    "((uint64_t)1 << 62)")
    assert "d + (uint64_t)(kk * kStepK / 16)" in SM90
    assert "d + (uint64_t)(kk * kStepMN / 16)" in SM90
    # the B descriptor's LBO: the next 64-wide box of an MN-major operand
    assert "desc(sb, Cfg::kTB ? kBox : kSbo)" in GEMM


def wgmma_read(smem, d, rows, mn_major):
    """The (rows x 16) operand wgmma reads through descriptor ``d`` for one
    16-deep step, from the canonical layouts of the 128-byte swizzle:
    K-major, element (i, k) at start + (i // 8) SBO + (i % 8) 128 + 2 k;
    MN-major, at start + (i // 64) LBO + 2 (i % 64) + (k // 8) SBO +
    (k % 8) 128; the swizzle applied to the address."""
    assert d >> 62 == 1
    start = (d & 0x3FFF) << 4
    lbo = ((d >> 16) & 0x3FFF) << 4
    sbo = ((d >> 32) & 0x3FFF) << 4
    i, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    if mn_major:
        addr = start + (i // 64) * lbo + (i % 64) * 2 + (k // 8) * sbo \
            + (k % 8) * ROW
    else:
        addr = start + (i // 8) * sbo + (i % 8) * ROW + k * 2
    return smem[swizzle(addr) // 2]


def step(d, kk, mn_major):
    """The kernel's kmajor_step / mnmajor_step."""
    return d + kk * (STEP_MN if mn_major else STEP_K) // 16


def ids(rows, cols, seed):
    """A matrix of distinct element ids."""
    return np.random.default_rng(seed).permutation(rows * cols).reshape(
        rows, cols) + 1


@pytest.mark.parametrize("op", ["kOpFwd", "kOpDx", "kOpDw"])
def test_a_operand_walk(op):
    """A: the forward's and dX's K-major boxes of 64 rows a consumer (one
    box of 64 x kWG rows), dW's MN-major dY'^T box (rows of dY' are the
    sum index): every 16-deep step reads A[i, 16 kk + k]."""
    wgs = _n_consumers(op)
    mn = _transposed("A", op)
    assert mn == (op == "kOpDw")
    base = 3 * 1024 * 40   # a stage base: 1024-aligned
    smem = np.zeros(1 << 20, dtype=np.int64)
    M = 64 * wgs
    A = ids(M, GEMM_K, 1)            # the product's A (rows, K step)
    if mn:
        tma_write(smem, base, A.T.copy())   # the box holds dY'[k, n]
    else:
        tma_write(smem, base, A)
    for w in range(wgs):
        d = desc(base + w * BOX)
        for kk in range(GEMM_K // 16):
            got = wgmma_read(smem, step(d, kk, mn), 64, mn)
            np.testing.assert_array_equal(
                got, A[64 * w:64 * (w + 1), 16 * kk:16 * (kk + 1)])


@pytest.mark.parametrize("n", [64, 192])
@pytest.mark.parametrize("op", ["kOpFwd", "kOpDx", "kOpDw"])
def test_b_operand_walk(op, n):
    """B: the forward's K-major W box (N rows), dX's and dW's MN-major
    boxes (64 columns each, ``kBox`` apart: LBO): every 16-deep step reads
    B[j, 16 kk + k] for the N output columns j."""
    mn = _transposed("B", op)
    assert mn == (op != "kOpFwd")
    assert n in (64, WIDE_N)
    sb = 2 * BOX          # B follows the A boxes of the stage
    smem = np.zeros(1 << 20, dtype=np.int64)
    B = ids(n, GEMM_K, 2)            # (output column, sum index)
    if mn:
        for j in range(n // 64):     # box j: rows k, columns 64 j ..
            tma_write(smem, sb + j * BOX, B[64 * j:64 * (j + 1)].T.copy())
        d = desc(sb, BOX)
    else:
        tma_write(smem, sb, B)
        d = desc(sb)
    for kk in range(GEMM_K // 16):
        got = wgmma_read(smem, step(d, kk, mn), n, mn)
        np.testing.assert_array_equal(got, B[:, 16 * kk:16 * (kk + 1)])


def test_stage_bytes_are_the_boxes():
    """Each stage expects the bytes of its boxes: A (64 kWG rows) and B (N
    rows or N / 64 boxes of 64), 128 bytes a row."""
    assert BOX == 64 * ROW and GEMM_K * 2 == ROW
    assert "kABytes = kWG * kBox" in GEMM
    assert "kBBytes = BN / 64 * kBox" in GEMM
    assert "mbar_expect_tx(full, Cfg::kStageBytes)" in GEMM
    assert "gemm_map(&ma, A, M, K, 128)" in GEMM        # 2 consumers' rows
    assert "gemm_map(&mb, W, N, K, box_n)" in GEMM
    assert GEMM.count("gemm_map(&mb, W, K, N, 64)") == 1
    assert "gemm_map(&ma, dYb, M, Nout, 64)" in GEMM


# ------------------------------------------------------------ (b) route --

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
    monkeypatch.setattr(vg, "_KERNEL_DEVICE", "cpu")
    return lib


def _bf(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(torch.bfloat16)


def _f(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def test_epilogue_codes_are_common_cuh():
    enum = dict(re.findall(r"(k\w+) = (\d+),", COMMON))
    assert vg.FWD_EPILOGUES == {
        "bias": int(enum["kBias"]), "bias_gelu": int(enum["kBiasGelu"]),
        "bias_resid": int(enum["kBiasResid"]),
        "bias_gelu_split": int(enum["kBiasGeluSplit"])}
    assert vg.DX_EPILOGUES == {"plain": int(enum["kDxPlain"]),
                               "gelu_grad": int(enum["kDxGeluGrad"])}
    assert vg.DW_CHUNK == int(re.search(r"constexpr int kDwChunk = (\d+);",
                                        COMMON).group(1))
    assert "case 0:" in (CSRC / "gemm_wgmma.cu").read_text()


CASES = [
    ("fwd", "bias", dict(), 1),
    ("fwd", "bias_gelu", dict(), 1),
    ("fwd", "bias_resid", dict(resid=True), 1),
    ("fwd", "bias_gelu_split", dict(), 2),
    ("dx", "plain", dict(), 1),
    ("dx", "gelu_grad", dict(aux=True, outb=True), 2),
    ("dw", None, dict(dy=True), 2),
]


def _operands(op, M=100, N=192, K=64, **want):
    if op == "fwd":
        kw = {"bias": _f(N, seed=3)}
        a, b = _bf(M, K, seed=1), _bf(N, K, seed=2)
    elif op == "dx":
        kw = {}
        a, b = _bf(M, K, seed=1), _bf(K, N, seed=2)
    else:
        kw = {}
        a, b = _bf(M, N, seed=1), _bf(M, K, seed=2)
    if want.get("resid"):
        kw["resid"] = _bf(M, N, seed=4)
    if want.get("aux"):
        kw["aux"] = _f(M, N, seed=5)
    if want.get("dy"):
        kw["dy"] = _f(M, N, seed=6)
    if want.get("outb"):
        kw["outb"] = True
    return a, b, kw


@pytest.mark.parametrize("op,epi,want,n_out", CASES)
def test_launch_args_and_count(fake_lib, op, epi, want, n_out):
    """Past the CPU dispatch (``_launch``, the stand-in's device the CPU), each op
    reaches rp_gemm_bf16 with the signature's argument count, its op and
    epilogue codes and the sizes (M, N, K), and counts one launch."""
    a, b, kw = _operands(op, **want)
    before = vg.vit_gemm.launches
    out = vg._launch(op, epi, a, b, **kw)
    assert vg.vit_gemm.launches == before + 1
    (name, args), = fake_lib.calls
    assert name == "rp_gemm_bf16"
    assert len(args) == len(_build.SIGNATURES[name][0])
    codes = vg.FWD_EPILOGUES if op == "fwd" else vg.DX_EPILOGUES
    assert args[:2] == (vg.OPS[op], codes.get(epi, 0))
    M = a.shape[0]
    N = b.shape[0] if op == "fwd" else (b.shape[1] if op == "dx"
                                        else a.shape[1])
    K = b.shape[1] if op != "dx" else b.shape[0]
    assert args[-4:-1] == (M, N, K)
    assert len(out) == n_out
    assert args[2] == a.data_ptr() and args[3] == b.data_ptr()


@pytest.mark.parametrize("bad", ["width", "align", "dtype", "resid",
                                 "shape", "epilogue"])
def test_checks_raise_before_launch(fake_lib, bad):
    a, b, kw = _operands("fwd", resid=True)
    epi = "bias_resid"
    if bad == "width":
        a, b, kw = _operands("fwd", N=96, resid=True)
    elif bad == "align":
        a = torch.empty(100 * 64 + 1, dtype=torch.bfloat16)[1:].view(100, 64)
    elif bad == "dtype":
        a = a.float()
    elif bad == "resid":
        kw.pop("resid")
    elif bad == "shape":
        b = _bf(192, 128)
    else:
        epi = "rounded"
    before = vg.vit_gemm.launches
    with pytest.raises((ValueError, TypeError)):
        vg._launch("fwd", epi, a, b, **kw)
    assert fake_lib.calls == [] and vg.vit_gemm.launches == before


def test_vit_stack_bf16_alignment_raises_before_launch(monkeypatch):
    """The ViT stack's bf16 kernels take their GEMM operands by TMA: a
    token tensor off a 16-byte boundary raises before any launch.  fp32's
    forward takes it: only its LayerNorm reads the tokens, and its GEMMs
    take their operands by TMA from the kernels' own buffers (the tokens'
    and the weights' splits)."""
    lib = FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "prepare_launch", lambda device: 0)
    monkeypatch.setattr(tv, "_KERNEL_DEVICE", "cpu")
    C, depth, N = 64, 1, 8
    rng = np.random.default_rng(0)
    p = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for n, s in (("ln1_scale", (depth, C)), ("ln1_bias", (depth, C)),
                      ("qkv_w", (depth, 3 * C, C)), ("qkv_b", (depth, 3 * C)),
                      ("proj_w", (depth, C, C)), ("proj_b", (depth, C)),
                      ("ln2_scale", (depth, C)), ("ln2_bias", (depth, C)),
                      ("fc1_w", (depth, 4 * C, C)), ("fc1_b", (depth, 4 * C)),
                      ("fc2_w", (depth, C, 4 * C)), ("fc2_b", (depth, C)))}
    for dtype in (torch.bfloat16, torch.float32):
        q = {k: v.to(dtype) for k, v in p.items()}
        x = torch.empty(2 * N * C + 1, dtype=dtype)[1:].view(2, N, C)
        pos = torch.zeros((1, N, C), dtype=dtype)
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="16-byte"):
                tv._launch_forward(x, q, 1, pos, stash=False)
            assert lib.calls == []
        else:
            tv._launch_forward(x, q, 1, pos, stash=False)
            assert [n for n, _ in lib.calls] == ["rp_vit_stack"]


@pytest.mark.parametrize("op,epi,want,n_out", CASES)
def test_cpu_takes_the_plain_version(op, epi, want, n_out):
    a, b, kw = _operands(op, **want)
    before = vg.vit_gemm.launches
    out = vg.vit_gemm(op, epi, a, b, **kw)
    assert vg.vit_gemm.launches == before
    ref = vg.vit_gemm_reference(op, epi, a, b, **kw)
    assert len(out) == len(ref) == n_out
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=0)


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("op,epi,want,n_out", CASES)
def test_plain_version_is_the_pallas_products(op, epi, want, n_out):
    """The plain version against the Pallas kernels' own products
    (pallas_vit.py:129/242/264/272, pallas_vit_bwd.py:178-232): jnp.dot
    with fp32 sums of bf16 operands, the bias in fp32, kernel_gelu's tanh
    form and its gradient, the weight gradients as dot_general over the
    rows, the bias gradient the fp32 column sums.  Tolerance: the fp32
    sums in another order (1e-5 relative) and, on bf16 outputs, one bf16
    ulp (2^-8 relative) where a sum lands on a rounding boundary."""
    a, b, kw = _operands(op, **want)
    out = vg.vit_gemm_reference(op, epi, a, b, **kw)
    A, B = _jnp(a), _jnp(b)
    f32 = jnp.float32
    if op == "fwd":
        h = jnp.dot(A, B.T, preferred_element_type=f32) + _jnp(kw["bias"])
        if epi == "bias":
            want_out = [h.astype(jnp.bfloat16)]
        elif epi == "bias_gelu":
            want_out = [kernel_gelu(h.astype(jnp.bfloat16), True)]
        elif epi == "bias_resid":
            want_out = [(_jnp(kw["resid"]).astype(f32) + h)
                        .astype(jnp.bfloat16)]
        else:
            want_out = [kernel_gelu(h, True).astype(jnp.bfloat16), h]
    elif op == "dx":
        d = jnp.dot(A, B, preferred_element_type=f32)
        if epi == "gelu_grad":
            d = d * kernel_gelu_grad(_jnp(kw["aux"]), True)
        want_out = [d, d.astype(jnp.bfloat16)][:n_out]
    else:
        import jax
        dw = jax.lax.dot_general(A, B, (((0,), (0,)), ((), ())),
                                 preferred_element_type=f32)
        want_out = [dw, jnp.sum(_jnp(kw["dy"]), axis=0)]
    assert len(out) == len(want_out)
    for o, w in zip(out, want_out):
        tol = 2 ** -8 if o.dtype == torch.bfloat16 else 1e-5
        w = np.asarray(w.astype(f32))
        np.testing.assert_allclose(o.float().numpy(), w, rtol=tol,
                                   atol=tol * np.abs(w).max())
