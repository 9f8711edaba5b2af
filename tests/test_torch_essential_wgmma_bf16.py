"""PyTorch port: the bf16 essential block on wgmma (kernels #2, #3, #4 and
#6 in bf16, ``csrc/essential_wgmma.cuh``) as far as the CPU can check it.

A plain mirror of the new design, on bf16 values held in fp32 (bf16
products are exact in fp32; sums in fp32):

  * forward: the key statistics merged online over the query tiles of the
    transposed product, and beside them each query's max over every 64-key
    tile (the column maxima of the statistics' s^T tiles), merged by max
    into the exact row max -- then ONE walk over the key tiles: er, ec, P =
    T(er ec) against the final maxima, lr summed, o += P vb_n; av = T(o /
    lr), the tile's F partial va^T av, the partials summed in query-tile
    order;
  * backward: the query and key statistics, the prologue (T(vb T(dF)^T),
    T(va T(dF))), ONE pass over the query rows for rho (W's row sums) and
    gamma's per-query-tile partials (W's column sums), gamma summed in
    query-tile order, then the key rows' and the query rows' gradient
    passes (T(ds sigma), T(A)).

It is held to the Pallas kernels in interpret mode (``_essential_block_call``,
``essential_block_bwd_call``) and to the port's plain versions for the 8
flag sets at N = 100 (a ragged last tile) and 576, one pair, within
``chip_smoke.py``'s bf16 tolerances (F: max |err| <= ``F_RTOL`` max|ref|;
the backward: ||err|| / ||ref|| <= ``GRAD_NORMREL`` per q, k, v slot and
the positional cotangent).  The merged row max and P = T(er ec) equal,
bit for bit, those of the mma.sync design's two-walk mirror
(tests/test_torch_essential_route.py ``tc_slice_moments``), and so does F.

Then the tile layouts the new kernels add: a numpy model of the
core-matrix tiles that ``ewb_vbn_kernel`` and the prologue (``kTiled``)
write and of the addresses wgmma reads through the unswizzled descriptors
(``desc_e_kmajor``: an 80-deep K-major operand; ``desc_e_mnmajor``: vb_n's
72 columns and the passes' dva / dvb operands as an MN-major B), with the
constants read out of the header.  The kernels themselves run only on the
card (``chip_smoke.py`` phase 3d).
"""

import re
from pathlib import Path

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_essential_route import (SCALE, TILE, VARIANT_IDS, VARIANTS,
                                        _mirror_inputs, _normrel,
                                        _online_stats, _pass, _slices,
                                        tc_slice_moments)
from test_torch_essential_wgmma_f32 import _reduce_pass

from rel_pose_tpu.ops.pallas_essential_block import _essential_block_call
from rel_pose_tpu.ops.pallas_essential_block_bwd import \
    essential_block_bwd_call
from rel_pose_tpu_torch.ops import essential_block as te

CSRC = Path(__file__).resolve().parent.parent / "rel_pose_tpu_torch" / "csrc"
WB = (CSRC / "essential_wgmma.cuh").read_text()
BWD = (CSRC / "essential_tc_bwd.cuh").read_text()
BF16 = torch.bfloat16
F_RTOL = chip_smoke.F_RTOL[BF16]
GRAD_NORMREL = chip_smoke.GRAD_NORMREL[BF16]
SIGMA = 0.125
RNG = np.random.default_rng(47)


def rnd(t):
    return t.to(BF16).float()


# ---------------------------------------------------------- the mirror --

def row_max_partials(s):
    """Each query's max over each 64-key tile, [(G, N) per key tile]: the
    column maxima of the key statistics' s^T tiles (keys past N are not
    in a tile)."""
    return [s[..., j0:j0 + TILE].amax(-1) for j0 in range(0, s.shape[-1],
                                                           TILE)]


def merged_row_max(s):
    """The moments kernel's merge of the partials: fmaxf over the key
    tiles."""
    parts = row_max_partials(s)
    m = parts[0]
    for p in parts[1:]:
        m = torch.maximum(m, p)
    return m


def wb_slice_moments(q, k, va, vb, single, with_p=False):
    """F (G, e, e) as the bf16 wgmma moments compute it on slices q, k (G,
    N, 64), va, vb (G, N, e) of bf16 values in fp32; with ``with_p`` also
    P = T(er ec) (G, N, N)."""
    n = q.shape[1]
    s = torch.matmul(q, k.transpose(1, 2)) * SCALE         # (G, N, N)
    m = merged_row_max(s)                                   # exact maxima
    if single:
        vbn = vb
    else:
        mc, lcinv = _online_stats(s.transpose(1, 2))        # key statistics
        vbn = rnd(vb * lcinv[..., None])
    f, ps = 0.0, []
    for i0 in range(0, n, TILE):                           # query tiles
        o, lr, row = 0.0, 0.0, []
        for j0 in range(0, n, TILE):                       # ONE key walk
            blk = s[:, i0:i0 + TILE, j0:j0 + TILE]
            er = torch.exp2(blk - m[:, i0:i0 + TILE, None])
            lr = lr + er.sum(-1)
            p = er if single else er * torch.exp2(
                blk - mc[:, None, j0:j0 + TILE])
            row.append(rnd(p))
            o = o + torch.matmul(rnd(p), vbn[:, j0:j0 + TILE])
        av = rnd(o * (1.0 / lr)[..., None])
        f = f + torch.matmul(va[:, i0:i0 + TILE].transpose(1, 2), av)
        ps.append(torch.cat(row, -1))
    return (f, torch.cat(ps, 1)) if with_p else f


def wb_moments_mirror(qkv, pos, heads, cross, single):
    """F (B, 2, heads, e, e) of bf16 qkv (B, 2, N, 3C) as the wgmma body
    computes it."""
    q, k, vb, va = _slices(qkv, pos, heads, cross)
    f = wb_slice_moments(q, k, va, vb, single)
    return f.view(qkv.shape[0], 2, heads, *f.shape[1:])


def wb_slice_bwd(q, k, va, vb, df, single):
    """(dq, dk, dva, dvb) in fp32, before their last rounding, as the bf16
    wgmma passes compute them: statistics, prologue, the merged rho / gamma
    pass, then the key rows' and the query rows' gradient passes."""
    mm = torch.matmul
    s = mm(q, k.transpose(1, 2)) * SCALE
    qst = [*_online_stats(s), None]
    kst = None if single else [*_online_stats(s.transpose(1, 2)), None]
    dfb = rnd(df)
    vbdft = rnd(mm(vb, dfb.transpose(1, 2)))                # the prologue
    vadf = rnd(mm(va, dfb))
    qst[2], gamma = _reduce_pass(q, k, vb, vadf, qst, kst, single, mm)
    if not single:
        kst[2] = gamma
    args = (SCALE, SIGMA, mm)
    dk, dvb = _pass(False, True, single, (k, vb, kst, rnd),
                    (q, vadf, vadf, qst), *args)
    dq, dva = _pass(True, True, single, (q, vadf, qst, rnd),
                    (k, vb, vbdft, kst), *args)
    return dq, dk, dva, dvb


def wb_bwd_mirror(qkv, pos, df, heads, cross, single):
    """(dqkv (B, 2, N, 3C) in bf16, dpos_part (B, 2, h, N, 6) fp32 or None)
    as the wgmma passes compute them: dv = T(dva + dvb), or with cross
    features each image's v = T(T(dvb) + T(dva)) (the wrapper's add)."""
    q, k, vb, va = _slices(qkv, pos, heads, cross)
    G, n, e = vb.shape
    dq, dk, dva, dvb = wb_slice_bwd(q, k, va, vb, df.reshape(G, e, e), single)
    B = qkv.shape[0]
    shape = lambda t: t.view(B, 2, heads, n, t.shape[-1])
    dq, dk, dva, dvb = map(shape, (dq, dk, dva, dvb))
    d = 64
    if cross:
        dv = rnd(rnd(dvb[..., :d]) + rnd(dva.flip(1)[..., :d]))
    else:
        dv = dva[..., :d] + dvb[..., :d]
    dpos = dva[..., d:] + dvb[..., d:]
    dqkv = torch.stack([dq.flip(1), dk, dv], 2).permute(0, 1, 4, 2, 3, 5)
    return (dqkv.reshape(B, 2, n, 3 * heads * d).to(BF16),
            dpos if pos is not None else None)


# ------------------------------------------------ against the references --

CASES = [(n, *v) for n in (100, 576) for v in VARIANTS]
CASE_IDS = [f"N={n}-{vid}" for n in (100, 576) for vid in VARIANT_IDS]


def _f_ok(got, ref):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(got, np.float32) - ref).max()
    return err <= F_RTOL * np.abs(ref).max(), err


@pytest.mark.parametrize("n,has_pos,cross,single", CASES, ids=CASE_IDS)
def test_wgmma_bf16_mirror_matches_pallas(n, has_pos, cross, single):
    """F and the backward of the bf16 wgmma design against #4 and #6 in
    interpret mode and against the port's plain versions, bf16 inputs."""
    qkv, pos, df = _mirror_inputs(n, has_pos)
    qkv, pos = qkv.to(BF16), pos.to(BF16)
    jq = jnp.asarray(qkv.float().numpy()).astype("bfloat16")
    jp = jnp.asarray(pos.float().numpy()).astype("bfloat16")
    p = pos if has_pos else None
    got_f = wb_moments_mirror(qkv, p, 1, cross, single)
    want_f = _essential_block_call(jq[:, 0], jq[:, 1], jp, 1, cross, single,
                                   has_pos, interpret=True)
    plain_f = te.essential_block_reference(qkv[:, 0], qkv[:, 1], p, 1, cross,
                                           single)
    for ref in (want_f, plain_f.numpy()):
        ok, err = _f_ok(got_f.numpy(), ref)
        assert ok, err
    want1, want2, want_pos = essential_block_bwd_call(
        jq[:, 0], jq[:, 1], jp, jnp.asarray(df.numpy()), 1, cross, single,
        has_pos, interpret=True)
    got, got_pos = wb_bwd_mirror(qkv, p, df, 1, cross, single)
    plain, plain_pos = te.essential_block_bwd_reference(qkv, p, df, 1, cross,
                                                        single)
    assert got.dtype == BF16 and got.shape == qkv.shape
    for img, want in ((0, want1), (1, want2)):
        for slot in range(3):
            sl = slice(slot * 64, (slot + 1) * 64)
            for ref in (np.asarray(want, np.float32)[..., sl],
                        plain[:, img, :, sl].float()):
                assert _normrel(got[:, img, :, sl].float(), ref) \
                    <= GRAD_NORMREL, (img, slot)
    if has_pos:
        assert _normrel(te.sum_dpos(got_pos),
                        np.asarray(want_pos, np.float32)) <= GRAD_NORMREL
        assert _normrel(got_pos, plain_pos) <= GRAD_NORMREL
    else:
        assert got_pos is None


@pytest.mark.parametrize("n,single", [(100, False), (576, False),
                                      (100, True)])
def test_merged_row_max_is_the_two_walk_max(n, single):
    """The row max merged from the key tiles' partials, P = T(er ec) and
    so F equal the two-walk mirror's (``tc_slice_moments``: a separate
    exact-max walk, then P and P vb_n) bit for bit: a max is exact in any
    order."""
    qkv, pos, _ = _mirror_inputs(n, True)
    q, k, vb, va = _slices(qkv.to(BF16), pos.to(BF16), 1, False)
    s = torch.matmul(q, k.transpose(1, 2)) * SCALE
    assert torch.equal(merged_row_max(s), s.amax(-1))
    f, p = wb_slice_moments(q, k, va, vb, single, with_p=True)
    mr = s.amax(-1)
    er = torch.exp2(s - mr[..., None])
    if not single:
        er = er * torch.exp2(s - _online_stats(s.transpose(1, 2))[0][:, None])
    assert torch.equal(p, rnd(er))
    want = tc_slice_moments(q, k, va, vb, SCALE,
                            "single" if single else "dual", BF16)
    assert torch.equal(f, want)


def test_row_max_partials_cover_every_key():
    """One partial per (key tile, query), each over that tile's keys only:
    a ragged last tile's partial is the max over its 36 keys."""
    s = torch.from_numpy(RNG.standard_normal((2, 100, 100)).astype(
        np.float32))
    parts = row_max_partials(s)
    assert len(parts) == 2 and parts[0].shape == (2, 100)
    assert torch.equal(parts[1], s[..., 64:].amax(-1))
    text = _squash(WB)
    # the statistics write one partial a (key tile, slice, query), the
    # moments kernel merges the key tiles' partials by fmaxf
    assert ("rpart[((size_t)blockIdx.x * G + g) * N + c0 + tid] = fmaxf("
            "fmaxf(CSs[tid], CSs[kT + tid]), fmaxf(CSs[2 * kT + tid], "
            "CSs[3 * kT + tid]));") in text
    assert ("v = fmaxf(v, __ldg(rmax + (((size_t)p * G + g) * N + row) * "
            "rstride));") in text
    assert "SINGLE ? ws.kstats : ws.rpart, SINGLE ? 1 : nt, SINGLE ? 3 : 1" \
        in text


# ------------------------------------------------------------ the layouts --

def _squash(text):
    return " ".join(text.split())


def _const(name):
    return re.search(rf"constexpr int {name} = ([^;]+);", WB)[1]


CORE = 64 * 16
assert _const("kCore") == "kT * 16"


def test_descriptors_are_the_header():
    """The unswizzled descriptors: start >> 4, LBO >> 4 at bit 16, SBO >> 4
    at bit 32, no swizzle bits; K-major over e LBO kCore (k8 columns), SBO
    128 (8-row groups); MN-major LBO 128 (8-row groups of the sum index),
    SBO kCore (8-column groups); k16 steps of two columns or two row
    groups."""
    text = _squash(WB)
    assert ("return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4)"
            " << 16) | ((uint64_t)(sbo >> 4) << 32);") in text
    assert "return desc_core(addr, kCore, 128);" in text
    assert "return desc_core(addr, 128, kCore);" in text
    assert _const("kStepE") == "2 * kCore / 16"
    assert _const("kStepMNE") == "2 * 128 / 16"
    assert "return E == kHeadDim ? kHeadDim : 72;" in text
    assert "static constexpr int kN = ewb_n(E);" in text
    assert "m64n72k16.f32.bf16.bf16" in WB
    # the register A products set the transpose bit of B (MN-major)
    assert re.search(r'%40, "\s*"1, 1, 1, 1;', WB)


def vbn_tiles(vbn, width):
    """``ewb_vbn_kernel``'s scratch of one slice (as bf16 element slots):
    thread i writes 8 columns of key n at i * 8, i = ((tt KC + c) 64 + r),
    rows past N zero."""
    n = vbn.shape[0]
    nt, kc = -(-n // 64), width // 8
    out = np.full(nt * kc * 64 * 8, np.nan, np.float32)
    for i in range(nt * kc * 64):
        r, rest = i % 64, i // 64
        c, tt = rest % kc, rest // kc
        row = tt * 64 + r
        out[i * 8:i * 8 + 8] = vbn[row, 8 * c:8 * c + 8] if row < n else 0
    return out.reshape(nt, -1)


def prologue_tiles(rows, width):
    """The prologue's kTiled store of one slice: chunk cc / 8 of row r of
    tile t at t 64 width + (cc / 8) 512 + r 8; rows past N zero."""
    n = rows.shape[0]
    nt = -(-n // 64)
    out = np.full((nt, 64 * width), np.nan, np.float32)
    for t in range(nt):
        for r in range(64):
            for cc in range(0, width, 8):
                row = t * 64 + r
                out[t, (cc // 8) * 512 + r * 8 + np.arange(8)] = (
                    rows[row, cc:cc + 8] if row < n else 0)
    return out


def read_kmajor(tile, kk, rows=64):
    """The rows x 16 operand a K-major step kk reads: element (m, k) at
    kk kStepE 16 + (m // 8) SBO + (k // 8) LBO + (m % 8) 16 + (k % 8) 2
    bytes."""
    m, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    addr = kk * 2 * CORE + (m // 8) * 128 + (k // 8) * CORE + (m % 8) * 16 \
        + (k % 8) * 2
    return tile[addr // 2]


def read_mnmajor(tile, kk, n):
    """The 16 x n operand an MN-major step kk reads: element (k, j) at
    kk kStepMNE 16 + (j // 8) SBO + (k // 8) LBO + (k % 8) 16 + (j % 8) 2
    bytes."""
    k, j = np.meshgrid(np.arange(16), np.arange(n), indexing="ij")
    addr = kk * 2 * 128 + (j // 8) * CORE + (k // 8) * 128 + (k % 8) * 16 \
        + (j % 8) * 2
    return tile[addr // 2]


def test_vbn_writer_is_the_header():
    text = _squash(WB)
    for line in ("const int r = (int)(i % kT);", "size_t rest = i / kT;",
                 "const int c = (int)(rest % KC);", "rest /= KC;",
                 "const int tt = (int)(rest % nt), g = (int)(rest / nt);",
                 "*reinterpret_cast<uint4*>(vbn + i * 8) = out;"):
        assert line in text, line
    body = _squash(BWD)
    assert ("return kTiled ? tbase + (size_t)(cc / V) * (kAT * V) + r * V : "
            "obase + (size_t)r * W::kW + cc;") in body
    assert ("const size_t tbase = ((size_t)g * gridDim.x + blockIdx.x) * kAT "
            "* W::kW;") in body


@pytest.mark.parametrize("n", [100, 576])
def test_vbn_tiles_read_as_p_vb_n_operand(n):
    """vb_n's 72 columns (e = 70 and two zero columns) as P vb_n's MN-major
    B at n = 72: k16 step kk of key tile t reads keys 64 t + 16 kk .. + 15,
    every column, no padding; the ragged tile's missing keys read zero."""
    vbn = RNG.standard_normal((n, 72)).astype(np.float32)
    vbn[:, 70:] = 0
    tiles = vbn_tiles(vbn, 72)
    padded = np.zeros((tiles.shape[0] * 64, 72), np.float32)
    padded[:n] = vbn
    for t in range(tiles.shape[0]):
        for kk in range(4):
            got = read_mnmajor(tiles[t], kk, 72)
            want = padded[64 * t + 16 * kk:64 * t + 16 * kk + 16]
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kk", range(5))
def test_row_tiles_read_as_80_deep_operand(kk):
    """A prologue tile of 80 columns (e = 70 padded to five k16 steps) read
    K-major by d = Y Yw^T: step kk reads columns 16 kk .. 16 kk + 15 of all
    64 rows."""
    rows = RNG.standard_normal((100, 80)).astype(np.float32)
    tiles = prologue_tiles(rows, 80)
    padded = np.zeros((128, 80), np.float32)
    padded[:100] = rows
    for t in range(2):
        got = read_kmajor(tiles[t], kk)
        np.testing.assert_array_equal(got, padded[64 * t:64 * t + 64,
                                                  16 * kk:16 * kk + 16])


@pytest.mark.parametrize("kk", range(4))
def test_row_tiles_read_as_dva_operand(kk):
    """The same tile as the gradient passes' MN-major B at n = 72 (dva +=
    T(A) vbdft, dvb += T(A)^T vadf): step kk reads rows 16 kk .. + 15 (the
    walked rows, the sum index) and the first 72 columns; columns 72-79
    are never read."""
    rows = RNG.standard_normal((64, 80)).astype(np.float32)
    tile = prologue_tiles(rows, 80)[0]
    np.testing.assert_array_equal(read_mnmajor(tile, kk, 72),
                                  rows[16 * kk:16 * kk + 16, :72])


def test_tiles_fit_the_pass_kernels_shared_memory():
    """The swizzled 64 x 64 tiles of a pass start on 1024-byte atoms and
    every block fits the SM (PassWb's offsets: own X, own Y, two stages of
    Xw, Yw and, rows = queries with GRAD, Zw)."""
    tile, y80, y64 = 64 * 128, 10 * CORE, 8 * CORE
    for y in (y80, y64):
        for z in (1, 2):
            stage = tile + z * y
            ring = tile + y
            assert ring % 1024 == 0 and stage % 1024 == 0
            assert ring + 2 * stage + 2 * 3 * 64 * 4 + 4 * 64 * 4 + 24 \
                + 1024 <= 227 * 1024
    text = _squash(WB)
    assert ("static constexpr int OX = 0, OY = kTileBytes, RING = OY + kY, "
            "WS = RING + 2 * kStage, CS = WS + 2 * 3 * kT * 4,") in text
    assert "static constexpr int kStage = kTileBytes + (kZ ? 2 : 1) * kY;" \
        in text


def test_trace_check_names_the_rounded_qkv_gemm():
    """Phase 9b finds #2's qkv Linear in the profile by the name of its
    instance, ``gemm_wgmma_kernel<OP, EPI, BN>`` with OP the forward and EPI
    ``kRounded``: the key is those codes, read out of the headers, and the
    bf16 qkv entry point launches that forward epilogue."""
    common = (CSRC / "common.cuh").read_text()
    gemm = (CSRC / "gemm_wgmma.cuh").read_text()
    rounded = re.search(r"kRounded = (\d+),", common)[1]
    fwd = re.search(r"kOpFwd = (\d+),", gemm)[1]
    assert "template <int OP, int EPI, int BN>\n__global__" in gemm
    assert "return gemm_fwd<kRounded>(" in (CSRC / "gemm_wgmma.cu").read_text()
    key = f"wg::gemm_wgmma_kernel<{fwd}, {rounded}, "
    assert f'"{key}"' in Path(chip_smoke.__file__).read_text()
