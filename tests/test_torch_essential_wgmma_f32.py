"""PyTorch port: the fp32 essential block on TF32 wgmma (kernels #2, #3, #4
and #6 in fp32, ``csrc/essential_wgmma_f32.cuh``) as far as the CPU can
check it.

A plain mirror of the new design, in fp32 with every product through
``ops.vit_stack.tf32x3_matmul`` (3xTF32) at the kernels' partial depth --
one 64- or 72-deep tile a fresh sum, P vb_n two fresh 32-key sums, each
added to the running sum in fp32:

  * forward: the key statistics merged online over the query tiles of the
    transposed product; the moments in ONE walk over the key tiles with the
    online row max (o = fma(o, alpha, P vb_n over the tile's first 32 keys)
    + P vb_n over its last 32, l rescaled alike), av = o / lr,
    the tile's F partial va^T av over 8-deep partials (mma_atb_f32) and the
    partials summed in query-tile order;
  * backward: the query and key statistics, the prologue, one pass over the
    query rows for rho (W's row sums) and gamma's per-query-tile partials
    (W's column sums), gamma summed in query-tile order, then the key rows'
    and the query rows' gradient passes.

It is held to the Pallas kernels in interpret mode
(``_essential_block_call``, ``essential_block_bwd_call``) and to the
port's plain versions, as tests/test_torch_essential_route.py holds the
mma.sync mirror (tolerances: F relative to max|F| 1e-5, the backward's
||err|| / ||ref|| 1e-5), and to the float64 bar of ``chip_smoke.py`` phase
3b for the 8 flag sets (N = 576, one pair: its max |err| from the moments
run in float64 at most ``F64_BAR`` times the fp32 plain version's, for F,
dq, dk, dv and dpos).

Then the operand layouts the new kernels add to
tests/test_torch_attention_wgmma_f32.py's: a numpy model of ``split_rows_w``
(an e-deep K-major tile, 72 fp32: three swizzle columns, nine k8 steps) and
``split_cols_w`` (a 72-row transposed tile: two swizzle columns of 72 rows)
and of the addresses wgmma reads through the kernels' descriptors
(``step_rows``), with the formulas read out of the header.  The kernels
themselves run only on the card (``chip_smoke.py`` phases 3b and 3d).
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
                                        _online_stats, _pass, _slices)

from rel_pose_tpu.ops.pallas_essential_block import _essential_block_call
from rel_pose_tpu.ops.pallas_essential_block_bwd import \
    essential_block_bwd_call
from rel_pose_tpu_torch.ops import essential_block as te
from rel_pose_tpu_torch.ops.vit_stack import tf32x3_matmul

CSRC = Path(__file__).resolve().parent.parent / "rel_pose_tpu_torch" / "csrc"
WG = (CSRC / "essential_wgmma_f32.cuh").read_text()
SIGMA = 0.125
TOL = 1e-5
ROW, SBO, STEP_K = 128, 1024, 32
HALF = 32                             # keys a fresh P vb_n partial
PERM = (0, 2, 4, 6, 1, 3, 5, 7)       # slot -> key within a k8 step
RNG = np.random.default_rng(31)


# ---------------------------------------------------------- the mirror --

def _f_partial(va, av, mm):
    """va^T av over 64 rows as mma_atb_f32 sums it: 8-deep partials, each
    added in fp32 in order."""
    f = 0.0
    for r in range(0, va.shape[1], 8):
        f = f + mm(va[:, r:r + 8].transpose(1, 2), av[:, r:r + 8])
    return f


def _fma(a, b, c):
    """fp32 a b + c rounded once (``__fmaf_rn``): the product of two fp32
    numbers is exact in float64."""
    if not torch.is_tensor(a):
        a = torch.full_like(c, a)
    return (a.double() * b.double() + c.double()).to(c.dtype)


def wg_slice_moments(q, k, va, vb, single, mm=tf32x3_matmul):
    """F (G, e, e) as the TF32 wgmma moments compute it on fp32 slices q, k
    (G, N, 64), va, vb (G, N, e)."""
    n = q.shape[1]
    s = mm(q, k.transpose(1, 2)) * SCALE                    # (G, N, N)
    if single:
        vbn = vb
    else:
        mc, lcinv = _online_stats(s.transpose(1, 2))        # key statistics
        vbn = vb * lcinv[..., None]
    f = 0.0
    for i0 in range(0, n, TILE):                           # query tiles
        m = torch.full(s.shape[:1] + s[:, i0:i0 + TILE].shape[1:2],
                       -float("inf"))
        lr, o = torch.zeros_like(m), 0.0
        for j0 in range(0, n, TILE):                       # ONE key walk
            blk = s[:, i0:i0 + TILE, j0:j0 + TILE]
            mn = torch.maximum(m, blk.amax(-1))
            alpha = torch.exp2(m - mn)[..., None]           # 0 at first
            er = torch.exp2(blk - mn[..., None])
            lr = lr * alpha[..., 0] + er.sum(-1)
            p = er if single else er * torch.exp2(
                blk - mc[:, None, j0:j0 + TILE])
            # P vb_n as two fresh 32-key partials: fma(o, alpha, pv1) + pv2
            pv1 = mm(p[..., :HALF], vbn[:, j0:j0 + HALF])
            pv2 = mm(p[..., HALF:], vbn[:, j0 + HALF:j0 + TILE])
            o = _fma(o, alpha, pv1) + pv2
            m = mn
        av = o * (1.0 / lr)[..., None]
        f = f + _f_partial(va[:, i0:i0 + TILE], av, mm)     # in tile order
    return f


def wg_moments_mirror(qkv, pos, heads, cross, single, mm=tf32x3_matmul):
    """F (B, 2, heads, e, e) of fp32 qkv (B, 2, N, 3C) as the wgmma body
    computes it."""
    q, k, vb, va = _slices(qkv, pos, heads, cross)
    f = wg_slice_moments(q, k, va, vb, single, mm)
    return f.view(qkv.shape[0], 2, heads, *f.shape[1:])


def _reduce_pass(q, k, vb, vadf, qst, kst, single, mm):
    """Pass a over the query rows: rho = W's row sums and gamma's
    per-query-tile partials = W's column sums (dual), W = (dA Cm) R (SINGLE
    dA R); gamma = the partials summed in query-tile order."""
    G, n, _ = q.shape
    rho = torch.zeros(G, n)
    parts = []
    for i0 in range(0, n, TILE):
        r = slice(i0, i0 + TILE)
        col = torch.zeros(G, n)
        for j0 in range(0, n, TILE):
            w = slice(j0, j0 + TILE)
            s = mm(q[:, r], k[:, w].transpose(1, 2)) * SCALE
            d = mm(vadf[:, r], vb[:, w].transpose(1, 2))
            R = torch.exp2(s - qst[0][:, r, None]) * qst[1][:, r, None]
            if single:
                wt = d * R
            else:
                Cm = torch.exp2(s - kst[0][:, None, w]) * kst[1][:, None, w]
                wt = (d * Cm) * R
            rho[:, r] += wt.sum(-1)
            col[:, w] = wt.sum(-2)
        parts.append(col)
    gamma = None
    if not single:
        gamma = parts[0]
        for p in parts[1:]:
            gamma = gamma + p
    return rho, gamma


def wg_slice_bwd(q, k, va, vb, df, single, mm=tf32x3_matmul):
    """(dq, dk, dva, dvb) in fp32 as the TF32 wgmma passes compute them:
    statistics, prologue, the merged rho / gamma pass, then the key rows'
    and the query rows' gradient passes (essential_tc_bwd.cuh's formulas;
    ``_pass`` of the mma.sync mirror at the wgmma tiles' depth)."""
    s = mm(q, k.transpose(1, 2)) * SCALE
    qst = [*_online_stats(s), None]
    kst = None if single else [*_online_stats(s.transpose(1, 2)), None]
    vbdft = mm(vb, df.transpose(1, 2))                      # the prologue
    vadf = mm(va, df)
    qst[2], gamma = _reduce_pass(q, k, vb, vadf, qst, kst, single, mm)
    if not single:
        kst[2] = gamma
    args = (SCALE, SIGMA, mm)
    ident = lambda t: t
    dk, dvb = _pass(False, True, single, (k, vb, kst, ident),
                    (q, vadf, vadf, qst), *args)
    dq, dva = _pass(True, True, single, (q, vadf, qst, ident),
                    (k, vb, vbdft, kst), *args)
    return dq, dk, dva, dvb


def wg_bwd_mirror(qkv, pos, df, heads, cross, single, mm=tf32x3_matmul):
    """(dqkv (B, 2, N, 3C), dpos_part (B, 2, h, N, 6) or None) in fp32 as
    the wgmma passes compute them, dv = dva + dvb (with cross features
    each image's v = dvb of its key direction + dva of its query
    direction, added by the wrapper)."""
    q, k, vb, va = _slices(qkv, pos, heads, cross)
    G, n, e = vb.shape
    dq, dk, dva, dvb = wg_slice_bwd(q, k, va, vb, df.reshape(G, e, e),
                                    single, mm)
    B = qkv.shape[0]
    shape = lambda t: t.view(B, 2, heads, n, t.shape[-1])
    dq, dk, dva, dvb = map(shape, (dq, dk, dva, dvb))
    d = 64
    if cross:
        dv = dvb[..., :d] + dva.flip(1)[..., :d]
    else:
        dv = dva[..., :d] + dvb[..., :d]
    dpos = dva[..., d:] + dvb[..., d:]
    dqkv = torch.stack([dq.flip(1), dk, dv], 2).permute(0, 1, 4, 2, 3, 5)
    return (dqkv.reshape(B, 2, n, 3 * heads * d),
            dpos if pos is not None else None)


# ------------------------------------------------ against the references --

CASES = [(64, True, False, False), (100, True, True, False),
         (100, False, False, True), (576, True, False, False)]
CASE_IDS = [f"N={n}-{'pos' if p else 'nopos'}-{'cross' if x else 'self'}-"
            f"{'single' if s else 'dual'}" for n, p, x, s in CASES]


@pytest.mark.parametrize("n,has_pos,cross,single", CASES, ids=CASE_IDS)
def test_wgmma_mirror_matches_pallas(n, has_pos, cross, single):
    """F and the backward of the fp32 wgmma design against #4 and #6 in
    interpret mode and against the port's plain versions."""
    qkv, pos, df = _mirror_inputs(n, has_pos)
    jq = jnp.asarray(qkv.numpy())
    jp = jnp.asarray(pos.numpy())
    p = pos if has_pos else None
    want_f = np.asarray(_essential_block_call(
        jq[:, 0], jq[:, 1], jp, 1, cross, single, has_pos, interpret=True))
    got_f = wg_moments_mirror(qkv, p, 1, cross, single)
    plain_f = te.essential_block_reference(qkv[:, 0], qkv[:, 1], p, 1, cross,
                                           single)
    for ref in (want_f, plain_f.numpy()):
        np.testing.assert_allclose(got_f.numpy(), ref, rtol=0,
                                   atol=TOL * np.abs(ref).max())
    want1, want2, want_pos = essential_block_bwd_call(
        jq[:, 0], jq[:, 1], jp, jnp.asarray(df.numpy()), 1, cross, single,
        has_pos, interpret=True)
    got, got_pos = wg_bwd_mirror(qkv, p, df, 1, cross, single)
    plain, plain_pos = te.essential_block_bwd_reference(qkv, p, df, 1, cross,
                                                        single)
    for img, want in ((0, want1), (1, want2)):
        for slot in range(3):
            sl = slice(slot * 64, (slot + 1) * 64)
            for ref in (np.asarray(want)[..., sl], plain[:, img, :, sl]):
                assert _normrel(got[:, img, :, sl], ref) <= TOL, (img, slot)
    if has_pos:
        assert _normrel(te.sum_dpos(got_pos), np.asarray(want_pos)) <= TOL
        assert _normrel(got_pos, plain_pos) <= TOL


def f64_errors(n, has_pos, cross, single):
    """{output: (the wgmma mirror's max |err|, the fp32 plain version's)}
    from the moments run in float64 (``chip_smoke.essential_f64``) on one
    pair of N = n."""
    qkv, pos, df = _mirror_inputs(n, has_pos)
    pos = pos if has_pos else None
    f = wg_moments_mirror(qkv, pos, 1, cross, single)
    dqkv, dpos = wg_bwd_mirror(qkv, pos, df, 1, cross, single)
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
def test_wgmma_mirror_within_float64_bar(has_pos, cross, single):
    """The mirror at N = 576, one pair: its max |err| from float64 at most
    ``chip_smoke.F64_BAR`` times the fp32 plain version's, per output."""
    for part, (got, plain) in f64_errors(576, has_pos, cross,
                                         single).items():
        assert got <= chip_smoke.F64_BAR * plain, (part, got, plain)


def test_one_walk_equals_two_walks():
    """The online row max gives the exact max's F up to fp32 rounding: the
    one-walk moments against the same products with every row's exact max
    known up front (the mma.sync body's first walk)."""
    qkv, pos, _ = _mirror_inputs(100, True)
    q, k, vb, va = _slices(qkv, pos, 1, False)
    exact = wg_slice_moments(q.double(), k.double(), va.double(),
                             vb.double(), False, torch.matmul)
    got = wg_slice_moments(q, k, va, vb, False)
    assert _normrel(got, exact) <= 1e-6


# ------------------------------------------------------------ the layouts --

def _squash(text):
    return " ".join(text.split())


def swz_rows(R, r, j):
    """The header's byte offset of 16-byte chunk j of row r in a K-major
    tile of R rows."""
    return (j >> 3) * (R * ROW) + r * ROW + (((j & 7) ^ (r & 7)) << 4)


def test_formulas_are_the_header():
    text = _squash(WG)
    assert ("return (j >> 3) * (R * kRowBytes) + r * 128 + (((j & 7) ^ (r & "
            "7)) << 4);") in text
    assert ("return d + (uint64_t)(((kk >> 2) * (R * kRowBytes) + (kk & 3) "
            "* kStepK) / 16);") in text
    assert "static constexpr int kBytes = (D + 31) / 32 * kColBytes;" in text
    # split_rows_w: chunk j of row r from raw row r, columns 4j .. 4j + 3,
    # the lo tile KTile<64, W>::kBytes on
    assert ("put_split_lo(pair, KTile<kT, W>::kBytes, swz_rows<kT>(r, j), "
            "*reinterpret_cast<const float4*>(raw + r * W + 4 * j));") in text
    # split_cols_w: chunk j of tile row c from raw column c, rows r0, r0 +
    # 2, r0 + 4, r0 + 6 with r0 = 8 (j >> 1) + (j & 1)
    assert ("const float* p = raw + (8 * (j >> 1) + (j & 1)) * W + c;"
            in text)
    assert ("put_split_lo(pair, KTile<W, kT>::kBytes, swz_rows<W>(c, j), "
            "make_float4(p[0], p[2 * W], p[4 * W], p[6 * W]));") in text
    # the products read the lo tiles where the splits put them
    assert "bl = desc(b + KTile<NR, kT>::kBytes)" in text
    assert "al = desc(a + K::kBytes)" in text and \
        "bl = desc(b + K::kBytes)" in text
    assert "m64n72k8.f32.tf32.tf32" in WG


def split_rows_w(raw):
    """``split_rows_w``'s hi tile: 64 rows of depth W (a float32 view)."""
    W = raw.shape[1]
    smem = np.full((W + 31) // 32 * 64 * ROW // 4, np.nan, np.float32)
    for r in range(64):
        for j in range(W // 4):
            smem[swz_rows(64, r, j) // 4 + np.arange(4)] = \
                raw[r, 4 * j:4 * j + 4]
    return smem


def split_cols_w(raw):
    """``split_cols_w``'s hi tile: W rows (raw columns), 64 deep."""
    W = raw.shape[1]
    smem = np.full(2 * W * ROW // 4, np.nan, np.float32)
    for c in range(W):
        for j in range(16):
            r0 = 8 * (j >> 1) + (j & 1)
            smem[swz_rows(W, c, j) // 4 + np.arange(4)] = raw[r0:r0 + 8:2, c]
    return smem


def swizzle(addr):
    """The 128-byte swizzle on a byte address."""
    return addr ^ (((addr >> 7) & 7) << 4)


def wgmma_read(smem, rows, kk):
    """The rows x 8 tf32 operand a K-major wgmma step kk reads through
    ``step_rows<rows>``: element (i, k) at start + (i // 8) SBO + (i % 8)
    128 + 4 k."""
    start = (kk >> 2) * rows * ROW + (kk & 3) * STEP_K
    i, k = np.meshgrid(np.arange(rows), np.arange(8), indexing="ij")
    addr = start + (i // 8) * SBO + (i % 8) * ROW + 4 * k
    return smem[swizzle(addr) // 4]


@pytest.mark.parametrize("kk", range(9))
def test_e_deep_tile_reads_the_rows(kk):
    """A 64 x 72 box split as an e-deep K-major tile (three swizzle
    columns): k8 step kk reads columns 8kk .. 8kk + 7 of every row; the
    ninth step lies in the third column, whose unused chunks it never
    touches."""
    raw = RNG.standard_normal((64, 72)).astype(np.float32)
    got = wgmma_read(split_rows_w(raw), 64, kk)
    np.testing.assert_array_equal(got, raw[:, 8 * kk:8 * kk + 8])


@pytest.mark.parametrize("kk", range(8))
def test_72_row_transposed_tile_reads_in_slot_order(kk):
    """A 64 x 72 box split transposed into 72 rows (nine 8-row groups a
    swizzle column, columns 9216 bytes apart): step kk reads the box's
    rows 8kk + PERM as the sum index, every one of its 72 columns as a
    row of the product's n = 72."""
    raw = RNG.standard_normal((64, 72)).astype(np.float32)
    got = wgmma_read(split_cols_w(raw), 72, kk)
    keys = [8 * kk + p for p in PERM]
    np.testing.assert_array_equal(got, raw[keys, :].T)


def test_tiles_fit_the_swizzle_atoms():
    """Every swizzle column starts on a 1024-byte atom: a 72-row column
    is 9 atoms, a 64-row one 8, and the pass kernel's tiles start at
    multiples of 1024 (offsets read out of PassWg)."""
    assert 72 * ROW % 1024 == 0 and 64 * ROW % 1024 == 0
    pair64, pair72 = 2 * 8 * 1024 * 2, 2 * 72 * ROW * 2   # 64x64, 72 x 64
    deep72 = 2 * 3 * 64 * ROW                             # 64 rows x 72
    for ky in (deep72, pair64):
        offsets = [0, pair64, pair64 + ky, 2 * pair64 + ky]
        assert all(o % 1024 == 0 for o in offsets)
    assert max(deep72, pair72) == deep72
    body = _squash(WG[WG.index("struct PassWg {"):])
    assert ("static constexpr int OX = 0, OY = OX + kF32Pair, W1 = OY + "
            "kPairY, W2 = W1 + kF32Pair, RX = W2 + kPairW2,") in body


def test_register_fragments_of_a_raw_box():
    """``raw_frags`` (q in the moments, the own rows in the statistics)
    reads A fragment e of step kk at row 16w + g + 8 (e & 1), column 8kk +
    t + 4 (e >> 1) of the raw box, wgmma's tf32 register A layout."""
    text = _squash(WG)
    assert ("const float* r = raw + (warp * 16 + (lane >> 2)) * kHeadDim + "
            "(lane & 3);") in text
    expr = re.search(r"split_tf32\(r\[([^\]]+)\], h\[kk\]\[e\],", text)[1]
    for kk in range(8):
        for e, (row, col) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
            at = eval(expr, {}, {"e": e, "kk": kk, "kHeadDim": 64})
            assert (at // 64, at % 64 - 8 * kk) == (row, col)


def test_gamma_partials_sum_in_tile_order():
    """The key rows' pass adds gamma's partials in query-tile order and
    the reduce pass writes one partial a (query tile, slice, key)."""
    text = _squash(WG)
    assert ("for (int qt = 0; qt < nt; ++qt) t += gpart[((size_t)qt * G + "
            "g) * N + row];") in text
    assert ("gpart[((size_t)blockIdx.x * G + g) * N + w0 + tid] = ((CSs[tid] "
            "+ CSs[kT + tid]) + CSs[2 * kT + tid]) + CSs[3 * kT + tid];") \
        in text
