"""PyTorch port: the operand layouts of the fp32 attention body of kernels
#1, #5 and #7 (``csrc/attention_wgmma_f32.cuh``, TF32 wgmma) as far as the
CPU can check them.

A numpy model of what the kernels write into shared memory and of what
wgmma reads there and from registers:

  * ``split_rows`` and ``split_cols`` (a raw 64 x 64 fp32 box, rows of 256
    bytes, split into hi / lo K-major tiles in the 128-byte swizzle: two
    swizzle columns of 32 fp32 a tile) and the addresses a K-major tf32
    operand is read from through the kernels' descriptors (``desc`` with
    ``tf32_step``: 32 bytes a k8 step, the second swizzle column from step
    4): every element each step reads is the one the product needs -- the
    raw tile's row and column for ``split_rows``; for ``split_cols`` its
    transpose, the sum index running over the raw rows 0 2 4 6 1 3 5 7 of
    each group of 8;
  * ``split_frag``: a score accumulator's elements land in the register A
    fragments' slots in that same order (slot t of each k8 step holds key
    2t, slot t + 4 key 2t + 1), so a score times a ``split_cols`` tile sums
    over matching keys;
  * the register A fragments of a raw tile (q in the forward, v in dk),
    read once, sit where wgmma's tf32 A layout puts them;
  * the hi / lo pair of a tile splits x into hi = rna(x) and lo = rna(x -
    hi) (``ops.vit_stack.tf32_rna``, which tests/test_torch_tf32x3.py holds
    to ``cvt.rna.tf32.f32``).

The formulas are read out of the headers; the kernels themselves run only
on the card (``chip_smoke.py`` phases 3, 3b and 3c hold them to their plain
versions and to float64).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rel_pose_tpu_torch.ops.vit_stack import tf32_rna

CSRC = Path(__file__).resolve().parent.parent / "rel_pose_tpu_torch" / "csrc"
SM90 = (CSRC / "sm90.cuh").read_text()
F32 = (CSRC / "attention_wgmma_f32.cuh").read_text()
ROW, SBO, STEP_K = 128, 1024, 32
HALF = 64 * ROW                       # sm90.cuh kF32Half
TILE = 2 * HALF                       # kF32Tile: a 64 x 64 fp32 tile
PERM = (0, 2, 4, 6, 1, 3, 5, 7)       # slot -> key within a k8 step
RNG = np.random.default_rng(23)


def _squash(text):
    return " ".join(text.split())


def test_formulas_are_the_headers():
    assert "constexpr int kRowBytes = 128;" in SM90
    assert re.search(r"constexpr int kSbo = 8 \* kRowBytes;", SM90)
    assert re.search(r"constexpr int kStepK = 32;", SM90)
    assert "constexpr int kF32Half = 64 * kRowBytes;" in SM90
    assert ("return d + (uint64_t)(((kk >> 2) * kF32Half + (kk & 3) * "
            "kStepK) / 16);") in _squash(SM90)
    assert "constexpr int kF32Tile = 2 * kF32Half;" in F32
    assert ("return (j >> 3) * kF32Half + r * 128 + (((j & 7) ^ (r & 7)) "
            "<< 4);") in _squash(F32)
    # the hi tile, then the lo tile kF32Tile bytes on
    assert "*reinterpret_cast<uint4*>(pair + kF32Tile + off) = l;" in F32
    assert "desc(a + kF32Tile)" in F32 and "desc(b + kF32Tile)" in F32


def swz_f32(r, j):
    """The kernels' byte offset of 16-byte chunk j of row r."""
    return (j >> 3) * HALF + r * ROW + (((j & 7) ^ (r & 7)) << 4)


def split_rows(raw):
    """``split_rows``'s hi tile (a float32 view of its bytes)."""
    smem = np.full(TILE // 4, np.nan, np.float32)
    for r in range(64):
        for j in range(16):
            smem[swz_f32(r, j) // 4 + np.arange(4)] = raw[r, 4 * j:4 * j + 4]
    return smem


def split_cols(raw):
    """``split_cols``'s hi tile: chunk j of row c holds raw rows r0, r0 + 2,
    r0 + 4, r0 + 6 of column c, r0 = 8 (j >> 1) + (j & 1)."""
    body = _squash(F32[F32.index("void split_cols("):])
    assert "const float* p = raw + (8 * (j >> 1) + (j & 1)) * kHeadDim + c;" \
        in body
    assert ("make_float4(p[0], p[2 * kHeadDim], p[4 * kHeadDim], p[6 * "
            "kHeadDim])") in body
    smem = np.full(TILE // 4, np.nan, np.float32)
    for c in range(64):
        for j in range(16):
            r0 = 8 * (j >> 1) + (j & 1)
            smem[swz_f32(c, j) // 4 + np.arange(4)] = raw[r0:r0 + 8:2, c]
    return smem


def swizzle(addr):
    """The 128-byte swizzle on a byte address: the 16-byte chunk (bits 4-6)
    XOR the row within the 1024-byte atom (bits 7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def wgmma_read(smem, kk):
    """The 64 x 8 tf32 operand a K-major wgmma step kk reads from a tile at
    byte 0: element (i, k) at start + (i // 8) SBO + (i % 8) 128 + 4 k, the
    start advanced by ``tf32_step``, the swizzle on the address."""
    start = (kk >> 2) * HALF + (kk & 3) * STEP_K
    i, k = np.meshgrid(np.arange(64), np.arange(8), indexing="ij")
    addr = start + (i // 8) * SBO + (i % 8) * ROW + 4 * k
    return smem[swizzle(addr) // 4]


@pytest.mark.parametrize("kk", range(8))
def test_split_rows_reads_the_tile(kk):
    raw = RNG.standard_normal((64, 64)).astype(np.float32)
    got = wgmma_read(split_rows(raw), kk)
    np.testing.assert_array_equal(got, raw[:, 8 * kk:8 * kk + 8])


@pytest.mark.parametrize("kk", range(8))
def test_split_cols_reads_the_transpose_in_slot_order(kk):
    raw = RNG.standard_normal((64, 64)).astype(np.float32)
    got = wgmma_read(split_cols(raw), kk)
    keys = [8 * kk + p for p in PERM]
    np.testing.assert_array_equal(got, raw[keys, :].T)


def test_split_frag_puts_keys_in_slot_order():
    """Accumulator element p[kk][e] of lane 4g + t sits at row g + 8 (e >>
    1), column 8kk + 2t + (e & 1); register A fragment a[r] at row g + 8
    (r & 1), slot t + 4 (r >> 1).  The key in each slot is PERM's."""
    body = F32[F32.index("void split_frag("):F32.index("void fence_frags(")]
    moves = re.findall(r"split_tf32\(p\[kk\]\[(\d)\], h\[kk\]\[(\d)\], "
                       r"l\[kk\]\[(\d)\]\);", body)
    assert len(moves) == 4
    for t in range(4):
        for e, r, r2 in (tuple(map(int, m)) for m in moves):
            assert r == r2
            assert e >> 1 == r & 1                        # the same row
            slot, key = t + 4 * (r >> 1), 2 * t + (e & 1)
            assert PERM[slot] == key


def test_register_fragments_of_a_raw_tile():
    """q (forward) and v (dk) are read from their raw box into A fragment e
    at row 16w + g + 8 (e & 1), column 8kk + t + 4 (e >> 1): wgmma's tf32
    register A layout, a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
    t + 4)."""
    text = _squash(F32)
    base = "(warp * 16 + (lane >> 2)) * kHeadDim + (lane & 3);"
    assert text.count(base) == 2
    index = re.findall(r"split_tf32\(r[qv]\[([^\]]+)\], ([qv])h\[kk\]\[e\]",
                       text)
    assert sorted(v for _, v in index) == ["q", "v"]
    for expr, _ in index:
        for kk in range(8):
            for e, (row, col) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
                at = eval(expr, {}, {"e": e, "kk": kk, "kHeadDim": 64})
                assert (at // 64, at % 64 - 8 * kk) == (row, col)


def test_hi_lo_pair_reconstructs_fp32():
    x = torch.from_numpy(RNG.standard_normal(4096).astype(np.float32))
    hi = tf32_rna(x)
    lo = tf32_rna(x - hi)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((lo.view(torch.int32) & 0x1FFF) == 0)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert torch.all(err <= 2.0 ** -22 * x.double().abs())
    assert "hi = tf32_rna(x);" in (CSRC / "mma_helpers.cuh").read_text()
