"""The port's MFU report (``rel_pose_tpu_torch.tools.mfu_report``).

  * the padding helper, and the tiles it pads to read back out of the
    port's tensor-core headers (``csrc/gemm_wgmma.cuh``'s forward tile: two
    64-row consumers, ``kWideN`` columns, ``kGemmK`` deep, which the
    essential block's bf16 qkv GEMM runs too (epilogue ``kRounded``); fp32's,
    ``csrc/gemm_wgmma_f32.cuh``: two 64-row consumers, ``kF32WideN``
    columns, ``kF32K`` deep; ``attention_wgmma.cuh``'s
    ``kT`` -- the bf16 body's
    tiles, which the fp32 body's ``kAT`` matches -- for e = 70
    ``essential_wgmma.cuh``'s 72 columns of P vb_n and ``essential_tc.cuh``'s
    80 rows of va in F's m16 tiles);
  * the real-MAC floors equal the per-op count (``count_matmul_flops``) of
    the plain versions the kernels are held to, ``vit_stack_reference``
    and ``essential_block_pair_reference`` (with and without the
    positional columns), exactly; the padded floors are no smaller, and
    at the flagship's shapes the ViT stack's tiles fit exactly;
  * the whole-step MFU it prints from flag times is FLOPs / time / peak;
  * it refuses to run without times or ``--measure``, and ``--measure``
    without a GPU.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from rel_pose_tpu_torch.ops.essential_block import (
    essential_block_pair_reference)
from rel_pose_tpu_torch.ops.vit_stack import vit_stack_reference
from rel_pose_tpu_torch.tools import mfu_report as mfu
from rel_pose_tpu_torch.utils.profiling import count_matmul_flops

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "rel_pose_tpu_torch" / "csrc"


def test_pad():
    assert mfu.pad(64, 64) == 64
    assert mfu.pad(65, 64) == 128
    assert mfu.pad(70, 8) == 72
    assert mfu.pad(70, 16) == 80
    assert mfu.pad(576, 128) == 640
    assert mfu.gemm_macs(200, 40, 70, True) == 256 * 64 * 192
    assert mfu.gemm_macs(200, 40, 70, False) == 200 * 40 * 70


def test_tiles_are_the_headers():
    gemm = (CSRC / "gemm_wgmma.cuh").read_text()
    wgs = int(re.search(r"kWG = OP == kOpDw \? \d+ : (\d+);",
                        gemm).group(1))
    bn = int(re.search(r"constexpr int kWideN = (\d+);", gemm).group(1))
    bk = int(re.search(r"constexpr int kGemmK = (\d+);", gemm).group(1))
    assert mfu.GEMM_TILE == (64 * wgs, bn, bk)
    # the essential block's bf16 qkv Linear: that forward, kRounded
    assert "return gemm_fwd<kRounded>(x, w, bias, nullptr, out, nullptr, M, " \
        "N, K, st);" in " ".join((CSRC / "gemm_wgmma.cu").read_text().split())
    assert "tc::wg::essential_qkv_bf16(x, w, bias, out, M, 3 * C, C, st)" in \
        (CSRC / "essential_block.cu").read_text()
    f32 = (CSRC / "gemm_wgmma_f32.cuh").read_text()
    wgs = int(re.search(r"kWG = OP == kOpDw \? \d+ : (\d+);",
                        f32).group(1))
    bn = int(re.search(r"constexpr int kF32WideN = (\d+);", f32).group(1))
    bk = int(re.search(r"constexpr int kF32K = (\d+);", f32).group(1))
    assert mfu.GEMM_TILE_F32 == (64 * wgs, bn, bk)
    attn = (CSRC / "attention_wgmma.cuh").read_text()
    assert mfu.ATTN_TILE == int(re.search(r"constexpr int kT = (\d+);",
                                          attn).group(1))
    # the fp32 body launches and lands its boxes in the same 64-row tiles
    attn32 = (CSRC / "attention_wgmma_f32.cuh").read_text()
    assert "constexpr int kF32Raw = kT * kHeadDim * 4;" in attn32
    assert attn32.count("dim3((N + kT - 1) / kT, heads, G)") == 1
    assert attn32.count("const dim3 grid((N + kT - 1) / kT, heads, G);") == 1
    eb = (CSRC / "essential_tc.cuh").read_text()
    width = int(re.search(r"E == kHeadDim \? kHeadDim : \(sizeof\(T\) == 2 "
                          r"\? (\d+) :", eb).group(1))
    assert width == mfu.pad(70, mfu.MMA_M)            # va's rows, m16 tiles
    assert "kM16 = (kW + 15) / 16;" in eb
    assert "kNT = (E + 7) / 8;" in eb                 # F's n8 output tiles
    assert 8 * ((70 + 7) // 8) == mfu.pad(70, mfu.MMA_N)
    wb = (CSRC / "essential_wgmma.cuh").read_text()
    n = int(re.search(r"return E == kHeadDim \? kHeadDim : (\d+);",
                      wb).group(1))
    assert n == mfu.pad(70, mfu.MMA_N)                # P vb_n at wgmma n = 72
    assert "W::kTileElems" in wb and "mma_ab_acc<W::kNT, 4, W::kLd>" in wb


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("G,N,C,heads,hidden,depth", [
    (4, 100, 96, 3, 384, 2), (2, 64, 192, 3, 768, 1)])
def test_vit_floor_is_the_plain_count(G, N, C, heads, hidden, depth):
    stacked = {"ln1_scale": _meta(depth, C), "ln1_bias": _meta(depth, C),
               "qkv_w": _meta(depth, 3 * C, C), "qkv_b": _meta(depth, 3 * C),
               "proj_w": _meta(depth, C, C), "proj_b": _meta(depth, C),
               "ln2_scale": _meta(depth, C), "ln2_bias": _meta(depth, C),
               "fc1_w": _meta(depth, hidden, C),
               "fc1_b": _meta(depth, hidden),
               "fc2_w": _meta(depth, C, hidden), "fc2_b": _meta(depth, C)}
    counted = count_matmul_flops(vit_stack_reference, _meta(G, N, C),
                                 stacked, heads, _meta(1, N, C))
    real = mfu.vit_stack_macs(G, N, C, heads, hidden, depth, False)
    assert counted == 2 * real
    assert mfu.vit_stack_macs(G, N, C, heads, hidden, depth, True) >= real


@pytest.mark.parametrize("pos", [True, False])
def test_essential_floor_is_the_plain_count(pos):
    B, N, C, heads = 2, 100, 96, 3
    e = C // heads + (6 if pos else 0)
    counted = count_matmul_flops(
        essential_block_pair_reference, _meta(B, 2, N, C),
        (_meta(C), _meta(C)), (_meta(3 * C, C), _meta(3 * C)),
        _meta(B, N, 6) if pos else None, heads)
    real = mfu.essential_block_macs(B, N, C, heads, e, False)
    assert counted == 2 * real
    assert mfu.essential_block_macs(B, N, C, heads, e, True) > real


def test_flagship_pad_taxes():
    """N = 576 is 9 attention tiles, 2 x 256 x 576 rows are whole GEMM
    tiles and C, 3C, 4C whole columns of either dtype's tiles: the ViT
    stack pads nothing; the essential block pads e = 70 to 72 and 80."""
    real, padded = (mfu.vit_stack_macs(512, 576, 192, 3, 768, 5, p)
                    for p in (False, True))
    assert padded == real
    assert mfu.vit_stack_macs(512, 576, 192, 3, 768, 5, True,
                              mfu.GEMM_TILE_F32) == real
    real, padded = (mfu.essential_block_macs(256, 576, 192, 3, 70, p)
                    for p in (False, True))
    assert 1.0 < padded / real < 1.05


def test_mfu_from_flag_times(capsys, monkeypatch):
    monkeypatch.delenv("RELPOSE_PEAK_TFLOPS", raising=False)
    assert mfu.main(["--eval_ms", "40", "--train_fp32_ms", "90",
                     "--train_bf16_ms", "80", "--vit_eval_ms", "16",
                     "--cross_eval_ms", "3"]) == 0
    out = capsys.readouterr().out
    assert "peak: 989 TFLOP/s" in out and "times from the flags" in out
    want = 16_786_704_384 * 256 / 40e-3 / 989e12
    got = float(re.search(r"eval fwd  bf16 .* MFU +([\d.]+)%", out).group(1))
    assert abs(got - 100 * want) < 1e-3
    assert "read against the bf16 peak" in out


def test_refuses_without_times():
    r = subprocess.run([sys.executable, "-m",
                        "rel_pose_tpu_torch.tools.mfu_report",
                        "--eval_ms", "40"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "no recorded defaults" in r.stderr + r.stdout
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            mfu.main(["--measure"])
