"""The port's MFU report (``rel_pose_tpu_torch.tools.mfu_report``).

  * the padding helper, and the tiles it pads to read back out of the
    port's tensor-core headers (``csrc/gemm_tc.cuh``'s ``FwdTile`` and
    ``BK_DEPTH``, ``attention_tc.cuh``'s ``kAT``, ``essential_tc.cuh``'s
    72 output columns and 80 of depth for e = 70);
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
    assert mfu.gemm_macs(200, 40, 70, True) == 256 * 64 * 128
    assert mfu.gemm_macs(200, 40, 70, False) == 200 * 40 * 70


def test_tiles_are_the_headers():
    gemm = (CSRC / "gemm_tc.cuh").read_text()
    bm, bn = map(int, re.search(r"using FwdTile = Tile<(\d+), (\d+),",
                                gemm).groups())
    bk = int(re.search(r"int BK_DEPTH = (\d+)", gemm).group(1))
    assert mfu.GEMM_TILE == (bm, bn, bk)
    attn = (CSRC / "attention_tc.cuh").read_text()
    assert mfu.ATTN_TILE == int(re.search(r"constexpr int kAT = (\d+);",
                                          attn).group(1))
    eb = (CSRC / "essential_tc.cuh").read_text()
    width = int(re.search(r"kW = E == kHeadDim \? kHeadDim : (\d+);",
                          eb).group(1))
    assert width == mfu.pad(70, mfu.MMA_K)            # k16 depth over e
    assert "kNT = (E + 7) / 8;" in eb                 # n8 output tiles
    assert 8 * ((70 + 7) // 8) == mfu.pad(70, mfu.MMA_N)


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
    tiles and C, 3C, 4C whole columns: the ViT stack pads nothing; the
    essential block pads e = 70 to 72 and 80."""
    real, padded = (mfu.vit_stack_macs(512, 576, 192, 3, 768, 5, p)
                    for p in (False, True))
    assert padded == real
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
