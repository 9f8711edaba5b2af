"""Whole-step MFU and tensor-core floors of the flagship's hand kernels.

    python -m rel_pose_tpu_torch.tools.mfu_report --measure
    python -m rel_pose_tpu_torch.tools.mfu_report --eval_ms 41.6 \\
        --train_fp32_ms 88.0 --train_bf16_ms 82.0 --vit_eval_ms 16.0 \\
        --cross_eval_ms 2.9

Counterpart of ``scripts/mfu_report.py``:

  * whole-step MFU of the eval forward (batch 256, bf16) and the train
    step (batch 60, fp32 and bf16), from ``utils.profiling.
    estimate_step_flops`` (the count the training CLI logs) and the step
    times, against ``$RELPOSE_PEAK_TFLOPS`` or else the H100 SXM's dense
    bf16 tensor-core peak (``utils.profiling.H100_BF16_PEAK``, 989
    TFLOP/s).  In the fp32 step every hand kernel runs on the tensor
    cores as 3xTF32 (three TF32 products a product, fp32 accuracy); only
    cuBLAS and cuDNN keep TF32 off.  Its row reads against the same bf16
    peak, as the JAX script's fp32 row does;
  * the ViT stack's (#1) and the essential block's (#2) floors at the eval
    batch, counted twice: the real MACs of the products, and the MACs at
    the tile shapes the port's bf16 tensor-core kernels schedule -- each
    product's dimensions rounded up to the tile: the GEMMs' 128 x 192 x 64
    (``csrc/gemm_wgmma.cuh``: two 64-row consumers, ``kWideN`` columns,
    ``kGemmK`` deep; the essential block's qkv GEMM runs the same forward,
    epilogue ``kRounded``; fp32's GEMMs,
    ``csrc/gemm_wgmma_f32.cuh``, 128 x 96 x 32, ``GEMM_TILE_F32``, which
    pads nothing more at the flagship's widths), the attention's
    64-row query and key tiles (``csrc/attention_wgmma.cuh`` ``kT``, the
    wgmma tiles of the bf16 body and of the fp32 one,
    ``csrc/attention_wgmma_f32.cuh``: both execute 2 products a head
    forward, and 7 (bf16) or 8 (fp32) backward), the essential body's
    e = 70 in 72 output columns (P vb_n at wgmma n = 72, F in n8 tiles;
    ``csrc/essential_wgmma.cuh`` ``EwbW``) and 80 rows of va in F's m16
    tiles (``csrc/essential_tc.cuh`` ``EbW``, the rows of the mma.sync
    product va^T av).

The times come from ``--measure`` (CUDA events on the card, as
``chip_smoke.py`` times them: 3 calls after a warm-up; the eval forward on
256x256 uint8 pairs, the train step on 384x512 uint8 pairs, seeded
weights) or from the flags, all five of them: there are no recorded
defaults.  It prints the card's name and power limit (``nvidia-smi``) and
the peak used.  ``--measure`` without a GPU fails.
"""

import argparse
import sys

# the port's bf16 tensor-core tiles (tests/test_torch_mfu_report.py reads
# them out of the headers)
GEMM_TILE = (128, 192, 64)   # gemm_wgmma.cuh: 64 kWG rows, kWideN, kGemmK
GEMM_TILE_F32 = (128, 96, 32)  # gemm_wgmma_f32.cuh: kF32WideN, kF32K
ATTN_TILE = 64               # attention_wgmma*.cuh: kT, query and key rows
MMA_N, MMA_K = 8, 16         # n8 output columns, k16 steps of a depth
MMA_M = 16                   # m16 tiles: the rows of va^T av
TIMES = ("eval_ms", "train_fp32_ms", "train_bf16_ms", "vit_eval_ms",
         "cross_eval_ms")


def pad(v, m):
    return -(-v // m) * m


def gemm_macs(M, K, N, padded, tile=GEMM_TILE):
    """M x K x N, each rounded up to ``tile`` (BM, BN, BK) if ``padded``."""
    if not padded:
        return M * K * N
    bm, bn, bk = tile
    return pad(M, bm) * pad(K, bk) * pad(N, bn)


def vit_stack_macs(G, N, C, heads, hidden, depth, padded, tile=GEMM_TILE):
    """MACs of the ViT stack's forward over G sequences of N tokens: per
    block the qkv, projection and MLP GEMMs over all G N rows (at the
    GEMM ``tile`` if ``padded``), and per sequence and head the scores q
    k^T (N x d x N) and A v (N x N x d), at the attention's 64-row tiles if
    ``padded``."""
    d = C // heads
    M = G * N
    gemms = sum(gemm_macs(M, k, n, padded, tile) for k, n in (
        (C, 3 * C), (C, C), (C, hidden), (hidden, C)))
    n = pad(N, ATTN_TILE) if padded else N
    dk = pad(d, MMA_K) if padded else d
    attn = G * heads * (n * dk * n + n * n * dk)
    return depth * (gemms + attn)


def essential_block_macs(B, N, C, heads, e, padded):
    """MACs of the essential block's forward over B pairs: the qkv GEMM of
    the 2 B images' normed tokens, then per pair, direction and head the
    scores (N x d x N), A vb (N x N x e) and va^T (A vb) (e x N x e); if
    ``padded``, e in 72 columns where it is an output and 80 where it is
    va^T's rows, N in 64-row tiles."""
    d = C // heads
    qkv = gemm_macs(2 * B * N, C, 3 * C, padded)
    if padded:
        n, en, em = pad(N, ATTN_TILE), pad(e, MMA_N), pad(e, MMA_M)
        combo = n * d * n + n * n * en + n * em * en
    else:
        combo = N * d * N + N * N * e + e * N * e
    return qkv + 2 * B * heads * combo


def fmt(flops):
    return f"{flops / 1e12:.3f} TFLOP"


def floor_line(stage, measured_ms, floor_flops, peak):
    floor_ms = floor_flops / peak * 1e3
    print(f"  {stage:<30} {measured_ms:8.3f} ms   floor {floor_ms:7.3f} ms"
          f"   ({floor_ms / measured_ms * 100:5.1f}% of the time)")


def measure(eval_batch, train_batch, device="cuda"):
    """{time name: ms} by CUDA events on the card, as ``chip_smoke.py``
    phases 5 / 5b time them."""
    import numpy as np
    import torch
    from ..config import ModelConfig
    from ..infer import MATTERPORT_INTRINSICS
    from ..models.vitess import ViTEss
    from ..nn.init import seeded_state_dict
    from ..ops.essential_block import fused_essential_block_pair
    from ..ops.vit_stack import fused_vit_stack, stack_block_params
    from ..train.optim import make_optimizer
    from ..train.step import train_step
    if not torch.cuda.is_available():
        raise SystemExit("mfu_report --measure: no CUDA device")

    def ms(fn, iters=3):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    rng = np.random.default_rng(0)
    sd = seeded_state_dict(ViTEss(ModelConfig(), device="meta"), seed=0)
    out = {}

    def model(dtype):
        m = ViTEss(ModelConfig(compute_dtype=dtype), device=device)
        m.load_state_dict(sd)
        return m

    B = eval_batch
    m = model("bfloat16")
    images = torch.from_numpy(rng.integers(
        0, 256, (B, 2, 3, 256, 256), dtype=np.uint8)).to(device)
    intr = torch.full((B, 2, 4), 128.0, device=device)
    with torch.inference_mode():
        out["eval_ms"] = ms(lambda: m(images, intr))
        ft = m.fusion_transformer
        x = torch.randn((2 * B, 576, 192), device=device,
                        dtype=torch.bfloat16)
        stacked = stack_block_params(ft.blocks[:-1], torch.bfloat16)
        out["vit_eval_ms"] = ms(lambda: fused_vit_stack(x, stacked, 3,
                                                        ft.pos_embed))
        cb = ft.blocks[-1]
        positional = m._positional(None, B, device)
        args = (x.reshape(B, 2, 576, 192),
                (cb.norm1.weight, cb.norm1.bias),
                (cb.cross_attn.qkv.weight, cb.cross_attn.qkv.bias),
                positional, 3)
        out["cross_eval_ms"] = ms(lambda: fused_essential_block_pair(*args))
    del m, images, x

    T = train_batch
    q = rng.standard_normal((T, 4))
    q[:, 3] = np.abs(q[:, 3]) + 2.0
    poses = np.zeros((T, 2, 7), np.float32)
    poses[..., 6] = 1.0
    poses[:, 1, 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    poses[:, 1, :3] = 0.3 * rng.standard_normal((T, 3))
    batch = tuple(torch.from_numpy(a).to(device) for a in (
        rng.integers(0, 256, (T, 2, 3, 384, 512), dtype=np.uint8), poses,
        np.tile(MATTERPORT_INTRINSICS, (T, 2, 1))))
    for dtype in ("float32", "bfloat16"):
        m = model(dtype)
        opt, sched = make_optimizer(m, lr=5e-4, steps=1000, warmup=100)
        out[f"train_{'fp32' if dtype == 'float32' else 'bf16'}_ms"] = ms(
            lambda: train_step(m, opt, sched, *batch))
        del m, opt, sched
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m rel_pose_tpu_torch.tools.mfu_report")
    ap.add_argument("--eval_batch", type=int, default=256)
    ap.add_argument("--train_batch", type=int, default=60)
    ap.add_argument("--measure", action="store_true",
                    help="time the steps on the card (CUDA events)")
    for name in TIMES:
        ap.add_argument(f"--{name}", type=float, default=None)
    args = ap.parse_args(argv)

    missing = [n for n in TIMES if getattr(args, n) is None]
    if args.measure:
        for k, v in measure(args.eval_batch, args.train_batch).items():
            setattr(args, k, v)
    elif missing:
        sys.exit("ERROR: no times: pass --measure (on the card) or every "
                 f"one of --{' --'.join(TIMES)}; there are no recorded "
                 f"defaults (missing --{' --'.join(missing)})")

    from . import card_line
    from ..config import ModelConfig
    from ..utils.profiling import (H100_BF16_PEAK, env_peak_flops,
                                   estimate_step_flops)
    peak = env_peak_flops() or H100_BF16_PEAK
    cfg = ModelConfig(compute_dtype="bfloat16")
    B, T = args.eval_batch, args.train_batch
    eval_flops = estimate_step_flops(cfg, B, "eval")
    train_flops = estimate_step_flops(cfg, T, "train")
    if eval_flops is None or train_flops is None:
        sys.exit("ERROR: the FLOP count failed; rerun with "
                 "RELPOSE_DEBUG_TRACE=1 to see the exception")

    N, C, H = cfg.num_patches, cfg.total_num_features, cfg.num_heads
    e = cfg.head_dim + cfg.pos_enc
    depth, G = cfg.transformer_depth - 1, 2 * B
    vit = [2 * vit_stack_macs(G, N, C, H, 4 * C, depth, p)
           for p in (False, True)]
    cross = [2 * essential_block_macs(B, N, C, H, e, p)
             for p in (False, True)]

    source = ("measured here (CUDA events)" if args.measure
              else "from the flags")
    print(f"card: {card_line()}; times {source}")
    print(f"peak: {peak / 1e12:.0f} TFLOP/s per GPU (dense bf16 tensor "
          "cores)")
    print("\n== whole-step MFU ==")
    for tag, flops, ms, batch in (
            ("eval fwd  bf16", eval_flops, args.eval_ms, B),
            ("train step fp32", train_flops, args.train_fp32_ms, T),
            ("train step bf16", train_flops, args.train_bf16_ms, T)):
        mfu = flops / (ms * 1e-3) / peak
        note = ("  (fp32: hand kernels as 3xTF32, cuBLAS / cuDNN without "
                "TF32; read against the bf16 peak)" if "fp32" in tag
                else "")
        print(f"  {tag:<16} batch {batch:3d}: {fmt(flops)} / {ms:.3f} ms"
              f"  -> MFU {mfu * 100:6.3f}%{note}")
    print(f"\n== ViT stack (#1), eval batch {B} ({depth} blocks x {G} "
          "sequences) ==")
    print(f"  real {fmt(vit[0])}   padded-tile {fmt(vit[1])}   (pad tax "
          f"{vit[1] / vit[0]:.3f}x)")
    floor_line("against the real-MAC floor", args.vit_eval_ms, vit[0], peak)
    floor_line("against the padded-tile floor", args.vit_eval_ms, vit[1],
               peak)
    print(f"\n== essential block (#2), eval batch {B} ==")
    print(f"  real {fmt(cross[0])}   padded-tile {fmt(cross[1])}   (pad tax "
          f"{cross[1] / cross[0]:.3f}x)")
    floor_line("against the real-MAC floor", args.cross_eval_ms, cross[0],
               peak)
    floor_line("against the padded-tile floor", args.cross_eval_ms,
               cross[1], peak)
    return 0


if __name__ == "__main__":
    sys.exit(main())
