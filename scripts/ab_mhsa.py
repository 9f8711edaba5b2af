#!/usr/bin/env python3
"""Readings of the --noess attention kernel #7 in one tree, to compare two
trees on one GPU.

    python3 scripts/ab_mhsa.py [--tree DIR] [--dtype float32|bfloat16]
                               [--no-step]

Imports ``rel_pose_tpu_torch`` from ``DIR`` (this checkout by default) and
``chip_smoke.py`` from this checkout, builds DIR's kernels, and in the
dtype (float32 by default) checks #7 against its plain versions at the
model's shapes (``chip_smoke.check_mhsa``) and times, each beside its plain
version, one ``F.scaled_dot_product_attention`` call and its bound
(operations over 165 TFLOP/s in fp32, 989 in bf16, or bytes over 3.35
TB/s): the forward (``fused_mhsa``) at G = 1,536 heads, the eval shape;
the backward (``fused_mhsa_bwd``) at G = 360, the training shape, without
the forward's statistics and, where the tree's wrapper takes them, from
the statistics (and output, where the wrapper takes ``o`` in that dtype)
of a forward run with them, as a train step runs it, that also by kernel
(``torch.profiler``); then, unless ``--no-step``, the --noess train step
at batch 60 in that dtype with the kernels and on the plain path
(``chip_smoke.time_train_steps``).  Run it in turns on one card, the other
tree, this one, this one, the other.  Needs a CUDA device.
"""

import argparse
import importlib.util
import inspect
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, D = 576, 64


def readings(cs, device, card, dtype):
    """#7's forward at G = 1,536 and backward at G = 360 in ``dtype``,
    checked against the plain versions and timed beside them."""
    from rel_pose_tpu_torch.ops import attention as ta
    name, failures = str(dtype)[6:], []
    scale = cs.MHSA_SCALE
    G_eval, G_train = 2 * cs.EVAL_BATCH * 3, 2 * cs.TRAIN_BATCH * 3
    cs.check_mhsa(G_eval, dtype, device, failures, cs.SEED + 8)
    cs.check_mhsa(G_train, dtype, device, failures, cs.SEED + 9)
    if failures:
        raise SystemExit(f"ab_mhsa checks failed: {failures}")
    rng = np.random.default_rng(cs.SEED + 20)

    q, k, v = cs.heads(rng, G_eval, dtype, device, 3)
    ms = cs.cuda_time_ms(lambda: ta.fused_mhsa(q, k, v, scale), 5)
    plain = cs.cuda_time_ms(lambda: ta.mhsa_reference(q, k, v, scale), 3)
    lib = cs.sdpa_ms(G_eval // 3, dtype, device, backward=False)
    flops = 4 * G_eval * N * N * D
    b = cs.bound(flops, 4 * cs.nbytes(q), dtype)
    cs.log(f"[ab] mhsa_fwd {name} G={G_eval}: kernel {ms:.3f} ms "
           f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.3f} ms, SDPA "
           f"{lib:.3f} ms, bound {b[0]:.3f} ms ({b[1]}) ({card})")
    del q, k, v

    q, k, v, do = cs.heads(rng, G_train, dtype, device, 4)
    flops = 10 * G_train * N * N * D
    plain = cs.cuda_time_ms(lambda: ta.mhsa_bwd_reference(q, k, v, do,
                                                          scale), 3)
    lib = cs.sdpa_ms(G_train // 3, dtype, device, backward=True)
    ms = cs.cuda_time_ms(lambda: ta.fused_mhsa_bwd(q, k, v, do, scale), 5)
    b = cs.bound(flops, 7 * cs.nbytes(q), dtype)
    cs.log(f"[ab] mhsa_bwd {name} G={G_train} without stats: kernel "
           f"{ms:.3f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.3f} "
           f"ms, SDPA {lib:.3f} ms, bound {b[0]:.3f} ms ({b[1]}) ({card})")
    takes_o = "o" in inspect.signature(ta.fused_mhsa_bwd).parameters
    if dtype == torch.bfloat16 or takes_o:
        o, stats = ta._launch_fwd(q, k, v, scale, stats=True)
        kept = (stats, o) if takes_o else (stats,)
        try:
            ta.fused_mhsa_bwd(q, k, v, do, scale, *kept)
        except ValueError:   # a tree whose bf16 backward takes no o
            kept = (stats,)
        ms = cs.cuda_time_ms(
            lambda: ta.fused_mhsa_bwd(q, k, v, do, scale, *kept), 5)
        b = cs.bound(flops, (7 + len(kept) - 1) * cs.nbytes(q), dtype)
        cs.log(f"[ab] mhsa_bwd {name} G={G_train} from the forward's "
               f"{'stats and o' if len(kept) == 2 else 'stats'}: kernel "
               f"{ms:.3f} ms ({flops / ms / 1e9:.2f} TFLOP/s), bound "
               f"{b[0]:.3f} ms ({b[1]}) ({card})")
        parts = cs.profile_parts_ms(
            lambda: ta.fused_mhsa_bwd(q, k, v, do, scale, *kept),
            lambda key: key.split("<")[0].split("::")[-1], once=True)
        cs.log(f"[ab] mhsa_bwd {name} G={G_train} by kernel, ms: "
               f"{ {key: round(v, 3) for key, v in parts.items()} } ({card})")
    else:
        cs.log(f"[ab] mhsa_bwd {name}: this tree's backward keeps no "
               f"statistics")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--no-step", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_mhsa: no CUDA device", file=sys.stderr)
        return 1
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import rel_pose_tpu_torch
    where = pathlib.Path(rel_pose_tpu_torch.__file__).resolve()
    if tree not in where.parents:
        raise SystemExit(f"rel_pose_tpu_torch from {where}, not {tree}")
    cs.log(f"[ab] tree {tree}")
    dtype = getattr(torch, args.dtype)
    device = torch.device("cuda:0")
    card = cs.phase_device()
    cs.phase_build()
    readings(cs, device, card, dtype)
    if not args.no_step:
        _, sd = cs.make_models(device, noess=True)
        cs.time_train_steps(device, sd, card, dtypes=(dtype,), noess=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
