"""``PosePredictor`` request latency on the card, host wall clock.

    python -m rel_pose_tpu_torch.tools.bench_infer_latency [--reps 50]

Counterpart of ``scripts/bench_infer_latency.py`` with its protocol: the
flagship at full width (depth 6) with seeded weights, bf16, 480x640 uint8
requests resized to 384x512 (``image_size``, the Matterport convention)
with the Matterport intrinsics, through two predictors on the same model:

  * ``batch_size=1``, one pair a request through ``predict(img1, img2)``:
    the interactive shape;
  * ``batch_size=--batch`` (256), through ``predict_batch``: the bulk
    shape; it shards over every visible GPU when ``--batch`` divides their
    count (``infer.PosePredictor``), and says over how many.

Each is warmed up by ``warmup()`` (its seconds reported), then called 5
times untimed and timed over ``--reps`` calls (``max(10, reps // 5)`` at
full batch) on the host clock: the host-to-device copy, the resize, the
forward and the copy back, which ``.cpu()`` in the predictor waits for.
Two JSON lines, one a predictor: ``p50_ms``, ``p90_ms`` and ``mean_ms`` as
the JAX script's ``percentiles`` takes them, ``warmup_s``, ``devices``,
and at full batch ``pairs_per_sec`` (from p50), each with the card
(``nvidia-smi``'s name and power limit).  ``--device cpu`` (with
``--depth`` and a small ``--batch``) rehearses it on the CPU.

``--trace DIR`` then traces three more full-batch calls
(``utils.profiling.trace``, a Chrome trace in DIR) and prints a third JSON
line, ``predict_batch_split`` (:func:`trace_split`): the mean call's wall
ms split on the card's timeline into the host-to-device copies, the
kernels (the resize and the forward), the device-to-host copies and the
rest (host work the card waits for, and gaps), with the host's ms before
the card's first operation of the call.
"""

import argparse
import json
import sys
import time

import numpy as np

from . import card_line

PROG = "python -m rel_pose_tpu_torch.tools.bench_infer_latency"
REQUEST_HW = (480, 640)


def percentiles(ts):
    """p50, p90 and mean of ``ts`` (seconds) in ms, as the JAX script."""
    ts = sorted(ts)
    return {"p50_ms": 1e3 * ts[len(ts) // 2],
            "p90_ms": 1e3 * ts[int(len(ts) * 0.9)],
            "mean_ms": 1e3 * sum(ts) / len(ts)}


def time_calls(fn, reps, warmup=5):
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return percentiles(ts)


def trace_split(path, name="predict_batch"):
    """Every ``record_function(name)`` span of the Chrome trace at
    ``path`` split by the card's operations that start inside it -> mean
    ms a span: ``wall_ms``; ``h2d_ms``, ``kernels_ms``, ``d2h_ms``, the
    card's busy time in host-to-device copies, kernels and device-to-host
    copies; ``other_ms``, the wall less those three; ``host_first_ms``,
    from the span's start to the card's first operation in it."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == name]
    ops = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    keys = ("wall_ms", "h2d_ms", "kernels_ms", "d2h_ms", "other_ms",
            "host_first_ms")
    total = dict.fromkeys(keys, 0.0)
    for s in spans:
        t0, t1 = s["ts"], s["ts"] + s["dur"]
        inside = [e for e in ops if t0 <= e["ts"] < t1]
        part = {
            "wall_ms": s["dur"],
            "h2d_ms": sum(e["dur"] for e in inside if "HtoD" in e["name"]),
            "kernels_ms": sum(e["dur"] for e in inside
                              if e["cat"] == "kernel"),
            "d2h_ms": sum(e["dur"] for e in inside if "DtoH" in e["name"]),
            "host_first_ms": (min(e["ts"] for e in inside) - t0 if inside
                              else s["dur"])}
        part["other_ms"] = part["wall_ms"] - (
            part["h2d_ms"] + part["kernels_ms"] + part["d2h_ms"])
        for k in keys:      # the trace's times are microseconds
            total[k] += part[k] / 1e3 / len(spans)
    return dict(total, calls=len(spans))


def main(argv=None):
    from ..cli._eval import resolve_device
    from ..infer import MATTERPORT_INTRINSICS, PosePredictor
    from .bench_stages import seeded_model
    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--trace", metavar="DIR",
                    help="trace three full-batch calls into DIR and print "
                         "their split")
    args = ap.parse_args(argv)
    device = resolve_device(args.device, PROG)
    card = card_line() if device.type == "cuda" else "cpu (host clock)"
    model = seeded_model(args.dtype, args.depth, device)
    rng = np.random.default_rng(0)
    img1, img2 = (rng.integers(0, 256, REQUEST_HW + (3,), dtype=np.uint8)
                  for _ in range(2))
    batch = rng.integers(0, 256, (args.batch, 2, 3) + REQUEST_HW,
                         dtype=np.uint8)
    common = {"dtype": args.dtype, "depth": args.depth,
              "request_hw": list(REQUEST_HW), "image_size": [384, 512],
              "device": str(device), "card": card}
    for metric, b, reps in (
            ("predict_latency", 1, args.reps),
            ("predict_batch_latency", args.batch, max(10, args.reps // 5))):
        pred = PosePredictor(model, intrinsics=MATTERPORT_INTRINSICS,
                             image_size=(384, 512), batch_size=b)
        t0 = time.perf_counter()
        pred.warmup(*REQUEST_HW)
        warm = time.perf_counter() - t0
        if metric == "predict_latency":
            res = time_calls(lambda: pred.predict(img1, img2), reps)
        else:
            res = time_calls(lambda: pred.predict_batch(batch), reps)
            res["pairs_per_sec"] = b / (res["p50_ms"] / 1e3)
        print(json.dumps(dict(res, metric=metric, batch=b, reps=reps,
                              warmup_s=warm, devices=len(pred.devices),
                              **common)), flush=True)
    if args.trace:
        import torch
        from ..utils.profiling import trace
        with trace(args.trace) as prof:
            for _ in range(3):
                with torch.profiler.record_function("predict_batch"):
                    pred.predict_batch(batch)
        print(json.dumps(dict(trace_split(prof.trace_path),
                              metric="predict_batch_split", batch=args.batch,
                              trace=prof.trace_path, **common)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
