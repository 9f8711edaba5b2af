"""The port's measuring tools (``rel_pose_tpu_torch/tools/bench_*``) on
the CPU.

What a CPU run can show: the model's stages (``ViTEss.stages``), which
``bench_stages`` times one by one, compose to ``model(images, intr)`` bit
for bit (fp32, a tiny flagship as ``tests/test_infer.py``'s: depth 2, 8x8
features); ``bench_stages_bwd``'s boundary hooks
leave every gradient bit for bit as plain autograd computes it, and its
stages partition the parameters; each tool's ``main`` runs at
``--device cpu`` on the smallest sizes (depth 2 at full width) and prints
its JSON line with the keys of the JAX script it stands for; and
``--device cuda`` without a GPU exits with a message instead of running on
the CPU.  The times themselves come only from the card (``chip_smoke.py``
phase 10).
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from rel_pose_tpu_torch.config import ModelConfig
from rel_pose_tpu_torch.models.vitess import ViTEss
from rel_pose_tpu_torch.nn.init import seeded_state_dict
from rel_pose_tpu_torch.tools import (Clock, bench_infer_latency,
                                      bench_loader, bench_stages,
                                      bench_stages_bwd, bench_train)
from rel_pose_tpu_torch.train.step import loss_fn

TINY = ModelConfig(transformer_depth=2, feature_height=8, feature_width=8,
                   pool_size=8, fc_hidden_size=64)
SMALL = ["--device", "cpu", "--depth", "2"]
STAGES = ["pre", "stem", "layer1", "layer2", "extractor", "tokens", "vit",
          "cross", "regress"]


@pytest.fixture(scope="module")
def tiny():
    model = ViTEss(TINY, device="cpu")
    model.load_state_dict(seeded_state_dict(ViTEss(TINY, device="meta"), 4))
    return model


def json_lines(main, argv):
    """``main(argv)``'s exit code and the JSON objects it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    return code, [json.loads(line) for line in buf.getvalue().splitlines()
                  if line.startswith("{")]


def test_stages_compose_to_forward(tiny):
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.integers(0, 256, (2, 2, 3, 96, 128), dtype=np.uint8))
    intr = torch.tensor([517.97, 517.97, 64.0, 48.0]).repeat(2, 2, 1)
    staged = tiny.eval().stages(images.shape, intr)
    assert [n for n, _ in staged] == STAGES
    with torch.no_grad():
        acts, marks = bench_stages.run_stages(staged, images, Clock("cpu"))
        want = tiny(images, intr)
    assert len(marks) == len(acts) + 1 == len(staged) + 1
    assert torch.equal(acts[-1], want)


def test_bench_stages_main():
    code, (rec,) = json_lines(bench_stages.main,
                              SMALL + ["--batch", "1", "--iters", "1"])
    assert code == 0
    assert list(rec["stages_ms"]) == STAGES
    assert all(v > 0 for v in rec["stages_ms"].values())
    for k in ("stages_sum_ms", "forward_ms", "sum_share", "pairs_per_sec",
              "batch", "dtype", "card"):
        assert k in rec
    assert rec["dtype"] == "bfloat16" and rec["device"] == "cpu"


def test_hooked_gradients_equal_autograd(tiny):
    model = tiny.train()
    images, poses, intr = bench_stages_bwd.train_batch(2, "cpu",
                                                       hw=(96, 128))
    staged = bench_stages_bwd.training_stages(model, images, poses, intr)
    model.zero_grad(set_to_none=True)
    _, bwd = bench_stages_bwd.staged_step(staged, images, Clock("cpu"))
    hooked = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    loss_fn(model, images, poses, intr)[0].backward()
    for n, p in model.named_parameters():
        assert torch.equal(hooked[n], p.grad), n
    # every boundary that carries a gradient was reached
    assert set(bwd) == {"start", "end"} | set(range(1, len(staged) - 1))
    model.eval()


def test_stages_partition_parameters(tiny):
    groups = bench_stages_bwd.stage_parameters(tiny)
    names = [n for g in groups.values() for n in g]
    assert sorted(names) == sorted(n for n, _ in tiny.named_parameters())
    assert len(names) == len(set(names))
    assert all(groups.values())


def test_bench_stages_bwd_main():
    code, (rec,) = json_lines(bench_stages_bwd.main,
                              SMALL + ["--batch", "1", "--iters", "1"])
    assert code == 0
    names = STAGES + ["loss"]
    assert list(rec["forward_ms"]) == names == list(rec["backward_ms"])
    assert rec["backward_ms"]["pre"] is None
    assert all(v > 0 for k, v in rec["backward_ms"].items() if k != "pre")
    assert rec["step_ms"] > 0 and rec["dtype"] == "float32"


def test_bench_stages_bwd_each_iteration():
    """Both orders of the staged and plain steps run; each iteration's
    readings come out, and the plain step's median is theirs."""
    code, (rec,) = json_lines(bench_stages_bwd.main,
                              SMALL + ["--batch", "1", "--iters", "2"])
    assert code == 0
    for key in ("staged_ms_each", "step_ms_each", "host_ms_each"):
        assert len(rec[key]) == 2 and all(v > 0 for v in rec[key])
    assert rec["step_ms"] == pytest.approx(np.median(rec["step_ms_each"]))
    assert rec["alloc_retries"] == rec["device_allocs"] == 0


# scripts/bench_train.py's keys
BENCH_TRAIN_KEYS = ("metric", "value", "unit", "dtype", "batch", "remat",
                    "pairs_per_sec")


@pytest.mark.parametrize("mode", bench_train.MODES)
def test_bench_train_main(mode):
    code, (rec,) = json_lines(bench_train.main, SMALL + [
        "--batch", "1", "--iters", "1", "--mode", mode])
    assert code == 0
    for k in BENCH_TRAIN_KEYS:
        assert k in rec
    assert rec["metric"] == f"train_{mode}_ms" and rec["unit"] == "ms"
    assert rec["value"] > 0 and rec["pairs_per_sec"] > 0
    assert rec["remat"] is False


def test_bench_train_remat(monkeypatch):
    """``BENCH_REMAT`` (any value but the empty string, as the JAX
    script reads it) turns remat on, as ``--remat`` does."""
    monkeypatch.setenv("BENCH_REMAT", "1")
    code, (rec,) = json_lines(bench_train.main, SMALL + [
        "--batch", "1", "--iters", "1", "--mode", "grad"])
    assert code == 0
    assert all(k in rec for k in BENCH_TRAIN_KEYS)
    assert rec["remat"] is True and rec["value"] > 0


def test_bench_infer_latency_main():
    code, recs = json_lines(bench_infer_latency.main,
                            SMALL + ["--batch", "1", "--reps", "1"])
    assert code == 0
    assert [r["metric"] for r in recs] == ["predict_latency",
                                           "predict_batch_latency"]
    for r in recs:
        assert r["p50_ms"] > 0 and r["p90_ms"] > 0 and r["mean_ms"] > 0
        assert r["warmup_s"] > 0 and r["devices"] == 1
    assert recs[1]["pairs_per_sec"] > 0


def test_trace_split(tmp_path):
    # two spans of 100 and 60 us; the copy at 150 lies outside both
    ev = [{"cat": "user_annotation", "name": "predict_batch", "ts": 0,
           "dur": 100},
          {"cat": "user_annotation", "name": "predict_batch", "ts": 200,
           "dur": 60},
          {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
           "ts": 10, "dur": 40},
          {"cat": "kernel", "name": "k", "ts": 50, "dur": 30},
          {"cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)",
           "ts": 90, "dur": 2},
          {"cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
           "ts": 150, "dur": 5},
          {"cat": "kernel", "name": "k", "ts": 230, "dur": 20},
          {"cat": "cpu_op", "name": "aten::copy_", "ts": 10, "dur": 40}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    got = bench_infer_latency.trace_split(str(path))
    want = {"wall_ms": 0.08, "h2d_ms": 0.02, "kernels_ms": 0.025,
            "d2h_ms": 0.001, "other_ms": 0.034, "host_first_ms": 0.02,
            "calls": 2}
    assert got == pytest.approx(want)


def test_bench_infer_latency_trace(tmp_path):
    code, recs = json_lines(bench_infer_latency.main, SMALL + [
        "--batch", "1", "--reps", "1", "--trace", str(tmp_path)])
    assert code == 0
    (split,) = [r for r in recs if r["metric"] == "predict_batch_split"]
    assert split["calls"] == 3 and split["wall_ms"] > 0
    # no card: the whole wall is the host's
    assert split["kernels_ms"] == split["h2d_ms"] == 0
    assert split["other_ms"] == pytest.approx(split["wall_ms"])


def test_bench_loader_main():
    code, (rec,) = json_lines(bench_loader.main, [
        "--device", "cpu", "--n", "4", "--workers", "1", "--batch", "2"])
    assert code == 0
    for k in ("metric", "value", "unit", "pairs", "workers", "native"):
        assert k in rec
    assert rec["metric"] == "loader_pairs_per_sec" and rec["pairs"] == 2


@pytest.mark.parametrize("tool", [bench_stages, bench_stages_bwd,
                                  bench_train, bench_infer_latency,
                                  bench_loader])
def test_cuda_without_gpu_exits(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tool.main(["--device", "cuda"])
    assert "no CUDA device" in str(e.value)
