"""Convergence: the port's train step must learn, in both dtypes, and its
convergence tool (``rel_pose_tpu_torch.tools.convergence_run``) must be
the JAX script's.

  * tests/test_convergence.py's reduced protocol (depth 2, 4x4 feature
    grid, 64x64 images, batch 1, 50 steps, Adam + OneCycle at peak lr 3e-4
    with 5 warm-up steps, one shared real-magnitude pose) through the
    port's ``train_step`` on the CPU, fp32 and bf16, with its gates
    (``convergence_run.gate``): rot and tr each end below a tenth of the
    largest of their first 5 readings, rot ends at most 1.5x its minimum,
    no NaN.  The weights are PyTorch's default initializers under
    ``torch.manual_seed(0)``, as the training CLI draws them;
  * ``build_tree`` writes the same files, byte for byte, as
    ``scripts/convergence_run.py``'s for the same seed, in both protocols;
  * the tool refuses a tree built under the other protocol (as
    tests/test_convergence.py:91 checks the script);
  * a 2-step CPU run through the tool and the training CLI prints a
    ``CONVERGENCE_SUMMARY`` that ``parse_summary`` reads.

    python tests/test_torch_convergence.py

runs the protocol over weight seeds 0-2 and 1, 2 and 4 threads, both
dtypes, one process a run, three at a time, and prints a JSON line a run:
the spread of the trajectories behind the fixture's thread count.
"""

import filecmp
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rel_pose_tpu_torch.cli import train as cli
from rel_pose_tpu_torch.config import ModelConfig
from rel_pose_tpu_torch.tools import convergence_run as tool
from rel_pose_tpu_torch.train.optim import make_optimizer
from rel_pose_tpu_torch.train.step import train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 50
DTYPES = ("float32", "bfloat16")


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_convergence_run", os.path.join(REPO, "scripts",
                                            "convergence_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _setup(dtype, seed=cli.SEED):
    cfg = ModelConfig(compute_dtype=dtype, transformer_depth=2,
                      feature_height=4, feature_width=4, pool_size=4,
                      fc_hidden_size=64)
    model = cli.build_model(cfg, "cpu", seed)
    opt, sched = make_optimizer(model, lr=3e-4, steps=STEPS,
                                warmup=STEPS // 10)
    return model, opt, sched


def _run(model, opt, sched):
    rng = np.random.default_rng(0)
    B = 1
    images = rng.uniform(0, 255, (B, 2, 3, 64, 64)).astype(np.float32)
    poses = np.zeros((B, 2, 7), np.float32)
    poses[..., 6] = 1.0
    poses[:, 1, :3] = (0.5, 0.1, -0.2)
    poses[:, 1, 3:] = (0.1, 0.2, 0.38, 0.9)
    poses[:, 1, 3:] /= np.linalg.norm(poses[0, 1, 3:])
    intr = np.tile(np.array([[517.97, 517.97, 32, 32]], np.float32),
                   (B, 2, 1))
    batch = [torch.from_numpy(a) for a in (images, poses, intr)]
    rot, tr = [], []
    for _ in range(STEPS):
        metrics, _ = train_step(model, opt, sched, *batch)
        rot.append(metrics["train_geo_loss_rot"].item())
        tr.append(metrics["train_geo_loss_tr"].item())
    return rot, tr


@pytest.fixture(scope="module")
def trajectories():
    """{dtype: (rot, tr)}, on two intra-op threads whatever the process
    was given, so that the result does not depend on the host's cores:
    oneDNN blocks its sums by the thread count, and a bf16 trajectory
    moves with those roundings.  The last gate, rot ends at most 1.5x its
    minimum, reads one step of a tail that wanders at the loss floor, in
    either dtype: over weight seeds 0-2 on 1, 2 and 4 threads (this
    file's ``__main__``) every run fell at least 81x in rot and tr, and
    that gate failed the fp32 runs of seed 2 on every thread count and 4
    of the 9 bf16 runs -- among them this seed on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return {dtype: _run(*_setup(dtype)) for dtype in DTYPES}
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("dtype", DTYPES)
def test_train_step_converges(trajectories, dtype):
    rot, tr = trajectories[dtype]
    print(f"{dtype}: rot {max(rot[:5]):.5f} -> {rot[-1]:.5f} (min "
          f"{min(rot):.5f}), tr {max(tr[:5]):.5f} -> {tr[-1]:.5f}")
    assert tool.gate(rot, tr) == []


@pytest.mark.parametrize("distinct", [False, True])
def test_build_tree_is_the_jax_script_s(tmp_path, distinct):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    tool.build_tree(str(ours), n_pairs=2, hw=(24, 32), seed=5,
                    distinct=distinct)
    _jax_script().build_tree(str(theirs), n_pairs=2, hw=(24, 32), seed=5,
                             distinct=distinct)
    files = sorted(str(p.relative_to(ours)) for p in ours.rglob("*")
                   if p.is_file())
    assert files == sorted(str(p.relative_to(theirs))
                           for p in theirs.rglob("*") if p.is_file())
    assert len(files) == 4 + 3
    match, mismatch, errors = filecmp.cmpfiles(ours, theirs, files,
                                               shallow=False)
    assert mismatch == errors == [] and len(match) == len(files)


def test_tool_refuses_a_mismatched_tree(tmp_path):
    tool.build_tree(str(tmp_path / "matterport"), n_pairs=1, hw=(32, 32))
    (tmp_path / "matterport" / "DISTINCT").write_text("False")
    r = subprocess.run(
        [sys.executable, "-m", "rel_pose_tpu_torch.tools.convergence_run",
         "--root", str(tmp_path), "--distinct", "--steps", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "distinct=False" in (r.stderr + r.stdout)


def test_summary_of_a_two_step_cpu_run(tmp_path, monkeypatch, capsys):
    """The tool's training child runs in this process (``cli.main`` in the
    run's directory), with TensorBoard's import (~12 s) left out."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    calls = []

    def run_in_process(cmd, cwd, env):
        assert cmd[1:3] == ["-m", "rel_pose_tpu_torch.cli.train"]
        calls.append(cmd)
        here = os.getcwd()
        os.chdir(cwd)
        try:
            return subprocess.CompletedProcess(cmd, cli.main(cmd[3:]))
        finally:
            os.chdir(here)
    monkeypatch.setattr(tool.subprocess, "run", run_in_process)
    root = tmp_path / "conv"
    assert tool.main(["--device", "cpu", "--steps", "2", "--depth", "2",
                      "--batch", "2", "--warmup", "1", "--root",
                      str(root)]) == 0
    summary = tool.parse_summary(capsys.readouterr().out)
    assert len(calls) == 1 and "--fusion_transformer" in calls[0]
    assert summary["dtype"] == "float32" and summary["steps"] == 2
    assert summary["protocol"] == "shared" and summary["batch"] == 2
    assert np.isfinite([summary["rot_final"], summary["tr_final"]]).all()
    steps, rot, tr = tool.read_trajectory(
        str(root / "output" / "conv_float32"), "train")
    assert rot[-1] == summary["rot_final"] and tr[0] == summary["tr_first"]
    with pytest.raises(ValueError):
        tool.parse_summary("no summary here\n")


def _spread_run(dtype, threads, seed):
    torch.set_num_threads(threads)
    rot, tr = _run(*_setup(dtype, seed))
    return {"dtype": dtype, "threads": threads, "seed": seed,
            "rot_first5_max": max(rot[:5]), "rot_end": rot[-1],
            "rot_min": min(rot), "tr_first5_max": max(tr[:5]),
            "tr_end": tr[-1], "gate": tool.gate(rot, tr)}


if __name__ == "__main__":
    import concurrent.futures
    import itertools
    import json
    import multiprocessing
    runs = list(itertools.product(DTYPES, (1, 2, 4), (0, 1, 2)))
    with concurrent.futures.ProcessPoolExecutor(
            3, mp_context=multiprocessing.get_context("spawn")) as pool:
        for row in pool.map(_spread_run, *zip(*runs)):
            print(json.dumps(row), flush=True)
