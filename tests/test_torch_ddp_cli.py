"""The port's CLIs over several ranks on the CPU (gloo).

  * the training CLI with ``--gpus 2 --device cpu`` (``python -m`` in a
    subprocess; it starts its two ranks with ``parallel.spawn``), 2 steps
    of the depth-2 flagship (fc 64) at ``--batch 1`` a rank on
    tests/test_cli.py's ``make_matterport_tree``: rank 0 alone writes (one
    args snapshot, one metrics record, one TensorBoard file), the record
    carries ``mfu`` where ``$RELPOSE_PEAK_TFLOPS`` names a peak, the
    checkpoint keys carry no ``module.`` prefix and the ``.pth`` loads in
    the port's ``PosePredictor``; a second 2-rank run resumes from step 2;
    under torchrun's variables ``--no_ddp`` and another ``--gpus`` are
    refused;
  * the two eval CLIs as 2 ranks each, started as torchrun would start
    them (its environment variables set by hand; 4 processes side by
    side), on tests/test_torch_eval_cli.py's trees -- 5 Matterport pairs
    (shards of 3 and 2) and 7 InteriorNet pairs (4 and 3) -- against the
    same CLI in one process: the rows come back in rank-major order
    (``items[0::2]`` then ``items[1::2]``) and match the single process's
    within tests/test_torch_eval_cli.py's bounds -- results within 1e-4
    (metres, fractions) and 1e-3 (degrees), the CSVs row by row within
    the same plus 1e-5 (their ``%1.5f``) -- which also cover the gather's
    float32 ground truths (the JAX CLIs gather float32 too).
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rel_pose_tpu_torch.cli import test_matterport as port_mp
from rel_pose_tpu_torch.cli import test_streetlearn_interiornet as port_insl
from rel_pose_tpu_torch.config import ModelConfig
from rel_pose_tpu_torch.infer import PosePredictor
from rel_pose_tpu_torch.models.vitess import ViTEss
from rel_pose_tpu_torch.nn.init import seeded_state_dict
from rel_pose_tpu_torch.parallel.dist import free_port
from test_cli import make_matterport_tree
from test_torch_eval_cli import (INSL_FILES, MP_FILES,
                                 make_viewpoint_test_tree, read_csv,
                                 read_results, vary_matterport_ground_truth)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fc 64: a 22 MB model (its checkpoints with Adam ~65 MB) where fc 512
# writes 210 MB ones
FUSION = ["--transformer_depth", "2", "--fusion_transformer",
          "--fc_hidden_size", "64"]
DEPTH2 = ModelConfig(transformer_depth=2, fc_hidden_size=64)
TIMEOUT = 300


def env(**extra):
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", **extra)


def train(cwd, *extra, **environ):
    """``python -m rel_pose_tpu_torch.cli.train --gpus 2 --device cpu``,
    2 ranks of batch 1, ``environ`` added to the environment -> its
    stdout."""
    r = subprocess.run(
        [sys.executable, "-m", "rel_pose_tpu_torch.cli.train", "--name",
         "exp", "--datapath", "matterport", "--batch", "1", "--gpus", "2",
         "--device", "cpu", "--num_workers", "1", "--ckpt_every", "2",
         "--warmup", "1"] + FUSION + list(extra),
        cwd=cwd, env=env(**environ), capture_output=True, text=True,
        timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def test_two_rank_training_cli(tmp_path):
    make_matterport_tree(str(tmp_path / "matterport"))
    out = train(tmp_path, "--steps", "2", RELPOSE_PEAK_TFLOPS="989")
    assert "starting 2 ranks (cpu)" in out
    assert "devices: 2 (cpu on rank 0, gloo), per-device batch 1, global " \
        "batch 2" in out
    assert out.count("finished training!") == 1
    run = tmp_path / "output" / "exp"
    assert len(glob.glob(str(run / "args_*.txt"))) == 1
    records = [json.loads(line) for line in
               open(run / "runs" / "metrics.jsonl")]
    assert len(records) == 1 and records[0]["step"] == 2
    assert np.isfinite(records[0]["train_geo_loss_tr"])
    assert "mfu" in records[0]         # the peak is known: MFU is logged
    assert len(glob.glob(str(run / "runs" / "events.out.tfevents.*"))) <= 1
    assert os.listdir(run / "checkpoints") == ["000002.pth"]

    path = str(run / "checkpoints" / "000002.pth")
    ckpt = torch.load(path, weights_only=True)
    assert set(ckpt["model"]) == set(ViTEss(DEPTH2, device="meta")
                                     .state_dict())
    pred = PosePredictor.from_checkpoint(path, DEPTH2, device="cpu")
    for k, v in pred.model.state_dict().items():
        torch.testing.assert_close(v, ckpt["model"][k], rtol=0, atol=0)
    assert ckpt["scheduler"]["last_epoch"] == 2

    out = train(tmp_path, "--steps", "3")
    assert f"loading existing checkpoint output/exp/checkpoints/000002.pth" \
        in out
    third = torch.load(run / "checkpoints" / "000003.pth", weights_only=True)
    assert third["scheduler"]["last_epoch"] == 3
    assert {float(s["step"]) for s in third["optimizer"]["state"].values()} \
        == {3.0}


@pytest.mark.parametrize("extra,message", [
    (["--no_ddp"], "--no_ddp under torchrun's world of 2 ranks"),
    (["--gpus", "3"], "--gpus 3 under torchrun's world of 2 ranks"),
])
def test_refusals_under_torchrun(tmp_path, monkeypatch, extra, message):
    """Under torchrun's variables the world is torchrun's: ``--no_ddp`` or
    another ``--gpus`` is refused before anything is written or joined."""
    from rel_pose_tpu_torch.cli import train as cli
    monkeypatch.chdir(tmp_path)
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as e:
        cli.main(["--name", "refused", "--datapath", "matterport",
                  "--device", "cpu"] + extra)
    assert message in str(e.value)
    assert not os.path.exists("output")


EVAL_FLAGS = ["--ckpt", "model.pth", "--batch", "2", "--device", "cpu"] \
    + FUSION


def start_eval(module, cwd, argv):
    """Two ranks of ``python -m <module> argv`` with torchrun's variables
    set by hand."""
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, "-m", module.__name__] + argv, cwd=cwd,
        env=env(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                MASTER_ADDR="localhost", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]


@pytest.fixture(scope="module")
def eval_runs(tmp_path_factory):
    """The trees and a seeded depth-2 flagship (fc 64) ``.pth``; each eval
    CLI in 2 ranks (exp ``ddp``) and in this process (exp ``one``)."""
    wd = tmp_path_factory.mktemp("ddp_eval")
    rng = np.random.default_rng(71)
    make_matterport_tree(str(wd / "matterport"), n=5)
    vary_matterport_ground_truth(str(wd / "matterport"), rng)
    make_viewpoint_test_tree(str(wd / "inet"),
                             "metadata/interiornet/test_pair_rotation.npy",
                             rng)
    torch.save({"model": seeded_state_dict(ViTEss(DEPTH2, device="meta"),
                                           3)}, wd / "model.pth")
    mp_argv = ["--exp", "ddp", "--datapath", "matterport"] + EVAL_FLAGS
    insl_argv = ["--exp", "ddp", "--datapath", "inet", "--dataset",
                 "interiornet"] + EVAL_FLAGS
    procs = (start_eval(port_mp, wd, mp_argv)
             + start_eval(port_insl, wd, insl_argv))
    cwd = os.getcwd()
    os.chdir(wd)
    try:
        assert port_mp.main(["--exp", "one", "--datapath", "matterport"]
                            + EVAL_FLAGS) == 0
        assert port_insl.main(["--exp", "one", "--datapath", "inet",
                               "--dataset", "interiornet"] + EVAL_FLAGS) == 0
    finally:
        os.chdir(cwd)
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return wd, outs


def rank_major(n):
    """The single process's row order -> the 2-rank gather's."""
    return [i for r in range(2) for i in range(n)[r::2]]


def assert_close_results(one, ddp, degree_keys):
    assert ddp.keys() == one.keys()
    for k in one:
        tol = 1e-3 if k in degree_keys else 1e-4
        assert abs(ddp[k] - one[k]) <= tol, (k, ddp[k], one[k])


def test_matterport_cli_over_two_ranks(eval_runs):
    wd, outs = eval_runs
    assert "rank 0/2: evaluating 3 of 5 pairs" in outs[0]
    assert "rank 1/2: evaluating 2 of 5 pairs" in outs[1]
    assert "throughput:" in outs[0] and "throughput:" not in outs[1]
    one = wd / "output" / "one" / "matterport_test"
    ddp = wd / "output" / "ddp" / "matterport_test"
    assert_close_results(read_results(one / "results.txt"),
                         read_results(ddp / "results.txt"),
                         {"R mean err", "R median err"})
    order = rank_major(5)
    for name, tol in zip(MP_FILES, (1e-4, 1e-3)):
        want, got = read_csv(one / name)[order], read_csv(ddp / name)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol + 1e-5,
                                   err_msg=name)


def test_interiornet_cli_over_two_ranks(eval_runs):
    """7 pairs, the one at 103 degrees dropped from the CSVs: the rows are
    the kept pairs in rank-major order."""
    wd, outs = eval_runs
    assert "rank 0/2: evaluating 4 of 7 pairs" in outs[2]
    one = wd / "output" / "one" / "interiornet_test"
    ddp = wd / "output" / "ddp" / "interiornet_test"
    want = read_results(one / "results.txt")
    assert_close_results(want, read_results(ddp / "results.txt"),
                         {k for k in want if not k.endswith("10deg")})
    gt = read_csv(one / INSL_FILES[1])
    # the sorted keys are 0-6; YAWS[4] puts pair 4 at 103 degrees
    kept = [i for i in range(7) if i != 4]
    assert len(gt) == len(kept)
    order = [kept.index(i) for i in rank_major(7) if i in kept]
    for name in INSL_FILES:
        np.testing.assert_allclose(read_csv(ddp / name),
                                   read_csv(one / name)[order], rtol=0,
                                   atol=1e-3 + 1e-5, err_msg=name)
