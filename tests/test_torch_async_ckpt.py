"""Asynchronous checkpoints (``rel_pose_tpu_torch.train.checkpoint.
AsyncCheckpointer``) and the training CLI's use of them, on the CPU.

PyTorch's Adam updates the parameters and its moments in place, and
``state_dict()`` hands out those live tensors, so a write that overlaps
the next steps must work on a host copy taken before ``save()`` returns.
The API test holds the worker's write back until two more Adam steps have
run, so a copy taken late (or not at all) would show in the file.  The CLI
test trains 3 steps with ``--ckpt_every 1``: each file must hold its own
step's state, load back bit for bit, and resume the run; with
``$RELPOSE_PEAK_TFLOPS`` set the logged metrics carry ``mfu``, without it
(and without a GPU) they do not.
"""

import json
import os
import sys
import threading

import pytest
import torch
from torch import nn

from rel_pose_tpu_torch.cli import train as cli
from rel_pose_tpu_torch.train import checkpoint
from rel_pose_tpu_torch.train.optim import make_optimizer
from test_cli import make_matterport_tree


def _state_equal(a, b):
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_state_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_state_equal, a, b))
    return a == b


def _load(path):
    return torch.load(path, weights_only=True)


def _small_training(seed=0):
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Linear(6, 16), nn.BatchNorm1d(16), nn.ReLU(),
                          nn.Linear(16, 3))
    opt, sched = make_optimizer(model, lr=1e-2, steps=20, warmup=4)
    x, y = torch.randn(8, 6), torch.randn(8, 3)

    def step():
        opt.zero_grad()
        ((model(x) - y) ** 2).mean().backward()
        opt.step()
        sched.step()
    return model, opt, sched, step


def test_async_save_holds_the_state_at_save_time(tmp_path, monkeypatch):
    model, opt, sched, step = _small_training()
    for _ in range(2):
        step()
    checkpoint.save_checkpoint(str(tmp_path / "sync.pth"), model, opt,
                               sched)
    stepped = threading.Event()
    write = checkpoint.write_checkpoint

    def late_write(path, state):
        assert stepped.wait(60)
        write(path, state)
    monkeypatch.setattr(checkpoint, "write_checkpoint", late_write)
    with checkpoint.AsyncCheckpointer() as writer:
        writer.save(str(tmp_path / "async.pth"), model, opt, sched)
        for _ in range(2):
            step()
        stepped.set()
    sync, late = _load(tmp_path / "sync.pth"), _load(tmp_path / "async.pth")
    assert _state_equal(sync, late)
    assert sync["scheduler"]["last_epoch"] == 2
    # the run went on: the live state is two steps further
    assert not _state_equal(sync["model"], model.state_dict())
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_a_failed_write_is_raised_at_the_next_save_or_wait(tmp_path):
    model, opt, sched, _ = _small_training()
    (tmp_path / "file").write_text("not a directory")
    bad = str(tmp_path / "file" / "ckpt.pth")
    writer = checkpoint.AsyncCheckpointer()
    writer.save(bad, model, opt, sched)
    with pytest.raises(OSError):
        writer.wait()
    writer.wait()                        # the error is raised once
    writer.save(bad, model, opt, sched)
    with pytest.raises(OSError):
        writer.save(str(tmp_path / "ok.pth"), model, opt, sched)
    assert not (tmp_path / "ok.pth").exists()
    writer.save(str(tmp_path / "ok.pth"), model, opt, sched)
    writer.close()
    assert (tmp_path / "ok.pth").exists()


def _records(name):
    with open(os.path.join("output", name, "runs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# the depth-2 flagship at fc 64: checkpoints of ~65 MB where fc 512's are
# ~210 MB (tests/test_torch_ddp_cli.py)
CFG = dict(transformer_depth=2, fc_hidden_size=64)


def _run(name, steps):
    return cli.main(["--name", name, "--datapath", "matterport", "--batch",
                     "2", "--no_ddp", "--num_workers", "1", "--device",
                     "cpu", "--transformer_depth", "2", "--fc_hidden_size",
                     "64", "--fusion_transformer", "--steps", str(steps),
                     "--ckpt_every", "1", "--warmup", "1"])


def test_cli_checkpoints_resume_bit_for_bit(tmp_path, monkeypatch, capsys):
    from rel_pose_tpu_torch.config import ModelConfig
    from rel_pose_tpu_torch.models.vitess import ViTEss
    monkeypatch.chdir(tmp_path)
    # the logger's TensorBoard import (~12 s where it pulls TensorFlow) is
    # not what is tested
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    make_matterport_tree(str(tmp_path / "matterport"))
    monkeypatch.setenv("RELPOSE_PEAK_TFLOPS", "989")
    assert _run("exp", 3) == 0
    assert "finished training!" in capsys.readouterr().out
    assert all("mfu" in r for r in _records("exp")
               if "train_geo_loss_rot" in r)
    for k in (1, 2, 3):
        saved = _load(checkpoint.checkpoint_path("exp", k))
        assert saved["scheduler"]["last_epoch"] == k
        assert {float(s["step"]) for s in
                saved["optimizer"]["state"].values()} == {float(k)}
        model = ViTEss(ModelConfig(**CFG), device="cpu")
        opt, sched = make_optimizer(model, steps=3, warmup=1)
        checkpoint.load_checkpoint(checkpoint.checkpoint_path("exp", k),
                                   model, opt, sched)
        assert _state_equal(checkpoint.host_state(model, opt, sched), saved)
    monkeypatch.delenv("RELPOSE_PEAK_TFLOPS")
    assert _run("exp", 4) == 0
    out = capsys.readouterr().out
    assert ("loading existing checkpoint "
            f"{checkpoint.checkpoint_path('exp', 3)}") in out
    fourth = _load(checkpoint.checkpoint_path("exp", 4))
    assert fourth["scheduler"]["last_epoch"] == 4
    assert not any("mfu" in r for r in _records("exp")[-1:])
