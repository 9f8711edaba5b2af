"""The port's training CLI (``rel_pose_tpu_torch.cli.train``) on the CPU.

Each case is one run of ``main([...] + ["--device", "cpu"])`` in-process
(the ``python -m`` entry only for the refusal of a host without a GPU), on
synthetic trees: Matterport from tests/test_cli.py's
``make_matterport_tree``, InteriorNet from tests/test_torch_data.py's
``make_viewpoint_tree``.  Model flags as tests/test_cli.py's: depth 2, the
fusion transformer where named, the no-fusion default otherwise.  What each
run must show is the JAX CLI's protocol (tests/test_cli.py's
``TestTrainCLI``, ``TestSubepochProtocol`` and ``test_train_interiornet``),
and across the packages:

  * a ``.pth`` the port's CLI writes loads in the port's
    ``PosePredictor.from_checkpoint`` and in the JAX package's
    ``load_torch_checkpoint_with_optimizer``, with the same weights and the
    Adam step count;
  * a reference-layout ``.pth`` (``module.`` keys, the frozen resnet tail
    in the Adam group, a pickled OneCycle ``anneal_func``; the
    ``Reference`` of tests/test_torch_checkpoint_precision.py) warm-starts
    the CLI: the Adam moments carry on, the schedule and the step count
    start afresh;
  * a ``.ckpt`` of the JAX package: a full train state (written by its
    ``save_checkpoint``) goes on from its step with its Adam moments and
    the schedule at that step; a weights-only file (the port's
    ``cli.convert_checkpoint``) restores the weights and starts a fresh
    optimizer, each saying which it did;
  * ``--resnet_pretrained`` on a synthesized torchvision state dict gives
    the trunk that the JAX package's ``load_torchvision_resnet18`` gives,
    bit for bit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from rel_pose_tpu import config as jconfig
from rel_pose_tpu.utils.convert import (load_torch_checkpoint_with_optimizer,
                                        load_torchvision_resnet18)
from rel_pose_tpu_torch.cli import train as cli
from rel_pose_tpu_torch.config import ModelConfig
from rel_pose_tpu_torch.infer import PosePredictor
from rel_pose_tpu_torch.models.vitess import ViTEss
from rel_pose_tpu_torch.nn.init import seeded_state_dict
from rel_pose_tpu_torch.utils.convert import key_map, state_dict_from_jax
from test_cli import make_matterport_tree
from test_torch_checkpoint_precision import Reference
from test_torch_data import make_viewpoint_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FUSION = ["--transformer_depth", "2", "--fusion_transformer"]
DEPTH2 = ModelConfig(transformer_depth=2)


def run(name, *extra, datapath="matterport", batch=2):
    return cli.main(["--name", name, "--datapath", datapath, "--batch",
                     str(batch), "--no_ddp", "--num_workers", "1",
                     "--device", "cpu", "--transformer_depth", "2"]
                    + list(extra))


def ckpt(name, step):
    return os.path.join("output", name, "checkpoints", f"{step:06d}.pth")


def metrics(name):
    path = os.path.join("output", name, "runs", "metrics.jsonl")
    return [json.loads(line) for line in open(path)]


@pytest.fixture
def matterport(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    make_matterport_tree(str(tmp_path / "matterport"))
    return tmp_path


def test_train_checkpoint_resume_and_load_in_both_packages(matterport,
                                                           capsys):
    assert run("exp", "--steps", "2", "--ckpt_every", "1", "--warmup", "1",
               *FUSION) == 0
    out = capsys.readouterr().out
    assert "finished training!" in out
    assert "loading existing checkpoint" not in out
    assert os.path.exists(ckpt("exp", 1)) and os.path.exists(ckpt("exp", 2))
    assert run("exp", "--steps", "3", "--ckpt_every", "1", "--warmup", "1",
               *FUSION) == 0
    out = capsys.readouterr().out
    assert f"loading existing checkpoint {ckpt('exp', 2)}" in out
    third = torch.load(ckpt("exp", 3), weights_only=True)
    assert third["scheduler"]["last_epoch"] == 3
    assert {float(s["step"]) for s in third["optimizer"]["state"].values()} \
        == {3.0}
    assert all(np.isfinite(r["train_geo_loss_tr"]) for r in metrics("exp")
               if "train_geo_loss_tr" in r)

    path = ckpt("exp", 2)
    sd = torch.load(path, weights_only=True)["model"]
    pred = PosePredictor.from_checkpoint(path, DEPTH2, device="cpu")
    for k, v in pred.model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    jcfg = jconfig.ModelConfig(transformer_depth=2)
    params, state, adam = load_torch_checkpoint_with_optimizer(path, jcfg)
    back = state_dict_from_jax(jax.tree.map(np.asarray, params),
                               jax.tree.map(np.asarray, state), DEPTH2)
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    assert adam is not None and int(adam[2]) == 2


def test_subepoch_protocol(tmp_path, monkeypatch, capsys):
    """Two pairs at batch 2: one batch a subepoch.  11 steps cross
    subepochs 0-9 (10 train steps), the Matterport val subepoch (which does
    not advance the step count) and go on into epoch 1."""
    monkeypatch.chdir(tmp_path)
    make_matterport_tree(str(tmp_path / "matterport"), n=2)
    assert run("sub", "--steps", "11", "--ckpt_every", "100", "--warmup",
               "2", *FUSION) == 0
    out = capsys.readouterr().out
    assert "using val set" in out
    assert "epoch 1" in out
    assert "finished training!" in out
    assert "val_geo_loss_tr" in open(
        os.path.join("output", "sub", "runs", "metrics.jsonl")).read()
    assert sorted(os.listdir(os.path.join("output", "sub",
                                          "checkpoints"))) == ["000011.pth"]


def test_no_fusion_is_the_default(matterport, capsys):
    assert run("nf", "--steps", "2", "--warmup", "2") == 0
    assert "fusion_transformer=False" in capsys.readouterr().out
    keys = set(torch.load(ckpt("nf", 2), weights_only=True)["model"])
    assert keys == set(ViTEss(ModelConfig(fusion_transformer=False),
                              device="meta").state_dict())
    losses = [r["train_geo_loss_rot"] for r in metrics("nf")
              if "train_geo_loss_rot" in r]
    assert losses and np.isfinite(losses).all()


def test_interiornet_has_no_val_subepoch(tmp_path, monkeypatch, capsys):
    """20 pairs, 2 a subepoch, batch 2: 11 steps roll subepoch 9 straight
    into epoch 1, with no val pass."""
    monkeypatch.chdir(tmp_path)
    make_viewpoint_tree(str(tmp_path / "inet"))
    assert run("inet", "--dataset", "interiornet", "--steps", "11",
               "--ckpt_every", "100", "--warmup", "2",
               datapath="inet") == 0
    out = capsys.readouterr().out
    assert "finished training!" in out
    assert "using val set" not in out
    assert "epoch 1" in out
    assert "train_geo_loss_rot" in open(
        os.path.join("output", "inet", "runs", "metrics.jsonl")).read()


def test_ckpt_warm_start_restores_adam_with_a_fresh_step(matterport,
                                                         capsys):
    """A reference-layout ``.pth`` after two reference steps: one CLI step
    from it takes every parameter's Adam step to 3 (its moments carried:
    the second moment at least 0.999 of the file's), the schedule's step
    to 1 and the run's own peak lr."""
    port_sd = seeded_state_dict(ViTEss(DEPTH2, device="cpu"), seed=5)
    ref = Reference(port_sd)
    ref.step(0)
    ref.step(1)
    ref.save(matterport / "reference.pth")
    assert run("warm", "--ckpt", "reference.pth", "--steps", "1",
               "--warmup", "1", *FUSION) == 0
    assert "loading separate checkpoint reference.pth" in \
        capsys.readouterr().out
    got = torch.load(ckpt("warm", 1), weights_only=True)
    assert got["scheduler"]["last_epoch"] == 1
    group = got["optimizer"]["param_groups"][0]
    assert group["max_lr"] == 5e-4 and group["initial_lr"] == 5e-4 / 25
    names = [n for n, _ in ViTEss(DEPTH2, device="meta").named_parameters()]
    assert len(got["optimizer"]["state"]) == len(names)
    for i, name in enumerate(names):
        s, rs = got["optimizer"]["state"][i], ref.opt.state[ref.params[name]]
        assert float(s["step"]) == 3.0, name
        assert bool((s["exp_avg_sq"] >= 0.999 * rs["exp_avg_sq"]
                     * (1 - 1e-6)).all()), name


def _jax_train_state(cfg, step, rng):
    """The JAX package's train state of ``cfg`` from seeded weights, its
    Adam count, schedule count and step at ``step``, its moments seeded."""
    import jax.numpy as jnp
    from rel_pose_tpu.train import TrainState
    from rel_pose_tpu.train import make_optimizer as jmake_optimizer
    from rel_pose_tpu.utils.convert import convert_torch_state_dict
    sd = seeded_state_dict(ViTEss(cfg, device="meta"), seed=9)
    params, state = convert_torch_state_dict(
        sd, jconfig.ModelConfig(**cfg.__dict__))
    tx, _ = jmake_optimizer(5e-4, 10, 2)
    st = TrainState.create(params, state, tx)
    count = jnp.asarray(step, jnp.int32)
    adam = st.opt_state[2]._replace(
        count=count,
        mu=jax.tree.map(lambda a: jnp.asarray(
            1e-3 * rng.standard_normal(a.shape), jnp.float32),
            st.opt_state[2].mu),
        nu=jax.tree.map(lambda a: jnp.asarray(
            1e-6 * rng.uniform(0, 1, a.shape), jnp.float32),
            st.opt_state[2].nu))
    return st.replace(opt_state=(st.opt_state[0], st.opt_state[1], adam,
                                 st.opt_state[3]._replace(count=count)),
                      step=count), sd


def test_jax_ckpt_full_state_goes_on_from_its_step(matterport, capsys):
    """``--ckpt`` on a JAX full train state at step 2: the run says so,
    takes 1 step to ``--steps 3`` and saves 000003.pth with every Adam step
    at 3 (the file's 2, plus one), the schedule at 3, and the moments
    carried (the second moment at least 0.999 of the file's)."""
    from rel_pose_tpu.train.checkpoint import save_checkpoint
    st, _ = _jax_train_state(DEPTH2, 2, np.random.default_rng(3))
    save_checkpoint(str(matterport / "state.ckpt"), jax.device_get(st))
    assert run("jaxstate", "--ckpt", "state.ckpt", "--steps", "3",
               "--warmup", "2", "--ckpt_every", "100", *FUSION) == 0
    out = capsys.readouterr().out
    assert "loading separate checkpoint state.ckpt" in out
    assert "restored the full train state at step 2" in out
    assert sorted(os.listdir(os.path.join("output", "jaxstate",
                                          "checkpoints"))) == ["000003.pth"]
    got = torch.load(ckpt("jaxstate", 3), weights_only=True)
    assert got["scheduler"]["last_epoch"] == 3
    nu = {}
    for path, key, transpose in key_map(DEPTH2):
        if path[0] == "params":
            a = np.asarray(_lookup(st.opt_state[2].nu, path[1:]))
            nu[key] = a.T if transpose else a
    names = [n for n, _ in ViTEss(DEPTH2, device="meta").named_parameters()]
    for i, name in enumerate(names):
        s = got["optimizer"]["state"][i]
        assert float(s["step"]) == 3.0, name
        assert bool((s["exp_avg_sq"].numpy() >= 0.999 * nu[name]
                     * (1 - 1e-6)).all()), name


def test_jax_ckpt_weights_only_starts_a_fresh_optimizer(matterport, capsys):
    """``--ckpt`` on a weights-only ``.ckpt`` (``cli.convert_checkpoint``
    of a ``.pth``): the run says so, its one step starts from step 0 (Adam
    step 1, schedule at 1) and from the file's weights."""
    from rel_pose_tpu_torch.cli import convert_checkpoint
    sd = seeded_state_dict(ViTEss(DEPTH2, device="cpu"), seed=13)
    torch.save({"model": sd}, matterport / "w.pth")
    assert convert_checkpoint.main(["--ckpt", "w.pth", "--out", "w.ckpt",
                                    "--transformer_depth", "2"]) == 0
    assert run("weights", "--ckpt", "w.ckpt", "--steps", "1", "--warmup",
               "1", "--lr", "0", *FUSION) == 0
    out = capsys.readouterr().out
    assert "restored weights only" in out and "starts fresh" in out
    got = torch.load(ckpt("weights", 1), weights_only=True)
    assert got["scheduler"]["last_epoch"] == 1
    assert all(float(s["step"]) == 1.0
               for s in got["optimizer"]["state"].values())
    for k, v in sd.items():     # lr 0: the file's weights, untouched
        if not k.endswith(("running_mean", "running_var",
                           "num_batches_tracked")):
            torch.testing.assert_close(got["model"][k], v, rtol=0, atol=0)


def _lookup(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _torchvision_resnet18(path):
    """A torchvision-layout resnet18 file: the trunk's keys without the
    ``resnet.`` prefix (seeded values), a few tensors of the unused
    layer3 / fc, under ``"state_dict"`` with DDP's ``module.`` prefix."""
    sd = seeded_state_dict(ViTEss(ModelConfig(fusion_transformer=False),
                                  device="meta"), seed=23)
    tv = {k[len("resnet."):]: v for k, v in sd.items()
          if k.startswith("resnet.")}
    tv["layer3.0.conv1.weight"] = torch.ones(256, 128, 3, 3)
    tv["fc.weight"] = torch.ones(1000, 512)
    torch.save({"state_dict": {f"module.{k}": v for k, v in tv.items()}},
               path)
    return tv


def test_resnet_pretrained_trunk_is_jax_s(matterport, capsys):
    """The trunk ``--resnet_pretrained`` loads equals what the JAX
    package's ``load_torchvision_resnet18`` reads from the same file: the
    CLI's run at lr 0 (the parameters untouched by its one step) and
    ``load_resnet_pretrained`` on a fresh model (BatchNorm buffers too)."""
    tv = _torchvision_resnet18(matterport / "resnet18.pth")
    tp, ts = load_torchvision_resnet18(str(matterport / "resnet18.pth"))
    want = {}
    for path, key, _ in key_map(ModelConfig(fusion_transformer=False)):
        if path[1] == "resnet":
            node = {"params": tp, "state": ts}[path[0]]
            for p in path[2:]:
                node = node[p]
            want[key] = torch.from_numpy(np.array(node))
    assert len(want) == len(tv) - 2

    model = ViTEss(ModelConfig(fusion_transformer=False), device="cpu")
    cli.load_resnet_pretrained(model, str(matterport / "resnet18.pth"))
    sd = model.state_dict()
    for k, v in want.items():
        torch.testing.assert_close(sd[k], v.to(sd[k].dtype), rtol=0, atol=0)

    assert run("pre", "--resnet_pretrained", "resnet18.pth", "--lr", "0",
               "--steps", "1", "--warmup", "1") == 0
    assert "initialized conv trunk from resnet18.pth" in \
        capsys.readouterr().out
    trained = torch.load(ckpt("pre", 1), weights_only=True)["model"]
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(trained[k]) == int(v) + 1, k
        elif not k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(trained[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("extra,cuda,count,message", [
    (["--device", "cuda"], False, 0, "no CUDA device"),
    (["--device", "cuda", "--gpus", "3"], True, 2,
     "--gpus 3, but 2 GPUs are visible"),
    (["--device", "cpu", "--batch", "2"], False, 0,
     "unequal shards: the ranks were given --batch [2, 3]"),
    (["--device", "cpu", "--remat"], False, 0, "--remat"),
])
def test_refusals(tmp_path, monkeypatch, extra, cuda, count, message):
    """What the port cannot do is refused with a message before anything
    is written; nothing falls back to the CPU.  The unequal-shards case
    stands in a second rank that was given ``--batch 3``
    (``parallel.shard_sizes``, which gathers every rank's batch)."""
    from rel_pose_tpu_torch import parallel
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(parallel, "shard_sizes", lambda n: [n, n + 1])
    with pytest.raises(SystemExit) as e:
        cli.main(["--name", "refused", "--datapath", "matterport"] + extra)
    assert message in str(e.value)
    assert not os.path.exists("output")


def test_module_entry_refuses_without_a_gpu(tmp_path):
    """``python -m rel_pose_tpu_torch.cli.train`` defaults to the card: on
    a host without one it exits non-zero with the message."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "rel_pose_tpu_torch.cli.train",
                        "--name", "refused", "--datapath", "matterport"],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not os.path.exists(tmp_path / "output")
