"""The port's sharded ``PosePredictor`` and the eval CLIs over it, on the CPU.

``infer.local_devices`` is replaced by ``[cpu, cpu]``: two replicas of
the model on the CPU, the port's counterpart of the JAX tests' 8 virtual
CPU devices.  The sharded predictor is held

  * against the JAX package's ``PosePredictor(shard=True)`` over its 8
    virtual devices, same weights (``utils/convert.py``) and inputs, fp32,
    within 2e-5: the bound that holds the port's eval forward to JAX's
    (``tests/test_torch_model.py``), with the plain stem on the JAX side
    (``RELPOSE_NO_S2D_STEM=1``) as there;
  * against its own unsharded run within 1e-5 (the JAX test's bound):
    eval-mode BatchNorm does not depend on the batch, and a convolution on
    half the batch sums in another order at most.

The Matterport eval CLI over two local devices prints the JAX CLI's line
and writes the one-device run's CSVs (bit for bit where each replica runs
the one device's batch; see the test for the other case).  Tiny models as
``tests/test_infer.py``'s (depth 2, 8x8 features) for the predictor,
depth 2 at full width for the CLI.
"""

import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from rel_pose_tpu import config as jconfig
from rel_pose_tpu.infer import PosePredictor as JaxPosePredictor
from rel_pose_tpu.utils.convert import convert_torch_state_dict
from rel_pose_tpu_torch import infer
from rel_pose_tpu_torch.cli import test_matterport as port_mp
from rel_pose_tpu_torch.config import ModelConfig
from rel_pose_tpu_torch.models.vitess import ViTEss
from rel_pose_tpu_torch.nn.init import seeded_state_dict
from rel_pose_tpu_torch.tools.convergence_run import build_tree
from rel_pose_tpu_torch.utils.convert import state_dict_from_jax

TINY = ModelConfig(transformer_depth=2, feature_height=8, feature_width=8,
                   pool_size=8, fc_hidden_size=64)
INTR = np.array([517.97, 517.97, 64.0, 48.0], np.float32)
CPU2 = [torch.device("cpu"), torch.device("cpu")]


@pytest.fixture(scope="module")
def weights():
    """The tiny model's JAX pytrees and the port's state dict from them."""
    sd = seeded_state_dict(ViTEss(TINY, device="meta"), seed=5)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(TINY))
    params, state = convert_torch_state_dict(sd, jcfg)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return jcfg, params, state, state_dict_from_jax(to_np(params),
                                                    to_np(state), TINY)


def _model(sd):
    model = ViTEss(TINY, device="cpu")
    model.load_state_dict(sd)
    return model


def _images(b, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, 2, 3, 96, 128), dtype=np.uint8)


@pytest.fixture
def two_cpus(monkeypatch):
    monkeypatch.setattr(infer, "local_devices", lambda device: CPU2)


def test_sharded_matches_jax_sharded(weights, two_cpus, monkeypatch):
    monkeypatch.setenv("RELPOSE_NO_S2D_STEM", "1")
    jcfg, params, state, sd = weights
    images = _images(8)
    want = JaxPosePredictor(params, state, jcfg, intrinsics=INTR,
                            batch_size=8, shard=True)
    assert want.mesh is not None and want.mesh.size == 8
    got = infer.PosePredictor(_model(sd), intrinsics=INTR, batch_size=8)
    assert got.devices == CPU2 and len(got.replicas) == 2
    np.testing.assert_allclose(got.predict_batch(images),
                               want.predict_batch(images), rtol=0, atol=2e-5)


def _record_batches(predictor):
    """Each replica's input batch sizes, appended as it runs."""
    seen = [[] for _ in predictor.replicas]
    for i, m in enumerate(predictor.replicas):
        m.register_forward_pre_hook(
            lambda mod, args, i=i: seen[i].append(args[0].shape[0]))
    return seen


def test_sharded_equals_unsharded(weights, two_cpus):
    """5 pairs at batch_size 4: two chunks (the tail padded), each split
    2 + 2 over the replicas, equal to one device's run."""
    sd = weights[3]
    images = _images(5, seed=1)
    sharded = infer.PosePredictor(_model(sd), intrinsics=INTR, batch_size=4)
    single = infer.PosePredictor(_model(sd), intrinsics=INTR, batch_size=4,
                                 shard=False)
    assert single.devices == [torch.device("cpu")]
    assert sharded.replicas[0] is sharded.model
    assert sharded.replicas[1] is not sharded.model
    for a, b in zip(sharded.replicas[1].state_dict().values(),
                    sharded.model.state_dict().values()):
        assert torch.equal(a, b)
    seen = _record_batches(sharded)
    np.testing.assert_allclose(sharded.predict_batch(images),
                               single.predict_batch(images), rtol=0,
                               atol=1e-5)
    assert seen == [[2, 2], [2, 2]]


@pytest.mark.parametrize("kwargs", [
    {"batch_size": 4, "shard": False},     # asked not to
    {"batch_size": 3},                      # 3 does not divide 2 devices
    {"batch_size": None},                   # no fixed batch
])
def test_unsharded_cases(weights, two_cpus, kwargs):
    sd = weights[3]
    pred = infer.PosePredictor(_model(sd), intrinsics=INTR, **kwargs)
    assert pred.devices == [torch.device("cpu")]
    assert pred.replicas == [pred.model]
    seen = _record_batches(pred)
    assert pred.predict_batch(_images(2)).shape == (2, 2, 7)
    assert seen == [[kwargs["batch_size"] or 2]]


def test_warmup_touches_every_replica(weights, two_cpus):
    pred = infer.PosePredictor(_model(weights[3]), intrinsics=INTR,
                               batch_size=4, image_size=(96, 128))
    seen = _record_batches(pred)
    assert pred.warmup() is pred
    assert seen == [[2], [2]]


def test_local_devices(monkeypatch):
    """The CPU alone; every visible GPU, the model's first."""
    assert infer.local_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert infer.local_devices("cuda:1") == [
        torch.device("cuda", i) for i in (1, 2, 0)]


def _csvs(out):
    return [np.loadtxt(os.path.join(out, f), delimiter=",")
            for f in ("gt_translation_magnitude_vs_error.csv",
                      "gt_rotation_magnitude_vs_error.csv")]


def test_eval_cli_shards(tmp_path, monkeypatch, capsys):
    """The Matterport CLI over two local devices prints the JAX CLI's
    line.  At --batch 4 each replica runs the 2 pairs a one-device run at
    --batch 2 runs: the CSVs are equal bit for bit.  At the same --batch 2
    each replica runs 1 pair, and a convolution sums a batch of 1 in
    another order on the CPU: translations within 1e-5 m, rotation errors
    within 1e-3 degrees (poses within ~1e-6; near 110-180 degrees arccos
    multiplies a rounding of the cosine by 2 / sin(angle / 2), as
    tests/test_torch_eval_cli.py sets out).  A --batch the devices do not
    divide says so."""
    monkeypatch.chdir(tmp_path)
    build_tree("matterport", n_pairs=4, hw=(120, 160), distinct=True)
    cfg = ModelConfig(transformer_depth=2, fc_hidden_size=64)
    torch.save({"model": seeded_state_dict(ViTEss(cfg, device="meta"), 3)},
               "model.pth")
    flags = ["--datapath", "matterport", "--ckpt", "model.pth",
             "--device", "cpu", "--transformer_depth", "2",
             "--fusion_transformer", "--fc_hidden_size", "64"]
    assert port_mp.main(["--exp", "one", "--batch", "2"] + flags) == 0
    assert "sharded" not in capsys.readouterr().out
    monkeypatch.setattr(infer, "local_devices", lambda device: CPU2)
    for exp, batch in (("four", "4"), ("two", "2")):
        assert port_mp.main(["--exp", exp, "--batch", batch] + flags) == 0
        assert "eval sharded over 2 local devices" in capsys.readouterr().out
    one = _csvs("output/one/matterport_test")
    for a, b in zip(one, _csvs("output/four/matterport_test")):
        np.testing.assert_array_equal(b, a)
    for a, b, tol in zip(one, _csvs("output/two/matterport_test"),
                         (1e-5, 1e-3)):
        np.testing.assert_allclose(b, a, rtol=0, atol=tol)
    assert port_mp.main(["--exp", "odd", "--batch", "3"] + flags) == 0
    assert ("NOTE: --batch 3 is not divisible by the 2 local devices"
            in capsys.readouterr().out)
