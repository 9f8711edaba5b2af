"""PyTorch port vs the JAX package: the training step, its pieces, and
``.pth`` checkpoints.

The whole slice: ``ModelConfig(transformer_depth=2)``, B = 2 pairs of
256x256 uint8 images, fp32, the same numpy-seeded weights in both packages
(carried as in tests/test_torch_model.py).  JAX runs its unfused path
(``RELPOSE_NO_PALLAS=1``, pinned to the fused one by
tests/test_grad_triangulation.py); the port runs on the CPU, where its two
kernel-backed stages take their plain forward and backward versions.

Tolerances, with their reasons:

  * loss: rtol 1e-5 -- fp32, a ResNet trunk and two blocks summed in
    another order;
  * gradients, per leaf: ||g_port - g_jax|| <= 5e-3 ||g_jax|| (plus 1e-6
    of the largest leaf norm for leaves that are nearly zero) -- fp32
    rounding, not a different computation (the float64 test below): the
    leaves up to the extractor's first BatchNorm differ by 1.2e-3 - 3.1e-3
    relative (measured; 2.1e-3 - 2.3e-3 on resnet.conv1 and the 3x3 convs
    of layer1 and layer2), and each package's fp32 gradient is itself
    1e-3 - 5e-3 from the float64 one there: training BatchNorm's
    var = E[x^2] - mean^2 cancels large terms, and the trunk's divisions by
    batch deviations amplify the rounding.  The bound is 1.6x the largest
    measured gap.  The later leaves agree to 2e-5, the ViT and regressor
    leaves to 7e-6;
  * the same gradients in float64 (every fp32 cast of both packages made
    float64, in a child process): ||g_port - g_jax|| <= 1e-9 ||g_jax||
    (plus 1e-12 of the largest leaf norm), measured below 1e-13 on every
    leaf but the three conv biases that a BatchNorm follows, whose exact
    gradient is 0 (|g| ~ 1e-14);
  * BatchNorm running statistics: 1e-5 relative, counts exact;
  * 3 train steps: the loss of every step rtol 1e-4; the parameters'
    updates elementwise within 2 sum(lr) of the JAX ones, per leaf within
    25% in norm, the median leaf within 1% -- Adam's first steps move a
    weight by about lr * sign(g) whatever |g|, so the few elements whose
    gradient is near zero (about 0.1% in the trunk's conv leaves, measured)
    can step the other way; every other element agrees.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rel_pose_tpu import config as jconfig
from rel_pose_tpu.nn.layers import batchnorm_apply
from rel_pose_tpu.train import TrainState
from rel_pose_tpu.train import make_optimizer as jmake_optimizer
from rel_pose_tpu.train import make_train_step
from rel_pose_tpu.train.optim import onecycle_schedule
from rel_pose_tpu.train.step import make_loss_fn
from rel_pose_tpu.utils.convert import (convert_torch_state_dict,
                                        load_torch_checkpoint_with_optimizer)
from rel_pose_tpu_torch.config import ModelConfig
from rel_pose_tpu_torch.infer import PosePredictor
from rel_pose_tpu_torch.models.vitess import ViTEss
from rel_pose_tpu_torch.nn.init import seeded_state_dict
from rel_pose_tpu_torch.nn.layers import batchnorm_train
from rel_pose_tpu_torch.train import checkpoint as tckpt
from rel_pose_tpu_torch.train.optim import make_optimizer
from rel_pose_tpu_torch.train.step import eval_step, loss_fn, train_step
from rel_pose_tpu_torch.utils.convert import key_map, state_dict_from_jax

RNG = np.random.default_rng(29)
CFG = ModelConfig(transformer_depth=2)
LR, STEPS, WARMUP = 5e-4, 20, 5


def _jax_cfg(cfg):
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


def random_poses(rng, B):
    """(B, 2, 7): pose 0 the identity, pose 1 a random unit quaternion and
    a translation of about 0.5."""
    poses = np.zeros((B, 2, 7), np.float32)
    poses[..., 6] = 1.0
    q = rng.standard_normal((B, 4))
    q[:, 3] = np.abs(q[:, 3]) + 2.0          # rotations below ~60 degrees
    poses[:, 1, 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    poses[:, 1, :3] = 0.3 * rng.standard_normal((B, 3))
    return poses


@pytest.fixture(scope="module")
def setup():
    return _make_setup()


def _make_setup():
    sd = seeded_state_dict(ViTEss(CFG, device="meta"), seed=7)
    params, state = convert_torch_state_dict(sd, _jax_cfg(CFG))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    sd = state_dict_from_jax(to_np(params), to_np(state), CFG)
    B = 2
    batches = [(RNG.integers(0, 256, (B, 2, 3, 256, 256), dtype=np.uint8),
                random_poses(RNG, B),
                np.tile(np.float32([128, 128, 128, 128]), (B, 2, 1)))
               for _ in range(3)]
    return params, state, sd, batches


def _port_model(sd):
    model = ViTEss(CFG, device="cpu")
    model.load_state_dict(sd)
    return model


def _t(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def _lookup(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def jax_one_step(setup, monkeypatch_module):
    params, state, _, batches = setup
    images, poses, intr = batches[0]
    fn = make_loss_fn(_jax_cfg(CFG), 10.0, 10.0, "train")
    (loss, (new_bn, _, _)), grads = jax.value_and_grad(fn, has_aux=True)(
        params, state, jnp.asarray(images), jnp.asarray(poses),
        jnp.asarray(intr), True)
    return float(loss), grads, new_bn


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    mp.setenv("RELPOSE_NO_PALLAS", "1")
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def port_one_step(setup):
    _, _, sd, batches = setup
    model = _port_model(sd)
    model.train()
    loss, metrics, _ = loss_fn(model, *_t(batches[0]))
    loss.backward()
    return model, loss, metrics


def test_one_step_loss_matches_jax(jax_one_step, port_one_step):
    want, _, _ = jax_one_step
    _, loss, metrics = port_one_step
    assert set(metrics) == {"train_geo_loss_tr", "train_geo_loss_rot"}
    np.testing.assert_allclose(loss.item(), want, rtol=1e-5)


def test_one_step_gradients_match_jax(jax_one_step, port_one_step):
    _, grads, _ = jax_one_step
    model, _, _ = port_one_step
    named = dict(model.named_parameters())
    pairs = []
    for path, key, transpose in key_map(CFG):
        if path[0] != "params":
            continue
        want = _lookup(grads, path[1:])
        pairs.append((key, named[key].grad.numpy(),
                      want.T if transpose else want))
    assert len(pairs) == len(named)
    scale = max(np.linalg.norm(w) for _, _, w in pairs)
    bad = []
    for key, got, want in pairs:
        err = np.linalg.norm(got - want)
        if not err <= 5e-3 * np.linalg.norm(want) + 1e-6 * scale:
            bad.append(f"{key}: {err:.3e} vs |g| {np.linalg.norm(want):.3e}")
    assert not bad, bad


def test_one_step_gradients_match_jax_float64():
    """The one-step gradients of both packages in float64 agree to 1e-9:
    the fp32 gap above is rounding."""
    assert_float64_gradients_agree(float64_gradient_errors("flagship"), 75)


def float64_gradient_errors(which):
    """{key: (||g_port - g_jax||, ||g_jax||)} of the one-step gradients of
    ``which`` ("flagship": this file's setup, "noess":
    tests/test_torch_noess.py's, an ablation flag: that of
    tests/test_torch_ablations.py) in float64, computed by this file run as
    a script in a child process, so that x64 and the casts stay out of this
    one."""
    env = dict(os.environ, RELPOSE_NO_PALLAS="1", JAX_PLATFORMS="cpu")
    root = pathlib.Path(__file__).resolve().parent.parent
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in [env.get("PYTHONPATH")] if p])
    res = subprocess.run([sys.executable, __file__, which], env=env,
                         cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def assert_float64_gradients_agree(errs, n_leaves):
    """Every leaf within 1e-9 relative, plus 1e-12 of the largest leaf
    norm for the leaves whose exact gradient is 0."""
    assert len(errs) == n_leaves
    scale = max(norm for _, norm in errs.values())
    bad = [f"{k}: {err:.3e} vs |g| {norm:.3e}" for k, (err, norm)
           in errs.items() if not err <= 1e-9 * norm + 1e-12 * scale]
    assert not bad, bad


def _float64_one_step_gradients(cfg, setup):
    """The child of :func:`float64_gradient_errors`: it sets JAX's x64 flag
    and makes every fp32 cast of both packages float64 (``jnp.float32``,
    ``torch.float32``, ``Tensor.float`` and the port's compute dtype), then
    takes one loss gradient of each on ``setup``'s first batch."""
    import rel_pose_tpu_torch.models.vitess as tvitess
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    torch.float32 = torch.float64
    torch.Tensor.float = lambda self, *a, **k: self.double()
    tvitess.ViTEss.compute_dtype = property(lambda self: torch.float64)

    params, state, sd, batches = setup
    f64 = lambda tree: jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64
                              if np.asarray(a).dtype == np.float32
                              else None), tree)
    images, poses, intr = (batches[0][0], batches[0][1].astype(np.float64),
                           batches[0][2].astype(np.float64))
    fn = make_loss_fn(_jax_cfg(cfg), 10.0, 10.0, "train")
    (_, _), grads = jax.value_and_grad(fn, has_aux=True)(
        f64(params), f64(state), jnp.asarray(images), jnp.asarray(poses),
        jnp.asarray(intr), True)

    model = ViTEss(cfg, device="cpu")
    model.load_state_dict(sd)
    model.double().train()
    loss, _, _ = loss_fn(model, torch.from_numpy(images),
                         torch.from_numpy(poses), torch.from_numpy(intr))
    loss.backward()
    named = dict(model.named_parameters())
    out = {}
    for path, key, transpose in key_map(cfg):
        if path[0] == "params":
            want = _lookup(grads, path[1:])
            want = want.T if transpose else want
            out[key] = (float(np.linalg.norm(named[key].grad.numpy() - want)),
                        float(np.linalg.norm(want)))
    return out


def test_one_step_bn_state_matches_jax(jax_one_step, port_one_step):
    _, _, new_bn = jax_one_step
    model, _, _ = port_one_step
    sd = model.state_dict()
    n = 0
    for path, key, _ in key_map(CFG):
        if path[0] != "state":
            continue
        want = _lookup(new_bn, path[1:])
        got = sd[key].numpy()
        if key.endswith("num_batches_tracked"):
            assert got == want == 1, key
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=key)
        n += 1
    assert n == 3 * 13          # 13 BatchNorms: trunk and extractor


def test_three_steps_match_jax(setup, monkeypatch_module):
    params, state, sd, batches = setup
    tx, jsched = jmake_optimizer(LR, STEPS, WARMUP)
    step_fn = make_train_step(_jax_cfg(CFG), tx)
    # the step donates its state: hand it copies of the shared weights
    jstate = TrainState.create(jax.tree.map(jnp.array, params),
                               jax.tree.map(jnp.array, state), tx)
    model = _port_model(sd)
    opt, sched = make_optimizer(model, LR, STEPS, WARMUP)
    for batch in batches:
        jstate, jmetrics, _ = step_fn(jstate, *map(jnp.asarray, batch))
        metrics, poses = train_step(model, opt, sched, *_t(batch))
        np.testing.assert_allclose(metrics["loss"].item(),
                                   float(jmetrics["loss"]), rtol=1e-4)
        assert poses.shape == (2, 2, 7) and not poses.requires_grad
    assert sched.last_epoch == 3
    lr_sum = sum(float(jsched(k)) for k in range(3))
    after = dict(model.named_parameters())
    rel = []
    for path, key, transpose in key_map(CFG):
        if path[0] != "params":
            continue
        before = _lookup(params, path[1:])
        want = _lookup(jstate.params, path[1:]) - before
        if transpose:
            before, want = before.T, want.T
        got = after[key].detach().numpy() - before
        assert np.abs(got - want).max() <= 2 * lr_sum, key
        rel.append(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert max(rel) <= 0.25 and np.median(rel) <= 1e-2, (max(rel),
                                                         np.median(rel))


def test_eval_step_leaves_state_alone(setup):
    _, _, sd, batches = setup
    model = _port_model(sd)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics, poses = eval_step(model, *_t(batches[0]))
    assert set(metrics) == {"val_geo_loss_tr", "val_geo_loss_rot", "loss"}
    assert not model.training and poses.shape == (2, 2, 7)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 64, 12, 12), (3, 8, 5, 7)])
def test_batchnorm_train_matches_jax(shape):
    x = (RNG.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    C = shape[1]
    bn = torch.nn.BatchNorm2d(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(
            1 + 0.1 * RNG.standard_normal(C).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(
            0.1 * RNG.standard_normal(C).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(
            0.1 * RNG.standard_normal(C).astype(np.float32)))
        bn.running_var.uniform_(0.5, 1.5)
    jparams = {"scale": jnp.asarray(bn.weight.detach().numpy()),
               "bias": jnp.asarray(bn.bias.detach().numpy())}
    jstate = {"mean": jnp.asarray(bn.running_mean.numpy()),
              "var": jnp.asarray(bn.running_var.numpy()),
              "count": jnp.zeros((), jnp.int32)}
    want, new = batchnorm_apply(jparams, jstate, jnp.asarray(x), True)
    got = batchnorm_train(torch.from_numpy(x), bn)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["var"]), rtol=1e-6)
    assert int(bn.num_batches_tracked) == int(new["count"]) == 1


def test_onecycle_schedule_matches_jax():
    """The lr of every update over 20 steps with warmup 5 (fp32 schedule
    on the JAX side: 1e-6 relative)."""
    model = torch.nn.Linear(2, 2)
    opt, sched = make_optimizer(model, LR, STEPS, WARMUP)
    want = onecycle_schedule(LR, STEPS, WARMUP)
    for k in range(STEPS):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(want(k)), rtol=1e-6, err_msg=k)
        opt.step()
        sched.step()


def test_checkpoint_roundtrip_and_resume(setup, tmp_path):
    """A written ``.pth`` reloads into the port, resumes the newest step,
    serves through ``PosePredictor.from_checkpoint``, and loads in the JAX
    package's converter to the same weights and Adam moments."""
    _, _, sd, batches = setup
    model = _port_model(sd)
    opt, sched = make_optimizer(model, LR, STEPS, WARMUP)
    train_step(model, opt, sched, *_t(batches[0]))
    for step in (1, 2):
        tckpt.save_checkpoint(
            tckpt.checkpoint_path("run", step, str(tmp_path)), model, opt,
            sched)
    path = tckpt.find_resume_checkpoint("run", str(tmp_path))
    assert path.endswith("000002.pth")
    assert not [p for p in (tmp_path / "run" / "checkpoints").iterdir()
                if p.suffix == ".tmp"]
    fresh = _port_model(sd)
    opt2, sched2 = make_optimizer(fresh, LR, STEPS, WARMUP)
    assert tckpt.resume("run", fresh, opt2, sched2, str(tmp_path)) == 1
    assert tckpt.resume("none", fresh, opt2, sched2, str(tmp_path)) == 0
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    assert opt2.state_dict()["state"].keys() == \
        opt.state_dict()["state"].keys()

    pred = PosePredictor.from_checkpoint(path, CFG, device="cpu")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(pred.model.state_dict()[k], v, rtol=0,
                                   atol=0)

    jparams, jstate, adam = load_torch_checkpoint_with_optimizer(
        path, _jax_cfg(CFG))
    got = state_dict_from_jax(jax.tree.map(np.asarray, jparams),
                              jax.tree.map(np.asarray, jstate), CFG)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    mu, _, count = adam
    assert count == 1
    np.testing.assert_array_equal(
        np.asarray(mu["pos_embed"]),
        opt.state_dict()["state"][_param_index(
            model, "fusion_transformer.pos_embed")]["exp_avg"].numpy())


def _param_index(model, key):
    return [k for k, _ in model.named_parameters()].index(key)


if __name__ == "__main__":
    if sys.argv[1] == "noess":
        import test_torch_noess
        args = test_torch_noess.CFG, test_torch_noess.make_setup()
    elif sys.argv[1] == "flagship":
        args = CFG, _make_setup()
    else:   # an ablation flag of tests/test_torch_ablations*.py
        import test_torch_ablations
        args = test_torch_ablations.float64_case(sys.argv[1])
    print(json.dumps(_float64_one_step_gradients(*args)))
