"""PyTorch port vs the JAX package: the no-fusion baseline.

``ModelConfig(fusion_transformer=False)`` (the training CLIs' default): the
ResNet trunk and the extractor, the first 96 channels reshaped row-major to
(B, 24, 24, 192), the ``pool_transformer_output`` 1x1 conv head and the
regressor; no hand kernel runs.  The same numpy-seeded weights go to both
packages (drawn at the reference state-dict shapes, converted by the JAX
package's ``convert_torch_state_dict`` and carried back by
``state_dict_from_jax``); the JAX package runs its plain path
(``RELPOSE_NO_PALLAS=1``), the port the CPU.

Tolerances, with their reasons (measured values in brackets):

  * eval poses (B, 2, 7): fp32 atol 2e-5 [5e-7], a ResNet trunk, the pool
    head and a 34,560-wide regressor summed in another order; bf16 atol
    2e-2 [5e-4], one-ulp (2^-8) flips of the bf16 activations, rounded at
    other points by the two packages, reach the fp32 regressor;
  * one train step (JAX's loss and gradients under one ``jax.jit``): loss
    rtol 1e-5 [1.5e-6]; per-leaf gradients ||g_port - g_jax|| <= rtol
    ||g_jax|| plus 1e-6 of the largest leaf norm, rtol 1e-4 [1.3e-5] on the
    pool head and the regressor and 2e-2 [8.1e-3] on the ResNet trunk and
    the extractor: fp32 rounding of training BatchNorm, amplified through
    the trunk as in tests/test_torch_train.py and tests/test_torch_noess.py,
    not another computation: in float64 every one of the 56 leaves agrees
    to 1e-9 [3.2e-14 relative; the five conv biases ahead of a BatchNorm,
    whose exact gradient is 0, within 4.5e-14 absolute of a largest leaf
    norm of 2.6e3] (tests/test_torch_nofusion_f64.py);
    BatchNorm running statistics 1e-5 relative, counts exact;
  * 3 train steps: every loss rtol 2e-3 [1.5e-6, 6.9e-5, 1.8e-4 at steps
    1-3]; the updates elementwise within 2 sum(lr) of the JAX ones, per leaf
    within 25% in norm [11%], the median leaf within 5% [3.2%], as
    tests/test_torch_noess.py bounds them, for the same reason: Adam's
    first steps move a weight by about lr * sign(g) whatever |g|.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rel_pose_tpu import config as jconfig
from rel_pose_tpu.models import vitess_forward
from rel_pose_tpu.train import TrainState
from rel_pose_tpu.train import make_optimizer as jmake_optimizer
from rel_pose_tpu.train import make_train_step
from rel_pose_tpu.train.step import make_loss_fn
from rel_pose_tpu.utils.convert import (build_key_maps,
                                        convert_torch_state_dict)
from rel_pose_tpu_torch.config import ModelConfig
from rel_pose_tpu_torch.infer import PosePredictor
from rel_pose_tpu_torch.models.vitess import ViTEss
from rel_pose_tpu_torch.nn.init import seeded_state_dict
from rel_pose_tpu_torch.train import checkpoint as tckpt
from rel_pose_tpu_torch.train.optim import make_optimizer
from rel_pose_tpu_torch.train.step import loss_fn, train_step
from rel_pose_tpu_torch.utils.convert import key_map, state_dict_from_jax
from test_torch_train import jax_value_and_grad, random_poses

RNG = np.random.default_rng(61)
CFG = ModelConfig(fusion_transformer=False)
LR, STEPS, WARMUP = 5e-4, 20, 5
INTERIORNET = np.float32([128, 128, 128, 128])
_TRUNK = ("resnet.", "extractor_final_conv.")
_HEAD = "pool_transformer_output"


def _jax_cfg(cfg):
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


def make_setup(cfg=CFG, seed=13):
    """(JAX params, JAX state, port state dict, 3 batches of 2 pairs)."""
    rng = np.random.default_rng(67)
    sd = seeded_state_dict(ViTEss(cfg, device="meta"), seed=seed)
    params, state = convert_torch_state_dict(sd, _jax_cfg(cfg))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    sd = state_dict_from_jax(to_np(params), to_np(state), cfg)
    B = 2
    batches = [(rng.integers(0, 256, (B, 2, 3, 256, 256), dtype=np.uint8),
                random_poses(rng, B), np.tile(INTERIORNET, (B, 2, 1)))
               for _ in range(3)]
    return params, state, sd, batches


def float64_case():
    """(cfg, setup) for the float64 child of tests/test_torch_train.py."""
    return CFG, make_setup()


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.fixture(scope="module")
def no_pallas():
    mp = pytest.MonkeyPatch()
    mp.setenv("RELPOSE_NO_PALLAS", "1")
    yield mp
    mp.undo()


def _port_model(sd, cfg=CFG, dtype="float32", **kwargs):
    model = ViTEss(dataclasses.replace(cfg, compute_dtype=dtype),
                   device="cpu", **kwargs)
    model.load_state_dict(sd)
    return model


def _t(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def _lookup(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def _torch_keys(spec, out):
    if isinstance(spec, tuple) and isinstance(spec[0], str):
        out.append((spec[0], spec[1] == "T"))
    elif isinstance(spec, dict):
        for v in spec.values():
            _torch_keys(v, out)
    else:
        for v in spec:
            _torch_keys(v, out)
    return out


@pytest.mark.parametrize("overrides", [{}, {"pool_size": 30},
                                       {"fc_hidden_size": 256}])
def test_key_map_matches_jax_build_key_maps(overrides):
    """The port's key map lists the same state-dict keys, with the same
    transposes, as the JAX package's ``build_key_maps`` for no-fusion, and
    they are the model's keys: ``pool_transformer_output.{0,1,3,4}``, no
    ``fusion_transformer``."""
    cfg = dataclasses.replace(CFG, **overrides)
    pmap, smap = build_key_maps(_jax_cfg(cfg))
    want = sorted(_torch_keys(pmap, []) + _torch_keys(smap, []))
    got = sorted((key, transpose) for _, key, transpose in key_map(cfg))
    assert got == want
    assert {k for k, _ in got} == set(
        ViTEss(cfg, device="meta").state_dict())


@pytest.mark.parametrize("dtype,atol,overrides", [
    ("float32", 2e-5, {}), ("bfloat16", 2e-2, {}),
    ("float32", 2e-5, {"pool_size": 30, "fc_hidden_size": 256}),
])
def test_eval_forward_matches_jax(setup, monkeypatch, dtype, atol,
                                  overrides):
    if overrides:
        params, state, sd, _ = make_setup(
            dataclasses.replace(CFG, **overrides), seed=17)
    else:
        params, state, sd, _ = setup
    monkeypatch.setenv("RELPOSE_NO_S2D_STEM", "1")
    images = RNG.integers(0, 256, (2, 2, 3, 256, 256), dtype=np.uint8)
    K = np.tile(INTERIORNET, (2, 2, 1))
    cfg = dataclasses.replace(CFG, compute_dtype=dtype, **overrides)
    want, _ = vitess_forward(params, state, _jax_cfg(cfg),
                             jnp.asarray(images), jnp.asarray(K),
                             training=False)
    with torch.no_grad():
        got = _port_model(sd, cfg, dtype)(torch.from_numpy(images),
                                          torch.from_numpy(K))
    assert got.dtype == torch.float32 and got.shape == (2, 2, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def one_step(setup, no_pallas):
    params, state, sd, batches = setup
    images, poses, intr = batches[0]
    fn = make_loss_fn(_jax_cfg(CFG), 10.0, 10.0, "train")
    (jloss, (new_bn, _, _)), grads = jax_value_and_grad(fn)(
        params, state, jnp.asarray(images), jnp.asarray(poses),
        jnp.asarray(intr), True)
    model = _port_model(sd)
    model.train()
    loss, _, _ = loss_fn(model, *_t(batches[0]))
    loss.backward()
    return float(jloss), grads, new_bn, model, loss.item()


def test_one_step_loss_and_gradients_match_jax(one_step):
    jloss, grads, _, model, loss = one_step
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    named = dict(model.named_parameters())
    pairs = []
    for path, key, transpose in key_map(CFG):
        if path[0] == "params":
            want = _lookup(grads, path[1:])
            pairs.append((key, named[key].grad.numpy(),
                          want.T if transpose else want))
    assert len(pairs) == len(named)
    assert {f"{_HEAD}.0.weight", f"{_HEAD}.4.bias"} <= {k for k, _, _ in
                                                        pairs}
    scale = max(np.linalg.norm(w) for _, _, w in pairs)
    bad = []
    for key, got, want in pairs:
        rtol = 2e-2 if key.startswith(_TRUNK) else 1e-4
        err, norm = np.linalg.norm(got - want), np.linalg.norm(want)
        if not err <= rtol * norm + 1e-6 * scale:
            bad.append(f"{key}: {err:.3e} vs |g| {norm:.3e}")
    assert not bad, bad


def test_one_step_bn_state_matches_jax(one_step):
    _, _, new_bn, model, _ = one_step
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
    assert n == 3 * 15          # 13 BatchNorms of trunk and extractor, 2 of
    #                             the pool head


def test_three_steps_match_jax(setup, no_pallas):
    params, state, sd, batches = setup
    tx, jsched = jmake_optimizer(LR, STEPS, WARMUP)
    step_fn = make_train_step(_jax_cfg(CFG), tx)
    jstate = TrainState.create(jax.tree.map(jnp.array, params),
                               jax.tree.map(jnp.array, state), tx)
    model = _port_model(sd)
    opt, sched = make_optimizer(model, LR, STEPS, WARMUP)
    for batch in batches:
        jstate, jmetrics, _ = step_fn(jstate, *map(jnp.asarray, batch))
        metrics, poses = train_step(model, opt, sched, *_t(batch))
        np.testing.assert_allclose(metrics["loss"].item(),
                                   float(jmetrics["loss"]), rtol=2e-3)
        assert poses.shape == (2, 2, 7)
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
    assert max(rel) <= 0.25 and np.median(rel) <= 5e-2, (max(rel),
                                                         np.median(rel))


def test_train_step_moves_pool_head_and_resumes(setup, tmp_path):
    """A no-fusion train step moves ``pool_transformer_output``'s
    BatchNorm state; a checkpoint written after step 1 resumes step 2 bit
    for bit and serves through ``PosePredictor.from_checkpoint``."""
    _, _, sd, batches = setup
    model = _port_model(sd)
    opt, sched = make_optimizer(model, LR, STEPS, WARMUP)
    train_step(model, opt, sched, *_t(batches[0]))
    state = model.state_dict()
    for bn in (f"{_HEAD}.1", f"{_HEAD}.4"):
        assert not torch.equal(state[f"{bn}.running_mean"],
                               sd[f"{bn}.running_mean"])
        assert int(state[f"{bn}.num_batches_tracked"]) == 1
    tckpt.save_checkpoint(tckpt.checkpoint_path("nf", 1, str(tmp_path)),
                          model, opt, sched)
    metrics, _ = train_step(model, opt, sched, *_t(batches[1]))

    fresh = _port_model(sd)
    opt2, sched2 = make_optimizer(fresh, LR, STEPS, WARMUP)
    assert tckpt.resume("nf", fresh, opt2, sched2, str(tmp_path)) == 1
    metrics2, _ = train_step(fresh, opt2, sched2, *_t(batches[1]))
    assert metrics2["loss"].item() == metrics["loss"].item()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)

    path = tckpt.find_resume_checkpoint("nf", str(tmp_path))
    pred = PosePredictor.from_checkpoint(path, CFG, device="cpu",
                                         intrinsics=INTERIORNET)
    images = batches[2][0]
    with torch.no_grad():
        want = _port_model(torch.load(path, weights_only=True)["model"])(
            torch.from_numpy(images), torch.from_numpy(batches[2][2]))
    np.testing.assert_array_equal(pred.predict_batch(images), want.numpy())
