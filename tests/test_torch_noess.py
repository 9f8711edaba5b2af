"""PyTorch port vs the JAX package: the --noess ViTEss.

``ModelConfig(noess=True, transformer_depth=2)``, with the same
numpy-seeded weights in both packages (drawn at the reference state-dict
shapes, converted by the JAX package's ``convert_torch_state_dict`` and
carried back by ``state_dict_from_jax``).  The JAX package runs its plain
path (``RELPOSE_NO_PALLAS=1``: ``mhsa_reference`` and autodiff where the
TPU runs Pallas kernel #7); the port runs on the CPU, where ``fused_mhsa``
takes its plain forward and backward versions.

Tolerances, with their reasons (measured values in brackets):

  * ``noess_cross_attention``: fp32 1e-5 [1e-6] relative, sum order;
  * eval poses (B, 2, 7): fp32 atol 2e-5 [1e-6], a ResNet trunk, two
    blocks, the pool head and a 24,768-wide regressor summed in another
    order; bf16 atol 2e-2 [6e-3]: the two packages round bf16 at different
    points inside the ViT block (tests/test_torch_model.py) and one-ulp
    flips (2^-8) reach the fp32 regressor;
  * one train step (JAX's loss and gradients under one ``jax.jit``): loss
    rtol 1e-5 [4e-6]; per-leaf gradients ||g_port - g_jax|| <= rtol
    ||g_jax|| plus 1e-6 of the largest leaf norm, rtol 1e-4 [2.5e-5] from
    the ViT on (pos_embed, the blocks, pool_attn, the regressor) and 2e-2
    [7.9e-3] on the ResNet trunk and the extractor: fp32 rounding of
    training BatchNorm, amplified through the trunk as in
    tests/test_torch_train.py (larger here: the pool head's BatchNorms
    scale the trunk's gradients up tenfold).  In float64 every leaf agrees
    to 1e-9 [4e-14] (tests/test_torch_noess_f64.py); BatchNorm running
    statistics 1e-5 relative, counts
    exact;
  * 3 train steps: every loss rtol 2e-3 [4e-6, 2e-4, 7e-4 at steps 1-3];
    the updates elementwise within 2 sum(lr) of the JAX ones, per leaf
    within 25% in norm [6%], the median leaf within 5% [2.9%].  Looser than
    tests/test_torch_train.py's 1e-4 and 1%, for the trunk's larger fp32
    noise: Adam's first steps move a weight by about lr * sign(g) whatever
    |g|, so more of the trunk's near-zero gradient elements step the other
    way, and the next steps' losses and gradients carry that on.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rel_pose_tpu import config as jconfig
from rel_pose_tpu.models import vitess_forward
from rel_pose_tpu.ops.essential import \
    noess_cross_attention as jnoess_cross_attention
from rel_pose_tpu.train import TrainState
from rel_pose_tpu.train import make_optimizer as jmake_optimizer
from rel_pose_tpu.train import make_train_step
from rel_pose_tpu.train.step import make_loss_fn
from rel_pose_tpu.utils.convert import convert_torch_state_dict
from rel_pose_tpu_torch.config import ModelConfig
from rel_pose_tpu_torch.infer import PosePredictor
from rel_pose_tpu_torch.models.vitess import ViTEss
from rel_pose_tpu_torch.nn.init import seeded_state_dict
from rel_pose_tpu_torch.ops.attention import mhsa_reference
from rel_pose_tpu_torch.ops.essential import noess_cross_attention
from rel_pose_tpu_torch.train import checkpoint as tckpt
from rel_pose_tpu_torch.train.optim import make_optimizer
from rel_pose_tpu_torch.train.step import loss_fn, train_step
from rel_pose_tpu_torch.utils.convert import key_map, state_dict_from_jax
from test_torch_train import jax_value_and_grad, random_poses

RNG = np.random.default_rng(53)
CFG = ModelConfig(noess=True, transformer_depth=2)
LR, STEPS, WARMUP = 5e-4, 20, 5
INTERIORNET = np.float32([128, 128, 128, 128])
# the leaves below the ViT, whose fp32 gradients carry BatchNorm rounding
_TRUNK = ("resnet.", "extractor_final_conv.")


def _jax_cfg(cfg):
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


def make_setup():
    """(JAX params, JAX state, port state dict, 3 batches of 2 pairs) from
    their own seeds."""
    rng = np.random.default_rng(59)
    sd = seeded_state_dict(ViTEss(CFG, device="meta"), seed=11)
    params, state = convert_torch_state_dict(sd, _jax_cfg(CFG))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    sd = state_dict_from_jax(to_np(params), to_np(state), CFG)
    B = 2
    batches = [(rng.integers(0, 256, (B, 2, 3, 256, 256), dtype=np.uint8),
                random_poses(rng, B), np.tile(INTERIORNET, (B, 2, 1)))
               for _ in range(3)]
    return params, state, sd, batches


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.fixture(scope="module")
def no_pallas():
    mp = pytest.MonkeyPatch()
    mp.setenv("RELPOSE_NO_PALLAS", "1")
    yield mp
    mp.undo()


def _port_model(sd, dtype="float32", **kwargs):
    model = ViTEss(dataclasses.replace(CFG, compute_dtype=dtype),
                   device="cpu", **kwargs)
    model.load_state_dict(sd)
    return model


def _t(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def _lookup(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


def test_noess_cross_attention_matches_jax():
    B, N, C, heads = 2, 64, 192, 3
    x1, x2 = (RNG.standard_normal((B, N, C)).astype(np.float32)
              for _ in range(2))
    w = {k: (RNG.standard_normal(shape) * C ** -0.5).astype(np.float32)
         for k, shape in (("qkv_w", (3 * C, C)), ("qkv_b", (3 * C,)),
                          ("proj_w", (C, C)), ("proj_b", (C,)))}
    jparams = {"qkv": {"w": jnp.asarray(w["qkv_w"].T),
                       "b": jnp.asarray(w["qkv_b"])},
               "proj": {"w": jnp.asarray(w["proj_w"].T),
                        "b": jnp.asarray(w["proj_b"])}}
    want = jnoess_cross_attention(jparams, jnp.asarray(x1), jnp.asarray(x2),
                                  heads)
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    got = noess_cross_attention(torch.from_numpy(x1), torch.from_numpy(x2),
                                (t["qkv_w"], t["qkv_b"]),
                                (t["proj_w"], t["proj_b"]), heads)
    plain = noess_cross_attention(torch.from_numpy(x1), torch.from_numpy(x2),
                                  (t["qkv_w"], t["qkv_b"]),
                                  (t["proj_w"], t["proj_b"]), heads,
                                  attention=mhsa_reference)
    for g, p, w_ in zip(got, plain, want):
        assert g.shape == (B, N, C)
        torch.testing.assert_close(g, p, rtol=0, atol=0)
        w_ = np.asarray(w_)
        assert np.linalg.norm(g.numpy() - w_) <= 1e-5 * np.linalg.norm(w_)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_eval_forward_matches_jax(setup, monkeypatch, dtype, atol):
    params, state, sd, _ = setup
    monkeypatch.setenv("RELPOSE_NO_S2D_STEM", "1")
    images = RNG.integers(0, 256, (2, 2, 3, 256, 256), dtype=np.uint8)
    K = np.tile(INTERIORNET, (2, 2, 1))
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    want, _ = vitess_forward(params, state, _jax_cfg(cfg),
                             jnp.asarray(images), jnp.asarray(K),
                             training=False)
    with torch.no_grad():
        got = _port_model(sd, dtype, kernels=False)(
            torch.from_numpy(images), torch.from_numpy(K))
        routed = _port_model(sd, dtype)(torch.from_numpy(images),
                                        torch.from_numpy(K))
    assert got.dtype == torch.float32 and got.shape == (2, 2, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)
    # on CPU tensors the kernel wrappers take the plain versions
    torch.testing.assert_close(routed, got, rtol=0, atol=0)


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
    assert {k for k, _, _ in pairs} >= {
        "pool_attn.0.weight", "pool_attn.4.bias",
        "fusion_transformer.blocks.1.cross_attn.proj.weight"}
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
    #                             pool_attn


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


def test_train_step_moves_pool_attn_and_resumes(setup, tmp_path):
    """A noess train step moves ``pool_attn``'s BatchNorm state; a
    checkpoint written after step 1 resumes step 2 bit for bit and serves
    through ``PosePredictor.from_checkpoint``."""
    _, _, sd, batches = setup
    model = _port_model(sd)
    opt, sched = make_optimizer(model, LR, STEPS, WARMUP)
    train_step(model, opt, sched, *_t(batches[0]))
    state = model.state_dict()
    for bn in ("pool_attn.1", "pool_attn.4"):
        assert not torch.equal(state[f"{bn}.running_mean"],
                               sd[f"{bn}.running_mean"])
        assert not torch.equal(state[f"{bn}.running_var"],
                               sd[f"{bn}.running_var"])
        assert int(state[f"{bn}.num_batches_tracked"]) == 1
    tckpt.save_checkpoint(tckpt.checkpoint_path("noess", 1, str(tmp_path)),
                          model, opt, sched)
    metrics, _ = train_step(model, opt, sched, *_t(batches[1]))

    fresh = _port_model(sd)
    opt2, sched2 = make_optimizer(fresh, LR, STEPS, WARMUP)
    assert tckpt.resume("noess", fresh, opt2, sched2, str(tmp_path)) == 1
    metrics2, _ = train_step(fresh, opt2, sched2, *_t(batches[1]))
    assert metrics2["loss"].item() == metrics["loss"].item()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)

    path = tckpt.find_resume_checkpoint("noess", str(tmp_path))
    pred = PosePredictor.from_checkpoint(path, CFG, device="cpu",
                                         intrinsics=INTERIORNET)
    images = batches[2][0]
    with torch.no_grad():
        want = _port_model(torch.load(path, weights_only=True)["model"])(
            torch.from_numpy(images), torch.from_numpy(batches[2][2]))
    np.testing.assert_array_equal(pred.predict_batch(images), want.numpy())


def test_reference_checkpoint_keys_load(setup, tmp_path):
    """A reference --noess ``.pth`` (DDP ``module.`` prefix, the trunk's
    unused layer3 / layer4 / fc and the extractor's ``downsample.1``
    alias) loads through ``PosePredictor.from_checkpoint``."""
    _, _, sd, _ = setup
    ref = {f"module.{k}": v for k, v in sd.items()}
    ref["module.resnet.layer3.0.conv1.weight"] = torch.zeros(256, 128, 3, 3)
    ref["module.resnet.fc.weight"] = torch.zeros(1000, 512)
    for s in ("weight", "bias", "running_mean", "running_var"):
        ref[f"module.extractor_final_conv.downsample.1.{s}"] = \
            sd[f"extractor_final_conv.norm3.{s}"]
    path = tmp_path / "noess_reference.pth"
    torch.save({"model": ref}, path)
    pred = PosePredictor.from_checkpoint(path, CFG, device="cpu")
    for k, v in pred.model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_key_map_round_trips_a_noess_state_dict():
    """state dict -> JAX (params, state) by the JAX package's converter ->
    back through ``key_map``: every key and value unchanged, pool_attn and
    ``cross_attn.proj`` included."""
    sd = seeded_state_dict(ViTEss(CFG, device="meta"), seed=5)
    params, state = convert_torch_state_dict(sd, _jax_cfg(CFG))
    back = state_dict_from_jax(jax.tree.map(np.asarray, params),
                               jax.tree.map(np.asarray, state), CFG)
    assert set(back) == set(sd)
    assert {k for k in sd if k.startswith("pool_attn.")} == {
        f"pool_attn.{i}.{s}" for i in (0, 3) for s in ("weight", "bias")} | {
        f"pool_attn.{i}.{s}" for i in (1, 4)
        for s in ("weight", "bias", "running_mean", "running_var",
                  "num_batches_tracked")}
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
