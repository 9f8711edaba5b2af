"""PyTorch port vs the JAX package: the ViTEss ablations of the Essential
Matrix Module, softmax and features (``use_single_softmax``,
``cross_features``); tests/test_torch_ablations_pos.py holds the positional
ones (``no_pos_encoding``, ``l1_pos_encoding``).

Per flag, ``ModelConfig(<flag>=True, transformer_depth=2)`` with the same
numpy-seeded weights in both packages (drawn at the reference state-dict
shapes, converted by the JAX package's ``convert_torch_state_dict`` and
carried back by ``state_dict_from_jax``), B = 2 pairs of 256x256 uint8
images:

  * the eval forward: ``ViTEss(kernels=False, device="cpu")`` against
    ``vitess_forward``; the kernel route on CPU tensors (the wrappers'
    plain versions) gives the same bits;
  * one training step: the loss and every parameter's gradient against
    ``jax.value_and_grad`` of the JAX loss under ``RELPOSE_NO_PALLAS=1``
    (its plain path, autodiff where the TPU runs the Pallas backward), as
    tests/test_torch_noess.py;
  * a ``key_map`` round trip of the flag's state dict.

Tolerances, with their reasons (measured values over the four flags in
brackets):

  * eval poses: fp32 atol 2e-5, as tests/test_torch_model.py (a ResNet
    trunk, two blocks and the regressor summed in another order);
  * loss: rtol 5e-5 [2e-7 - 1e-6; 1.5e-5 with the single softmax, whose
    moments F = va^T R vb, R's rows summing to 1, are ~N times the dual
    softmax's and carry larger fp32 sums: in float64 the two losses agree to
    5e-14, and JAX's fp32 loss is the one further from it, by 1.7e-5];
  * per-leaf gradients: ||g_port - g_jax|| <= rtol ||g_jax|| plus 1e-6 of
    the largest leaf norm; rtol 1e-2 on the ResNet trunk and the extractor
    [3.3e-3 - 5.6e-3, above the flagship's 5e-3 of tests/test_torch_train.py
    on one leaf or two for the single softmax and the L1 table] and 2e-4
    from the ViT on [6e-6 - 9e-6; 7.2e-5 with the single softmax] -- fp32
    rounding of training BatchNorm amplified through the trunk, not another
    computation: in float64 every leaf agrees to 1e-9
    (tests/test_torch_ablations_f64.py, for the single softmax, the flag
    with the largest gaps).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rel_pose_tpu import config as jconfig
from rel_pose_tpu.models import vitess_forward
from rel_pose_tpu.train.step import make_loss_fn
from rel_pose_tpu.utils.convert import convert_torch_state_dict
from rel_pose_tpu_torch.config import ModelConfig
from rel_pose_tpu_torch.models.vitess import ViTEss
from rel_pose_tpu_torch.nn.init import seeded_state_dict
from rel_pose_tpu_torch.train.step import loss_fn
from rel_pose_tpu_torch.utils.convert import key_map, state_dict_from_jax
from test_torch_train import random_poses

INTERIORNET = np.float32([128, 128, 128, 128])
FLAGS = ["use_single_softmax", "cross_features"]
# the leaves below the ViT, whose fp32 gradients carry BatchNorm rounding
_TRUNK = ("resnet.", "extractor_final_conv.")


def config(flag, **kwargs):
    return ModelConfig(transformer_depth=2, **({flag: True} if flag else {}),
                       **kwargs)


def _jax_cfg(cfg):
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


def setup_for(cfg, seed):
    """(JAX params, JAX state, port state dict, a batch of 2 pairs)."""
    rng = np.random.default_rng(seed)
    sd = seeded_state_dict(ViTEss(cfg, device="meta"), seed=seed)
    params, state = convert_torch_state_dict(sd, _jax_cfg(cfg))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    sd = state_dict_from_jax(to_np(params), to_np(state), cfg)
    batch = (rng.integers(0, 256, (2, 2, 3, 256, 256), dtype=np.uint8),
             random_poses(rng, 2), np.tile(INTERIORNET, (2, 2, 1)))
    return params, state, sd, batch


def port_model(cfg, sd, **kwargs):
    model = ViTEss(cfg, device="cpu", **kwargs)
    model.load_state_dict(sd)
    return model


def check_eval_forward(cfg, setup, intrinsics=True):
    """``vitess_forward`` against the port's plain path (fp32), and the
    kernel route on CPU tensors against the plain path, bit for bit."""
    params, state, sd, (images, _, K) = setup
    K = K if intrinsics else None
    want, _ = vitess_forward(params, state, _jax_cfg(cfg),
                             jnp.asarray(images),
                             None if K is None else jnp.asarray(K),
                             training=False)
    args = (torch.from_numpy(images),
            None if K is None else torch.from_numpy(K))
    with torch.no_grad():
        got = port_model(cfg, sd, kernels=False)(*args)
        routed = port_model(cfg, sd)(*args)
    assert got.dtype == torch.float32 and got.shape == (2, 2, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    torch.testing.assert_close(routed, got, rtol=0, atol=0)


def check_one_step(cfg, setup):
    """The loss and per-leaf gradients of one training step against the
    JAX loss's ``value_and_grad`` (plain path)."""
    params, state, sd, batch = setup
    mp = pytest.MonkeyPatch()
    mp.setenv("RELPOSE_NO_PALLAS", "1")
    try:
        fn = make_loss_fn(_jax_cfg(cfg), 10.0, 10.0, "train")
        (jloss, _), grads = jax.value_and_grad(fn, has_aux=True)(
            params, state, *map(jnp.asarray, batch), True)
    finally:
        mp.undo()
    model = port_model(cfg, sd)
    model.train()
    loss, _, _ = loss_fn(model, *(torch.from_numpy(a) for a in batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=5e-5)
    named = dict(model.named_parameters())
    pairs = []
    for path, key, transpose in key_map(cfg):
        if path[0] == "params":
            want = grads
            for p in path[1:]:
                want = want[p]
            want = np.asarray(want)
            pairs.append((key, named[key].grad.numpy(),
                          want.T if transpose else want))
    assert len(pairs) == len(named)
    scale = max(np.linalg.norm(w) for _, _, w in pairs)
    bad = []
    for key, got, want in pairs:
        rtol = 1e-2 if key.startswith(_TRUNK) else 2e-4
        err = np.linalg.norm(got - want)
        if not err <= rtol * np.linalg.norm(want) + 1e-6 * scale:
            bad.append(f"{key}: {err:.3e} vs |g| {np.linalg.norm(want):.3e}")
    assert not bad, bad


def check_key_map_round_trip(cfg):
    """state dict -> JAX (params, state) by the JAX package's converter ->
    back through ``key_map``: every key and value unchanged."""
    sd = seeded_state_dict(ViTEss(cfg, device="meta"), seed=5)
    params, state = convert_torch_state_dict(sd, _jax_cfg(cfg))
    back = state_dict_from_jax(jax.tree.map(np.asarray, params),
                               jax.tree.map(np.asarray, state), cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    proj = sd["fusion_transformer.blocks.1.cross_attn.proj_fundamental."
              "weight"]
    assert proj.shape == (192, 192 if cfg.no_pos_encoding else 210)


def seed_of(flag):
    """The setup seed of each flag's module fixture."""
    return {"use_single_softmax": 31, "cross_features": 32,
            "no_pos_encoding": 37, "l1_pos_encoding": 38}[flag]


def float64_case(flag):
    """(cfg, setup) for the float64 child of tests/test_torch_train.py:
    the flag's module setup, its batch as a list of one."""
    cfg = config(flag)
    params, state, sd, batch = setup_for(cfg, seed_of(flag))
    return cfg, (params, state, sd, [batch])


@pytest.fixture(scope="module", params=FLAGS)
def flag_setup(request):
    cfg = config(request.param)
    return cfg, setup_for(cfg, seed=seed_of(request.param))


def test_eval_forward_matches_jax(flag_setup):
    check_eval_forward(*flag_setup)


def test_one_step_matches_jax(flag_setup):
    check_one_step(*flag_setup)


@pytest.mark.parametrize("flag", FLAGS)
def test_key_map_round_trips(flag):
    check_key_map_round_trip(config(flag))


def test_eval_forward_without_intrinsics_matches_jax():
    """The flagship with ``intrinsics=None``: the reference's initial
    quadratic table on both sides."""
    cfg = config(None)
    check_eval_forward(cfg, setup_for(cfg, seed=41), intrinsics=False)
