"""PyTorch port vs the JAX package: the whole eval forward.

JAX ``vitess_forward(training=False)`` against the port's ``ViTEss`` with
the same weights.  The weights are drawn from a numpy seed at the reference
state-dict shapes, converted to the JAX pytrees by the JAX package's own
``convert_torch_state_dict``, and carried back into the port by
``state_dict_from_jax``.  On the CPU the JAX forward takes its plain
(non-Pallas) path and the port its plain versions.

Tolerances on the (B, 2, 7) poses: fp32 2e-5 -- a ResNet trunk, two
transformer blocks and a 26,880-wide regressor summed in another order
(measured about 1e-6, also against the JAX eval default, the space-to-depth
rewrite of the port's plain 7x7 stem); well inside the 5e-4 that
tests/test_reference_parity.py holds converted checkpoints to.  bf16 2e-2
(measured 5e-3): the two packages round bf16 at different points inside
the transformer (the port follows the Pallas kernels, the JAX plain path
rounds every Linear before its bias), and flips of one bf16 ulp (2^-8
relative) reach the fp32 regressor.
"""

import argparse
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rel_pose_tpu import config as jconfig
from rel_pose_tpu.models import vitess_forward
from rel_pose_tpu.utils.convert import convert_torch_state_dict
from rel_pose_tpu_torch.config import ModelConfig
from rel_pose_tpu_torch.models.vitess import ViTEss, normalize_preds
from rel_pose_tpu_torch.nn.init import seeded_state_dict
from rel_pose_tpu_torch.utils.convert import state_dict_from_jax

RNG = np.random.default_rng(17)
MATTERPORT = [517.97, 517.97, 320.0, 240.0]
INTERIORNET = [128.0, 128.0, 128.0, 128.0]


@pytest.fixture(scope="module")
def weights():
    cfg = ModelConfig(transformer_depth=2)
    sd = seeded_state_dict(ViTEss(cfg, device="meta"), seed=3)
    params, state = convert_torch_state_dict(sd, _jax_cfg(cfg))
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    return params, state, state_dict_from_jax(to_np(params), to_np(state),
                                              cfg)


def _jax_cfg(cfg):
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


def _port(sd, dtype):
    model = ViTEss(ModelConfig(transformer_depth=2, compute_dtype=dtype),
                   device="cpu")
    model.load_state_dict(sd)
    return model


@pytest.mark.parametrize("hw,intr,dtype,s2d,atol", [
    ((256, 256), INTERIORNET, "float32", False, 2e-5),
    ((480, 640), MATTERPORT, "float32", False, 2e-5),
    ((256, 256), INTERIORNET, "float32", True, 2e-5),
    ((256, 256), INTERIORNET, "bfloat16", False, 2e-2),
])
def test_eval_forward_matches_jax(weights, monkeypatch, hw, intr, dtype,
                                  s2d, atol):
    params, state, sd = weights
    if not s2d:
        monkeypatch.setenv("RELPOSE_NO_S2D_STEM", "1")
    images = RNG.integers(0, 256, (2, 2, 3) + hw, dtype=np.uint8)
    K = np.tile(np.asarray(intr, np.float32), (2, 2, 1))
    cfg = ModelConfig(transformer_depth=2, compute_dtype=dtype)
    want, _ = vitess_forward(params, state, _jax_cfg(cfg),
                             jnp.asarray(images), jnp.asarray(K),
                             training=False)
    with torch.no_grad():
        got = _port(sd, dtype)(torch.from_numpy(images), torch.from_numpy(K))
    assert got.dtype == torch.float32 and got.shape == (2, 2, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_plain_and_kernel_routes_agree_on_cpu(weights):
    """``kernels=False`` selects the plain versions explicitly; on CPU
    tensors the kernel wrappers take them too, so both are bitwise equal."""
    _, _, sd = weights
    images = torch.from_numpy(
        RNG.integers(0, 256, (1, 2, 3, 256, 256), dtype=np.uint8))
    K = torch.tensor(INTERIORNET).repeat(1, 2, 1)
    plain = ViTEss(ModelConfig(transformer_depth=2), device="cpu",
                   kernels=False)
    plain.load_state_dict(sd)
    with torch.no_grad():
        torch.testing.assert_close(_port(sd, "float32")(images, K),
                                   plain(images, K), rtol=0, atol=0)


def test_normalize_preds_matches_jax():
    from rel_pose_tpu.models.vitess import normalize_preds as jnorm
    preds = RNG.standard_normal((4, 2, 7)).astype(np.float32)
    preds[1, 1, 3:] *= 1e-3            # the 0.01 floor case
    Gs = RNG.standard_normal((4, 2, 7)).astype(np.float32)
    want = np.asarray(jnorm(jnp.asarray(Gs), jnp.asarray(preds)))
    got = normalize_preds(torch.from_numpy(Gs), torch.from_numpy(preds))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("overrides", [
    {}, {"transformer_depth": 2, "compute_dtype": "bfloat16"},
    {"noess": True}, {"fusion_transformer": False, "pool_size": 30},
    {"no_pos_encoding": True},
])
def test_model_config_mirrors_jax(overrides):
    """The port's ModelConfig is a copy of the JAX one: the same fields
    with the same defaults, and the same derived sizes; so are its
    TrainConfig and its argparse bridge (``add_model_flags`` with either
    fusion default, ``model_config_from_args``)."""
    from rel_pose_tpu_torch import config as tconfig
    for cls in ("ModelConfig", "TrainConfig"):
        jfields = [(f.name, f.default)
                   for f in dataclasses.fields(getattr(jconfig, cls))]
        assert [(f.name, f.default) for f in dataclasses.fields(
            getattr(tconfig, cls))] == jfields, cls
    got, want = ModelConfig(**overrides), jconfig.ModelConfig(**overrides)
    for prop in ("feature_resolution", "num_patches", "head_dim", "pos_enc",
                 "pool_feat1", "regressor_input_dim"):
        assert getattr(got, prop) == getattr(want, prop), prop
    argv = [f"--{k}" if v is True else f"--{k}={v}"
            for k, v in overrides.items() if v is not False]
    if "fusion_transformer" not in overrides:
        argv.append("--fusion_transformer")
    for fusion_default in (False, True):
        parsers = [mod.add_model_flags(argparse.ArgumentParser(),
                                       fusion_default=fusion_default)
                   for mod in (tconfig, jconfig)]
        assert [[(a.dest, a.default, a.type, a.choices, a.const)
                 for a in p._actions] for p in parsers] == [
            [(a.dest, a.default, a.type, a.choices, a.const)
             for a in parsers[1]._actions]] * 2
        args = parsers[0].parse_args(argv)
        assert dataclasses.asdict(tconfig.model_config_from_args(args)) \
            == dataclasses.asdict(jconfig.model_config_from_args(args))


@pytest.mark.parametrize("flag", ["noess", "no_pos_encoding",
                                  "cross_features", "use_single_softmax",
                                  "l1_pos_encoding"])
def test_ablation_flags_not_implemented(flag):
    """Every ablation flag builds (parity tests: test_torch_noess.py,
    test_torch_ablations*.py): --noess its ``pool_attn`` head and
    ``cross_attn.proj``; the Essential Matrix Module's four flags the
    flagship's keys, with ``proj_fundamental`` h(d + 6) -> C, or h d -> C
    and a 24,576-wide regressor without positions."""
    model = ViTEss(ModelConfig(**{flag: True}), device="meta")
    keys = set(model.state_dict())
    flagship = set(ViTEss(ModelConfig(), device="meta").state_dict())
    cross = "fusion_transformer.blocks.5.cross_attn"
    if flag == "noess":
        assert "pool_attn.4.running_var" in keys
        assert f"{cross}.proj.weight" in keys
        assert f"{cross}.proj_fundamental.weight" not in keys
        assert model.pose_regressor[0].in_features == 43 * 576
        return
    assert keys == flagship
    assert not any(k.startswith("pool_attn.") for k in keys)
    proj = model.fusion_transformer.blocks[-1].cross_attn.proj_fundamental
    no_pos = flag == "no_pos_encoding"
    assert (proj.in_features, proj.out_features) == (192 if no_pos else 210,
                                                     192)
    assert model.pose_regressor[0].in_features == (
        2 * 3 * 64 * 64 if no_pos else 26_880)


def test_no_fusion_builds():
    """The no-fusion baseline builds the reference's
    ``pool_transformer_output`` head (1x1 convs 192 -> 96 -> 60 with their
    BatchNorms at indices 0, 1, 3, 4), no ``fusion_transformer`` and a
    60 x 576 = 34,560-wide regressor (parity: test_torch_nofusion.py)."""
    model = ViTEss(ModelConfig(fusion_transformer=False), device="meta")
    keys = set(model.state_dict())
    assert not any(k.startswith("fusion_transformer.") for k in keys)
    assert {k for k in keys if k.startswith("pool_transformer_output.")} == {
        f"pool_transformer_output.{i}.{s}" for i in (0, 3)
        for s in ("weight", "bias")} | {
        f"pool_transformer_output.{i}.{s}" for i in (1, 4)
        for s in ("weight", "bias", "running_mean", "running_var",
                  "num_batches_tracked")}
    head = model.pool_transformer_output
    assert (head[0].in_channels, head[0].out_channels,
            head[3].out_channels) == (192, 96, 60)
    assert model.pose_regressor[0].in_features == 34_560
