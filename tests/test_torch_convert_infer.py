"""PyTorch port: the weight bridge, the serving layer, and the import rule.

  * ``state_dict_from_jax`` equals the JAX package's
    ``export_torch_state_dict`` key for key and value for value, and its
    keys are exactly the port model's;
  * a reference-style ``.pth`` dict (``module.`` prefix, ``resnet.layer3``
    / ``fc`` and the extractor's ``downsample.1`` alias) loads strictly;
  * ``PosePredictor`` chunking and ragged-tail padding, uint8 vs float
    input, intrinsics validation, and the dataset output helpers;
  * no module of ``rel_pose_tpu_torch``, nor ``chip_smoke.py``, imports
    jax or the JAX package.

Everything runs on the CPU with seeded weights; exact comparisons except
where a batch's composition changes a sum's blocking (stated there).
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from rel_pose_tpu import infer as jinfer
from rel_pose_tpu import config as jconfig
from rel_pose_tpu.models import vitess_init
from rel_pose_tpu.utils.convert import export_torch_state_dict
from rel_pose_tpu_torch import infer as tinfer
from rel_pose_tpu_torch.config import ModelConfig
from rel_pose_tpu_torch.models.vitess import ViTEss
from rel_pose_tpu_torch.nn.init import seeded_state_dict
from rel_pose_tpu_torch.ops import _build
from rel_pose_tpu_torch.utils.convert import (load_reference_state_dict,
                                              state_dict_from_jax)

RNG = np.random.default_rng(23)
REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = ModelConfig(transformer_depth=2)


@pytest.mark.parametrize("depth", [2, 6])
def test_state_dict_from_jax_matches_export(depth):
    cfg = ModelConfig(transformer_depth=depth)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    params, state = vitess_init(jax.random.PRNGKey(depth), jcfg)
    want = export_torch_state_dict(params, state, jcfg)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    got = state_dict_from_jax(to_np(params), to_np(state), cfg)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model_keys = ViTEss(cfg, device="meta").state_dict().keys()
    assert set(got) == set(model_keys)


@pytest.fixture(scope="module")
def model():
    m = ViTEss(CFG, device="cpu")
    m.load_state_dict(seeded_state_dict(m, seed=1))
    return m


def _reference_style(sd):
    """What the reference's DDP training saves: ``module.`` keys, the
    frozen resnet tail, and norm3 registered twice in the extractor."""
    out = {f"module.{k}": v for k, v in sd.items()}
    for k in ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked"):
        out[f"module.extractor_final_conv.downsample.1.{k}"] = \
            sd[f"extractor_final_conv.norm3.{k}"]
    out["module.resnet.layer3.0.conv1.weight"] = torch.zeros(256, 128, 3, 3)
    out["module.resnet.layer4.1.bn2.running_var"] = torch.ones(512)
    out["module.resnet.fc.weight"] = torch.zeros(1000, 512)
    return out


def test_reference_state_dict_loads(model):
    sd = model.state_dict()
    fresh = ViTEss(CFG, device="cpu")
    fresh.load_state_dict(load_reference_state_dict(_reference_style(sd)))
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_from_checkpoint_pth(model, tmp_path):
    path = tmp_path / "model.pth"
    torch.save({"model": _reference_style(model.state_dict()),
                "optimizer": {"state": {}, "param_groups": []}}, path)
    pred = tinfer.PosePredictor.from_checkpoint(
        path, CFG, device="cpu",
        intrinsics=tinfer.INTERIORNET_STREETLEARN_INTRINSICS)
    direct = tinfer.PosePredictor(
        model, intrinsics=tinfer.INTERIORNET_STREETLEARN_INTRINSICS)
    images = RNG.integers(0, 256, (2, 2, 3, 256, 256), dtype=np.uint8)
    np.testing.assert_array_equal(pred.predict_batch(images),
                                  direct.predict_batch(images))


def test_from_checkpoint_rejects_native_ckpt(model, tmp_path):
    """A ``.ckpt`` loads (``save_ckpt``'s, serving as the model it was
    written from) unless it is of another architecture, which is refused
    naming the flags."""
    from rel_pose_tpu_torch.train.checkpoint import save_ckpt
    path = tmp_path / "x.ckpt"
    save_ckpt(str(path), model)
    pred = tinfer.PosePredictor.from_checkpoint(
        path, CFG, device="cpu",
        intrinsics=tinfer.INTERIORNET_STREETLEARN_INTRINSICS)
    direct = tinfer.PosePredictor(
        model, intrinsics=tinfer.INTERIORNET_STREETLEARN_INTRINSICS)
    images = RNG.integers(0, 256, (2, 2, 3, 64, 64), dtype=np.uint8)
    np.testing.assert_array_equal(pred.predict_batch(images),
                                  direct.predict_batch(images))
    with pytest.raises(ValueError, match="--transformer_depth"):
        tinfer.PosePredictor.from_checkpoint(
            path, ModelConfig(transformer_depth=3), device="cpu")


class _Spy:
    """Stands in for ``PosePredictor._run``: records what it was sent."""

    def __init__(self):
        self.calls = []

    def __call__(self, images, intr):
        self.calls.append((images.shape, images.dtype, intr))
        return np.zeros((images.shape[0], 2, 7), np.float32)


@pytest.mark.parametrize("kwargs,call,want_shape,want_dtype", [
    ({"image_size": (384, 512), "batch_size": 4}, {}, (4, 2, 3, 384, 512),
     np.uint8),
    ({"image_size": (384, 512)}, {"height": 480, "width": 640},
     (1, 2, 3, 480, 640), np.uint8),
    ({"batch_size": 8}, {"height": 256, "width": 256,
                         "dtype": np.float32}, (8, 2, 3, 256, 256),
     np.float32),
])
def test_warmup_runs_one_dummy_batch(model, monkeypatch, kwargs, call,
                                     want_shape, want_dtype):
    """``warmup`` sends one zero batch of ``batch_size`` (1 without one)
    at ``image_size`` or the given size and dtype through ``_run``, with
    the stored intrinsics tiled to it, and returns the predictor."""
    pred = tinfer.PosePredictor(
        model, intrinsics=tinfer.MATTERPORT_INTRINSICS, **kwargs)
    spy = _Spy()
    monkeypatch.setattr(pred, "_run", spy)
    assert pred.warmup(**call) is pred
    assert len(spy.calls) == 1
    shape, dtype, intr = spy.calls[0]
    assert shape == want_shape and dtype == want_dtype
    np.testing.assert_array_equal(
        intr, np.tile(tinfer.MATTERPORT_INTRINSICS, (want_shape[0], 2, 1)))


def test_warmup_without_image_size_needs_the_resolution(model):
    pred = tinfer.PosePredictor(model, intrinsics=tinfer.MATTERPORT_INTRINSICS)
    with pytest.raises(ValueError, match="image_size is not set"):
        pred.warmup()
    with pytest.raises(ValueError, match="image_size is not set"):
        pred.warmup(height=256)


@pytest.mark.parametrize("intrinsics", [None, "per-pair"])
def test_warmup_takes_a_dummy_for_intrinsics_that_do_not_tile(
        model, monkeypatch, intrinsics):
    """No stored intrinsics, or per-pair ones of another batch: a dummy
    of ones, as ``rel_pose_tpu/infer.py:253-259``."""
    if intrinsics == "per-pair":
        intrinsics = np.ones((3, 2, 4), np.float32) * 100
    pred = tinfer.PosePredictor(model, intrinsics=intrinsics, batch_size=2,
                                image_size=(64, 64))
    spy = _Spy()
    monkeypatch.setattr(pred, "_run", spy)
    pred.warmup()
    np.testing.assert_array_equal(spy.calls[0][2], np.ones((2, 2, 4)))


def test_warmup_runs_the_model_on_the_cpu(model):
    """Unpatched, on the CPU: the dummy goes through the model."""
    pred = tinfer.PosePredictor(model, intrinsics=tinfer.MATTERPORT_INTRINSICS,
                                batch_size=2, image_size=(64, 64))
    assert pred.warmup() is pred


def test_chunking_and_padding(model):
    """batch_size=4 over 6 requests (one full chunk, one padded tail)
    equals one unchunked call.  Convolutions and products may block their
    sums by batch size, so the two agree to 1e-5, not bitwise."""
    images = RNG.integers(0, 256, (6, 2, 3, 256, 256), dtype=np.uint8)
    intr = RNG.uniform(100, 150, (6, 2, 4)).astype(np.float32)
    chunked = tinfer.PosePredictor(model, batch_size=4)
    whole = tinfer.PosePredictor(model)
    got = chunked.predict_batch(images, intr)
    assert got.shape == (6, 2, 7)
    np.testing.assert_allclose(got, whole.predict_batch(images, intr),
                               rtol=0, atol=1e-5)


def test_image_size_resize_and_single_pair(model):
    pair = RNG.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    pred = tinfer.PosePredictor(model,
                                intrinsics=tinfer.MATTERPORT_INTRINSICS,
                                image_size=(384, 512))
    one = pred.predict(pair[0], pair[1])
    assert one.shape == (2, 7)
    batch = np.transpose(pair, (0, 3, 1, 2))[None]
    np.testing.assert_array_equal(one, pred.predict_batch(batch)[0])
    np.testing.assert_array_equal(one[0], [0, 0, 0, 0, 0, 0, 1])


def test_uint8_equals_float(model):
    images = RNG.integers(0, 256, (2, 2, 3, 256, 256), dtype=np.uint8)
    pred = tinfer.PosePredictor(
        model, intrinsics=tinfer.INTERIORNET_STREETLEARN_INTRINSICS)
    np.testing.assert_array_equal(pred.predict_batch(images),
                                  pred.predict_batch(images.astype(np.float32)))


@pytest.mark.parametrize("intr", [None, np.ones((3, 4), np.float32),
                                  np.ones((5, 2, 4), np.float32)])
def test_bad_intrinsics_raise(model, intr):
    pred = tinfer.PosePredictor(model)
    images = np.zeros((2, 2, 3, 64, 64), np.uint8)
    with pytest.raises(ValueError):
        pred.predict_batch(images, intr)


def test_bad_image_shape_raises(model):
    with pytest.raises(ValueError):
        tinfer.PosePredictor(model).predict_batch(
            np.zeros((2, 3, 3, 64, 64), np.uint8), np.ones(4, np.float32))


def test_empty_request(model):
    out = tinfer.PosePredictor(model, intrinsics=np.ones(4)).predict_batch(
        np.zeros((0, 2, 3, 64, 64), np.uint8))
    assert out.shape == (0, 2, 7)


def test_output_conventions_match_jax():
    pose = RNG.standard_normal((3, 2, 7)).astype(np.float32)
    np.testing.assert_array_equal(tinfer.matterport_eval_pose(pose),
                                  jinfer.matterport_eval_pose(pose))
    np.testing.assert_array_equal(tinfer.matterport_demo_pose(pose),
                                  jinfer.matterport_demo_pose(pose))
    np.testing.assert_array_equal(tinfer.MATTERPORT_INTRINSICS,
                                  jinfer.MATTERPORT_INTRINSICS)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises before touching the build directory
    (and the wrappers never reach it for CPU tensors)."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "_build").exists()
    assert _build.library_path().name.startswith("librelpose_kernels-")


def _forbidden(name):
    """jax, jaxlib, or the JAX package (``rel_pose_tpu``, not the port)."""
    return name.split(".")[0] in ("jax", "jaxlib", "rel_pose_tpu")


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter: neither jax
    nor the JAX package may be loaded, since the port has to run where jax
    is not installed."""
    mods = []
    for path in sorted((REPO / "rel_pose_tpu_torch").rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                             else parts))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('\\n'.join(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    loaded = res.stdout.split()
    assert "rel_pose_tpu_torch.infer" in loaded
    assert [m for m in loaded if _forbidden(m)] == []
    assert len(mods) >= 15


def test_chip_smoke_imports_no_jax():
    """``chip_smoke.py`` runs on a host without jax: every import in it,
    at any depth, names neither jax nor the JAX package."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert "rel_pose_tpu_torch.models.vitess" in names
    assert [n for n in names if _forbidden(n)] == []
