"""PyTorch port: reference training checkpoints and the fp32 precision knob.

  * a ``.pth`` whose ``"scheduler"`` holds OneCycleLR's pickled
    ``anneal_func``, as the reference's PyTorch 1.8 wrote it, loads through
    ``utils.convert.load_pth``, ``PosePredictor.from_checkpoint`` and
    ``train.checkpoint.load_checkpoint``; nothing of it is run;
  * the reference's Adam state, whose single group also lists the frozen
    ``resnet.layer3/4`` and ``fc`` that the port drops, is remapped by
    parameter name: a warm-started step in the port equals the reference
    optimizer's next step from the same state (the JAX package's
    ``TestAdamStateConversion::test_warm_started_step_matches_torch``);
    parameters without state start from zero moments;
  * ``RELPOSE_MATMUL_PRECISION`` sets both TF32 flags, from ``ViTEss``,
    ``PosePredictor`` and ``train_step``, and defaults to full fp32.

Everything runs on the CPU with a depth-2 model and seeded weights.
"""

import collections
import functools
import pickle

import numpy as np
import pytest
import torch

from rel_pose_tpu_torch import infer as tinfer
from rel_pose_tpu_torch.config import ModelConfig
from rel_pose_tpu_torch.models.vitess import ViTEss
from rel_pose_tpu_torch.nn.init import seeded_state_dict
from rel_pose_tpu_torch.train import checkpoint
from rel_pose_tpu_torch.train import step as tstep
from rel_pose_tpu_torch.train.optim import make_optimizer
from rel_pose_tpu_torch.utils import precision
from rel_pose_tpu_torch.utils.convert import (load_pth,
                                              reference_param_names,
                                              remap_reference_adam_state)

CFG = ModelConfig(transformer_depth=2)
LR, STEPS, WARMUP = 2e-5, 100, 10
# what the reference's model holds beyond the port's: the frozen resnet
# tail (a few of its tensors), listed in its Adam group without state
EXTRA_PARAMS = {"resnet.layer3.0.conv1.weight": (8, 4, 3, 3),
                "resnet.layer4.0.bn1.weight": (16,),
                "resnet.layer4.0.bn1.bias": (16,),
                "resnet.fc.weight": (10, 16), "resnet.fc.bias": (10,)}
EXTRA_BUFFERS = {"resnet.layer4.0.bn1.running_mean": (16,),
                 "resnet.layer4.0.bn1.running_var": (16,)}
ANNEAL = {"function": torch.optim.lr_scheduler.OneCycleLR._annealing_cos,
          "partial": functools.partial(
              torch.optim.lr_scheduler.OneCycleLR._annealing_cos)}


@pytest.fixture(scope="module")
def port_sd():
    m = ViTEss(CFG, device="cpu")
    return seeded_state_dict(m, seed=5)


def directions(names, seed):
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for n, s in names.items()}


class Reference:
    """The reference's training state in the port's absence: its parameters
    in ``model.parameters()`` order (the port's, with the frozen resnet
    tail after layer2), its Adam + OneCycleLR over all of them, and its
    ``.pth`` layout (``module.`` keys, the extractor's ``downsample.1``
    alias of ``norm3``)."""

    def __init__(self, port_sd, skip=()):
        rng = np.random.default_rng(11)
        port_params = reference_param_names(port_sd)
        last = max(i for i, n in enumerate(port_params)
                   if n.startswith("resnet.layer2."))
        order = (port_params[:last + 1] + list(EXTRA_PARAMS)
                 + port_params[last + 1:])
        self.params = collections.OrderedDict()
        for n in order:
            v = port_sd[n] if n in port_sd else torch.from_numpy(
                rng.standard_normal(EXTRA_PARAMS[n]).astype(np.float32))
            self.params[n] = torch.nn.Parameter(v.clone())
        self.buffers = {k: v for k, v in port_sd.items()
                        if k not in self.params}
        self.frozen = set(EXTRA_PARAMS) | set(skip)
        self.opt, self.sched = make_optimizer(
            torch.nn.ParameterList(self.params.values()), lr=LR,
            steps=STEPS, warmup=WARMUP)

    def step(self, seed):
        d = directions({n: tuple(p.shape) for n, p in self.params.items()},
                       seed)
        for n, p in self.params.items():
            p.grad = None if n in self.frozen else d[n] + p.detach()
        self.opt.step()
        self.sched.step()

    def model_sd(self):
        """The ``"model"`` entry in the reference's key order."""
        out = collections.OrderedDict()
        for n, p in self.params.items():
            out[f"module.{n}"] = p.detach().clone()
            if n == "resnet.layer4.0.bn1.bias":
                for b, s in EXTRA_BUFFERS.items():
                    out[f"module.{b}"] = torch.zeros(s)
        for k, v in self.buffers.items():
            out[f"module.{k}"] = v
            if k.startswith("extractor_final_conv.norm3."):
                alias = k.replace("norm3.", "downsample.1.")
                out[f"module.{alias}"] = v
        return out

    def save(self, path, anneal="function"):
        sched = self.sched.state_dict()
        sched["anneal_func"] = ANNEAL[anneal]
        torch.save({"model": self.model_sd(),
                    "optimizer": self.opt.state_dict(),
                    "scheduler": sched}, path)


def port_model():
    model = ViTEss(CFG, device="cpu")
    opt, sched = make_optimizer(model, lr=LR, steps=STEPS, warmup=WARMUP)
    return model, opt, sched


@pytest.mark.parametrize("anneal", sorted(ANNEAL))
def test_reference_pth_with_pickled_scheduler_loads(port_sd, tmp_path,
                                                    anneal):
    ref = Reference(port_sd)
    ref.step(0)
    path = tmp_path / "ref.pth"
    ref.save(path, anneal)
    with pytest.raises(pickle.UnpicklingError):
        torch.load(path, map_location="cpu", weights_only=True)
    ckpt = load_pth(path)
    assert "anneal_func" not in ckpt["scheduler"]
    assert ckpt["scheduler"]["last_epoch"] == 1
    for k, v in ref.model_sd().items():
        torch.testing.assert_close(ckpt["model"][k], v, rtol=0, atol=0)

    pred = tinfer.PosePredictor.from_checkpoint(
        path, CFG, device="cpu",
        intrinsics=tinfer.INTERIORNET_STREETLEARN_INTRINSICS)
    for n, p in pred.model.named_parameters():
        torch.testing.assert_close(p, ref.params[n].detach(), rtol=0,
                                   atol=0)

    model, opt, sched = port_model()
    checkpoint.load_checkpoint(path, model, opt, sched)
    assert sched.last_epoch == 1
    assert sched.get_last_lr() == ref.sched.get_last_lr()


def test_warm_started_step_matches_reference(port_sd, tmp_path):
    """Two reference steps, saved; the port loads them and takes a third
    step with the same gradients as the reference's third step: the
    parameters agree bit for bit."""
    ref = Reference(port_sd)
    ref.step(0)
    ref.step(1)
    path = tmp_path / "ref.pth"
    ref.save(path)
    model, opt, sched = port_model()
    checkpoint.load_checkpoint(path, model, opt, sched)
    for n, p in model.named_parameters():
        s = opt.state[p]
        rs = ref.opt.state[ref.params[n]]
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(s[key], rs[key], rtol=0, atol=0)
        assert float(s["step"]) == float(rs["step"]) == 2.0

    shapes = {n: tuple(p.shape) for n, p in ref.params.items()}
    d = directions(shapes, 2)
    ref.step(2)
    for n, p in model.named_parameters():
        p.grad = d[n] + p.detach()
    opt.step()
    sched.step()
    for n, p in model.named_parameters():
        torch.testing.assert_close(p, ref.params[n].detach(), rtol=0,
                                   atol=0, msg=n)
    assert sched.get_last_lr() == ref.sched.get_last_lr()


def test_parameters_without_state_start_from_zero_moments(port_sd,
                                                          tmp_path):
    skip = "pose_regressor.0.weight"
    ref = Reference(port_sd, skip=(skip,))
    ref.step(0)
    ref.step(1)
    path = tmp_path / "ref.pth"
    ref.save(path)
    model, opt, sched = port_model()
    checkpoint.load_checkpoint(path, model, opt, sched)
    s = opt.state[model.get_parameter(skip)]
    assert float(s["step"]) == 2.0
    assert not s["exp_avg"].any() and not s["exp_avg_sq"].any()
    other = opt.state[model.get_parameter("pose_regressor.0.bias")]
    assert other["exp_avg"].any()


def test_remap_rejects_another_models_state(port_sd):
    ref = Reference(port_sd)
    ref.step(0)
    model, opt, _ = port_model()
    sd = ref.model_sd()
    sd.pop("module.resnet.fc.bias")
    with pytest.raises(ValueError, match="not of one checkpoint"):
        remap_reference_adam_state(ref.opt.state_dict(), sd, model, opt)


def test_stub_in_model_entry_raises(tmp_path):
    path = tmp_path / "bad.pth"
    torch.save({"model": {"w": torch.zeros(2), "f": ANNEAL["function"]}},
               path)
    with pytest.raises(ValueError, match="'model' holds"):
        load_pth(path)


# ------------------------------------------------------- precision knob --

@pytest.fixture
def tf32_flags(monkeypatch):
    """Restore both TF32 flags after the test; no precision in the
    environment."""
    monkeypatch.delenv(precision.ENV, raising=False)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def set_flags(value):
    torch.backends.cuda.matmul.allow_tf32 = value
    torch.backends.cudnn.allow_tf32 = value


@pytest.mark.parametrize("env,tf32", [(None, False), ("highest", False),
                                      ("high", True)])
def test_vitess_applies_precision(tf32_flags, monkeypatch, env, tf32):
    """Both flags follow the knob, whatever they were before; unset means
    full fp32."""
    if env is not None:
        monkeypatch.setenv(precision.ENV, env)
    set_flags(not tf32)
    ViTEss(CFG, device="meta")
    assert flags() == (tf32, tf32)


def test_bad_precision_raises(tf32_flags, monkeypatch):
    monkeypatch.setenv(precision.ENV, "medium")
    with pytest.raises(ValueError, match="expected one of"):
        precision.apply_matmul_precision()
    monkeypatch.setenv(precision.ENV, "default")
    with pytest.raises(ValueError, match="RELPOSE_MATMUL_PRECISION"):
        ViTEss(CFG, device="meta")


@pytest.mark.parametrize("env,tf32", [(None, False), ("high", True)])
def test_predictor_and_train_step_apply_precision(tf32_flags, monkeypatch,
                                                  env, tf32):
    model = ViTEss(CFG, device="meta")
    if env is not None:
        monkeypatch.setenv(precision.ENV, env)
    set_flags(not tf32)
    tinfer.PosePredictor(model)
    assert flags() == (tf32, tf32)

    seen = []

    def loss_fn(*args, **kwargs):
        seen.append(flags())
        raise RuntimeError("stop")

    monkeypatch.setattr(tstep, "loss_fn", loss_fn)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.1)
    set_flags(not tf32)
    with pytest.raises(RuntimeError, match="stop"):
        tstep.train_step(model, opt, None, None, None, None)
    assert seen == [(tf32, tf32)]
