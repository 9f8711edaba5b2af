"""Rematerialized training in the PyTorch port (``train_step(...,
remat=True)``, the training CLI's ``--remat``) on the CPU.

The slice of tests/test_torch_train.py: ``ModelConfig(transformer_depth=2)``
and its --noess and no-fusion variants, B = 2 pairs of 256x256 uint8
images, fp32, numpy-seeded weights.  What must hold, with its tolerance:

  * remat against the port's own plain step, over 3 train steps: the
    losses, every parameter's step-1 gradient, the parameters and the
    BatchNorm buffers after step 3 bit for bit (the recompute runs the
    same ops on the same inputs), ``num_batches_tracked`` == 3 (the
    recompute moves no running statistics);
  * the recompute happens: the backward runs each checkpointed stage once
    more, under ``frozen_running_stats``, and the forward keeps a
    fraction of the plain forward's saved tensors outside the
    checkpoints;
  * one port remat step against the JAX package's ``make_train_step(cfg,
    tx, remat=True)`` (``RELPOSE_NO_PALLAS=1``), with
    tests/test_torch_train.py's bounds and reasons: the loss rtol 1e-5,
    the gradients per leaf within 5e-3 of the leaf's norm plus 1e-6 of the
    largest, the running statistics 1e-5 relative and counts exact.  The
    JAX step's ``tx`` keeps the gradients as its state and changes no
    parameter, so the step hands them out;
  * a 2-rank gloo step (tests/torch_ddp_worker.py ``--remat``) with remat
    against the same step without it, on each rank, and the two ranks
    against each other: bit for bit.
"""

import contextlib
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from rel_pose_tpu.train import TrainState, make_train_step
from rel_pose_tpu.utils.convert import convert_torch_state_dict
from rel_pose_tpu_torch.models import vitess
from rel_pose_tpu_torch.models.vitess import REMAT_STAGES, ViTEss
from rel_pose_tpu_torch.nn.init import seeded_state_dict
from rel_pose_tpu_torch.train.optim import make_optimizer
from rel_pose_tpu_torch.train.step import loss_fn, train_step
from rel_pose_tpu_torch.utils.convert import key_map, state_dict_from_jax
from test_torch_ddp import run_world, wait_all
from test_torch_train import (CFG, LR, STEPS, WARMUP, _jax_cfg, _lookup, _t,
                              random_poses)
from test_torch_train_cli import same_tree

CONFIGS = {"flagship": CFG,
           "noess": dataclasses.replace(CFG, noess=True),
           "nofusion": dataclasses.replace(CFG, fusion_transformer=False)}
B = 2


@pytest.fixture(scope="module")
def ddp_runs(tmp_path_factory):
    """The 2-rank workers, started first so that they run beside the
    module's other tests; -> a function that waits for them and returns
    each rank's results."""
    out = tmp_path_factory.mktemp("ddp_remat")
    procs = run_world(2, out, args=["--remat"])
    done = []

    def results():
        if not done:
            wait_all(procs)
            done.extend(torch.load(out / f"rank{r}_of2.pt",
                                   weights_only=False) for r in range(2))
        return done
    yield results
    for p, _ in procs:
        p.kill()
        p.wait()


@pytest.fixture(scope="module")
def batches(ddp_runs):
    # every test reaches this fixture: asking for ddp_runs here starts the
    # workers with the module's first test
    rng = np.random.default_rng(41)
    return [(rng.integers(0, 256, (B, 2, 3, 256, 256), dtype=np.uint8),
             random_poses(rng, B),
             np.tile(np.float32([128, 128, 128, 128]), (B, 2, 1)))
            for _ in range(3)]


def _steps(cfg, sd, batches, remat):
    """3 ``train_step``s -> (losses, step-1 gradients, state dict)."""
    model = ViTEss(cfg, device="cpu")
    model.load_state_dict(sd)
    opt, sched = make_optimizer(model, LR, STEPS, WARMUP)
    losses, grads = [], None
    for batch in batches:
        metrics, _ = train_step(model, opt, sched, *_t(batch), remat=remat)
        losses.append(metrics["loss"].item())
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return losses, grads, {k: v.clone() for k, v in
                           model.state_dict().items()}


@pytest.fixture(scope="module", params=list(CONFIGS))
def three_steps(request, batches):
    cfg = CONFIGS[request.param]
    sd = seeded_state_dict(ViTEss(cfg, device="meta"), seed=7)
    return _steps(cfg, sd, batches, False), _steps(cfg, sd, batches, True)


def test_remat_losses_match_plain(three_steps):
    (plain, _, _), (remat, _, _) = three_steps
    assert remat == plain and np.isfinite(remat).all()


def test_remat_gradients_match_plain(three_steps):
    (_, plain, _), (_, remat, _) = three_steps
    assert plain.keys() == remat.keys()
    bad = [k for k, g in plain.items() if not torch.equal(remat[k], g)]
    assert not bad, bad


def test_remat_state_matches_plain(three_steps):
    (_, _, plain), (_, _, remat) = three_steps
    bad = [k for k, v in plain.items() if not torch.equal(remat[k], v)]
    assert not bad, bad
    counts = [int(v) for k, v in remat.items()
              if k.endswith("num_batches_tracked")]
    assert counts and set(counts) == {3}


def test_remat_recomputes_each_stage(batches, monkeypatch):
    """One forward and backward of the flagship: with remat the backward
    enters ``frozen_running_stats`` once for each checkpointed stage (none
    without), the forward saves under a tenth of the plain forward's
    activation bytes (tensors other than the parameters) outside the
    checkpoints, and BatchNorm counts the batch once."""
    frozen = vitess.frozen_running_stats
    entered = []

    @contextlib.contextmanager
    def counted():
        entered.append(1)       # when the recompute enters it
        with frozen():
            yield

    monkeypatch.setattr(vitess, "frozen_running_stats", counted)
    sd = seeded_state_dict(ViTEss(CFG, device="meta"), seed=7)
    saved = {}
    for remat in (False, True):
        model = ViTEss(CFG, device="cpu")
        model.load_state_dict(sd)
        model.train()
        sizes = []
        weights = {p.untyped_storage().data_ptr()
                   for p in model.parameters()}

        def pack(t):
            if t.untyped_storage().data_ptr() not in weights:
                sizes.append(t.numel() * t.element_size())
            return t

        entered.clear()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _, _ = loss_fn(model, *_t(batches[0]), remat=remat)
        assert not entered
        loss.backward()
        saved[remat] = sum(sizes)
        stages = [n for n, _ in model.stages((B, 2, 3, 256, 256))
                  if n in REMAT_STAGES]
        assert len(entered) == (len(stages) if remat else 0)
        assert {int(v) for k, v in model.state_dict().items()
                if k.endswith("num_batches_tracked")} == {1}
    assert stages == ["stem", "layer1", "layer2", "extractor", "vit", "cross"]
    assert saved[True] < saved[False] / 10, saved


def _keep_gradients():
    """An optax transformation whose state is the last gradients and whose
    updates are zeros: ``make_train_step`` with it returns the step's
    gradients in ``opt_state``."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


@pytest.fixture(scope="module")
def jax_remat_step(batches):
    mp = pytest.MonkeyPatch()
    mp.setenv("RELPOSE_NO_PALLAS", "1")
    try:
        sd = seeded_state_dict(ViTEss(CFG, device="meta"), seed=7)
        params, state = convert_torch_state_dict(sd, _jax_cfg(CFG))
        to_np = lambda tree: jax.tree.map(np.asarray, tree)
        sd = state_dict_from_jax(to_np(params), to_np(state), CFG)
        tx = _keep_gradients()
        step = make_train_step(_jax_cfg(CFG), tx, remat=True)
        jstate, metrics, _ = step(TrainState.create(params, state, tx),
                                  *map(jnp.asarray, batches[0]))
        return sd, float(metrics["loss"]), jstate
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def port_remat_step(jax_remat_step, batches):
    sd = jax_remat_step[0]
    model = ViTEss(CFG, device="cpu")
    model.load_state_dict(sd)
    model.train()
    loss, _, _ = loss_fn(model, *_t(batches[0]), remat=True)
    loss.backward()
    return model, loss.item()


def test_remat_loss_matches_jax(jax_remat_step, port_remat_step):
    np.testing.assert_allclose(port_remat_step[1], jax_remat_step[1],
                               rtol=1e-5)


def test_remat_gradients_match_jax(jax_remat_step, port_remat_step):
    grads = jax_remat_step[2].opt_state
    named = dict(port_remat_step[0].named_parameters())
    pairs = []
    for path, key, transpose in key_map(CFG):
        if path[0] == "params":
            want = _lookup(grads, path[1:])
            pairs.append((key, named[key].grad.numpy(),
                          want.T if transpose else want))
    assert len(pairs) == len(named)
    scale = max(np.linalg.norm(w) for _, _, w in pairs)
    bad = [f"{k}: {np.linalg.norm(g - w):.3e} vs |g| {np.linalg.norm(w):.3e}"
           for k, g, w in pairs if not np.linalg.norm(g - w)
           <= 5e-3 * np.linalg.norm(w) + 1e-6 * scale]
    assert not bad, bad


def test_remat_bn_state_matches_jax(jax_remat_step, port_remat_step):
    bn_state = jax_remat_step[2].bn_state
    sd = port_remat_step[0].state_dict()
    n = 0
    for path, key, _ in key_map(CFG):
        if path[0] != "state":
            continue
        want, got = _lookup(bn_state, path[1:]), sd[key].numpy()
        if key.endswith("num_batches_tracked"):
            assert got == want == 1, key
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=key)
        n += 1
    assert n == 3 * 13


def test_ddp_remat_step_matches_plain(ddp_runs):
    for rank, res in enumerate(ddp_runs()):
        plain, remat = res["train"], res["train_remat"]
        for key in ("metrics", "state", "grads", "adam"):
            assert same_tree(plain[key], remat[key]), (rank, key)
        assert not remat["warnings"], remat["warnings"]


def test_ddp_remat_ranks_identical(ddp_runs):
    r0, r1 = (res["train_remat"] for res in ddp_runs())
    assert same_tree(r0["state"], r1["state"])
    assert same_tree(r0["adam"], r1["adam"])
    assert r0["metrics"] == r1["metrics"]
    assert {int(v) for k, v in r0["state"].items()
            if k.endswith("num_batches_tracked")} == {1}
