"""The JAX package's msgpack ``.ckpt`` files in the port
(``utils.msgpack``, ``train.checkpoint``), on the CPU.

The flagship at depth 2 with numpy-seeded weights (carried into the JAX
package by its ``convert_torch_state_dict``), fp32:

  * files written by the JAX package's ``save_checkpoint`` -- a params-only
    state ``{params, bn_state, opt_state: {}, step: 0}`` (what
    ``convert_checkpoint.py`` writes), a full ``TrainState`` with seeded
    Adam moments, a tree with a bfloat16 leaf, a tree whose leaves flax
    splits into chunks (``serialization.MAX_CHUNK_SIZE`` patched down) --
    are read bit for bit; the port's ``packb`` writes flax's bytes; an
    unknown ext code, truncated data and a file of another architecture
    raise;
  * ``save_ckpt``'s file loads in the JAX package's ``load_params_only``
    with equal arrays, dtypes and shapes;
  * the port's model built from a JAX ``.ckpt`` gives the JAX forward's
    poses: fp32 atol 2e-5, as tests/test_torch_model.py [1.0e-6];
  * ``load_ckpt_train_state`` after one JAX ``make_train_step``, then one
    port ``train_step`` against the JAX step from the same state on the
    same batch (JAX's unfused path, ``RELPOSE_NO_PALLAS=1``): the loss
    rtol 1e-5 [3.5e-7] and each Adam moment per leaf ||m_port - m_jax||
    <= 5e-3 ||m_jax|| (plus 1e-6 of the largest leaf norm), the gradient
    bound of tests/test_torch_train.py, which the moments inherit from the
    step's gradient (the trunk's training-BatchNorm rounding) [2.9e-3 on
    exp_avg and on exp_avg_sq, over the leaves above 1e-3 of the largest];
    the moments it loads are the file's bit for bit, the step counts and
    the schedule are carried.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from rel_pose_tpu import config as jconfig
from rel_pose_tpu.models import vitess_forward, vitess_init
from rel_pose_tpu.train import TrainState
from rel_pose_tpu.train import make_optimizer as jmake_optimizer
from rel_pose_tpu.train import make_train_step
from rel_pose_tpu.train.checkpoint import load_params_only, save_checkpoint
from rel_pose_tpu.utils.convert import convert_torch_state_dict
from rel_pose_tpu_torch.config import ModelConfig
from rel_pose_tpu_torch.infer import PosePredictor
from rel_pose_tpu_torch.models.vitess import ViTEss
from rel_pose_tpu_torch.nn.init import seeded_state_dict
from rel_pose_tpu_torch.train import checkpoint as tckpt
from rel_pose_tpu_torch.train.optim import make_optimizer, make_scheduler
from rel_pose_tpu_torch.train.step import train_step
from rel_pose_tpu_torch.utils import msgpack
from rel_pose_tpu_torch.utils.convert import key_map, state_dict_from_jax
from test_torch_train import random_poses

CFG = ModelConfig(transformer_depth=2)
LR, STEPS, WARMUP = 5e-4, 20, 5
INTERIORNET = np.float32([128, 128, 128, 128])


def _jax_cfg(cfg):
    return jconfig.ModelConfig(**dataclasses.asdict(cfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lookup(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.fixture(scope="module")
def weights():
    """(JAX params, JAX bn_state, port state dict, 3 batches of 2 pairs)."""
    sd = seeded_state_dict(ViTEss(CFG, device="meta"), seed=31)
    params, state = convert_torch_state_dict(sd, _jax_cfg(CFG))
    sd = state_dict_from_jax(_np(params), _np(state), CFG)
    rng = np.random.default_rng(37)
    batches = [(rng.integers(0, 256, (2, 2, 3, 256, 256), dtype=np.uint8),
                random_poses(rng, 2), np.tile(INTERIORNET, (2, 2, 1)))
               for _ in range(2)]
    return params, state, sd, batches


def _assert_tree_equal(got, want, path=()):
    """``got`` (the port's read, lists for flax's digit maps) equals the
    JAX tree bit for bit, dtypes included."""
    if isinstance(want, dict) and isinstance(got, list):   # flax's list
        want = [want[str(i)] for i in range(len(want))]
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(map(str, want)), \
            path
        for k, v in want.items():
            _assert_tree_equal(got[str(k)], v, path + (k,))
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, v in enumerate(want):
            _assert_tree_equal(got[i], v, path + (i,))
    else:
        want = np.asarray(want)
        if want.dtype == jnp.bfloat16:
            assert torch.is_tensor(got) and got.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16), str(path))
        else:
            got = np.asarray(got)
            assert got.dtype == want.dtype and got.shape == want.shape, path
            np.testing.assert_array_equal(got, want, str(path))


def test_params_only_ckpt_reads_bit_for_bit(weights, tmp_path):
    params, state, sd, _ = weights
    path = str(tmp_path / "p.ckpt")
    save_checkpoint(path, {"params": params, "bn_state": state,
                           "opt_state": {}, "step": 0})
    raw = tckpt.read_ckpt(path)
    _assert_tree_equal(raw["params"], _np(params))
    _assert_tree_equal(raw["bn_state"], _np(state))
    assert raw["step"] == 0 and raw["opt_state"] == {}
    assert isinstance(raw["params"]["blocks"], list)
    got = tckpt.load_ckpt_state_dict(path, CFG)
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


@pytest.fixture(scope="module")
def jax_state(weights):
    """A JAX TrainState with seeded Adam moments and counts, and the
    optimizer that made it."""
    params, state, _, _ = weights
    tx, _ = jmake_optimizer(LR, STEPS, WARMUP)
    st = TrainState.create(params, state, tx)
    rng = np.random.default_rng(41)
    adam = st.opt_state[2]
    adam = adam._replace(
        count=jnp.asarray(3, jnp.int32),
        mu=jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), adam.mu),
        nu=jax.tree.map(lambda a: jnp.asarray(
            rng.uniform(0, 1, a.shape).astype(np.float32)), adam.nu))
    opt_state = (st.opt_state[0], st.opt_state[1], adam,
                 st.opt_state[3]._replace(count=jnp.asarray(3, jnp.int32)))
    return st.replace(opt_state=opt_state, step=jnp.asarray(3, jnp.int32))


def test_full_train_state_reads_bit_for_bit(jax_state, tmp_path):
    path = str(tmp_path / "full.ckpt")
    save_checkpoint(path, jax.device_get(jax_state))
    raw = tckpt.read_ckpt(path)
    want = serialization.to_state_dict(_np(jax_state))
    _assert_tree_equal(raw["params"], want["params"])
    _assert_tree_equal(raw["bn_state"], want["bn_state"])
    assert len(raw["opt_state"]) == 4
    adam = raw["opt_state"][2]
    _assert_tree_equal(adam["mu"], want["opt_state"]["2"]["mu"])
    _assert_tree_equal(adam["nu"], want["opt_state"]["2"]["nu"])
    _assert_tree_equal(adam["count"], want["opt_state"]["2"]["count"])
    _assert_tree_equal(raw["step"], want["step"])


def test_bfloat16_and_scalar_leaves_read_bit_for_bit(tmp_path):
    """A bfloat16 leaf through ``save_checkpoint``; numpy scalars (ext 3),
    Python ints and str through flax's ``msgpack_serialize``, which
    ``save_checkpoint`` calls after turning leaves into arrays."""
    rng = np.random.default_rng(43)
    tree = {"w": jnp.asarray(rng.standard_normal((5, 3)), jnp.bfloat16),
            "x": [np.arange(4, dtype=np.int16), np.zeros((0, 3))]}
    path = str(tmp_path / "bf16.ckpt")
    save_checkpoint(path, tree)
    raw = tckpt.read_ckpt(path)
    _assert_tree_equal(raw["w"], np.asarray(tree["w"]))
    _assert_tree_equal(raw["x"], tree["x"])
    raw = msgpack.unpackb(serialization.msgpack_serialize(
        {"s": np.float32(2.5), "i": np.int64(-7), "n": 1234567,
         "t": "text"}))
    assert raw["s"] == np.float32(2.5) and raw["s"].dtype == np.float32
    assert raw["i"] == -7 and raw["i"].dtype == np.int64
    assert raw["n"] == 1234567 and raw["t"] == "text"


def test_chunked_arrays_are_reassembled(monkeypatch, tmp_path):
    """flax splits leaves over ``MAX_CHUNK_SIZE`` bytes into a chunked
    map; patched down to 64 bytes, a (10, 7) float32 leaf, an int8 leaf
    and a bfloat16 leaf come back whole."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(47)
    tree = {"a": {"w": rng.standard_normal((10, 7)).astype(np.float32)},
            "b": rng.integers(-100, 100, (3, 50), dtype=np.int8),
            "c": np.asarray(jnp.asarray(rng.standard_normal(40),
                                        jnp.bfloat16)),
            "small": np.ones(3, np.float32)}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = msgpack.unpackb(data)
    for k in ("b", "c", "small"):
        _assert_tree_equal(got[k], tree[k])
    _assert_tree_equal(got["a"], tree["a"])


@pytest.mark.parametrize("blob,code", [
    (b"\xd4\x07\x00", 7),                           # fixext 1
    (b"\xd6\x2a\x00\x00\x00\x00", 42),              # fixext 4
    (b"\xc7\x03\xff\x01\x02\x03", -1),              # ext 8 (timestamp)
    (b"\x81\xa1k\xc8\x00\x02\x05\x00\x00", 5),      # ext 16 inside a map
])
def test_unknown_ext_code_raises(blob, code):
    with pytest.raises(ValueError, match=f"unknown msgpack ext type {code}"):
        msgpack.unpackb(blob)


@pytest.mark.parametrize("blob,message", [
    (b"\x92\x01", "truncated"), (b"\x01\x02", "bytes after"),
    (b"\xc1", "invalid msgpack tag"),
])
def test_malformed_data_raises(blob, message):
    with pytest.raises(ValueError, match=message):
        msgpack.unpackb(blob)


def test_packb_writes_save_checkpoint_bytes(weights, tmp_path):
    """The port's writer gives the bytes of the JAX package's
    ``save_checkpoint`` for the same checkpoint tree (which ``jax.tree.map``
    leaves with sorted keys)."""
    params, state, _, _ = weights
    tree = {"params": params, "bn_state": state, "opt_state": {},
            "step": np.int32(0)}
    path = tmp_path / "jax.ckpt"
    save_checkpoint(str(path), tree)
    assert msgpack.packb(jax.tree.map(np.asarray, tree)) == \
        path.read_bytes()


def test_packb_writes_flax_scalars():
    """Every int width msgpack has, a float, bool, nil, str and bin, a
    numpy scalar (ext 3) and a list (a digit-keyed map) as flax's
    ``to_bytes`` writes them (keys given in sorted order, as the port
    writes them)."""
    ints = [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128,
            -129, -32768, -32769, -2**31 - 1]
    tree = {"bin": b"\x00" * 300, "f": 0.1,
            "ints": {k: ints[int(k)] for k in sorted(map(str,
                                                         range(len(ints))))},
            "list": [np.float32(1.5), np.ones((2, 3), np.float16)],
            "none": None, "s": "x" * 40, "scalar": np.int32(4), "t": True}
    assert msgpack.packb(tree) == serialization.to_bytes(tree)
    back = msgpack.unpackb(msgpack.packb(tree))
    assert [back["ints"][str(i)] for i in range(len(ints))] == ints
    assert back["list"]["1"].dtype == np.float16


def test_save_ckpt_loads_in_jax_load_params_only(weights, tmp_path):
    params, state, sd, _ = weights
    model = ViTEss(CFG, device="cpu")
    model.load_state_dict(sd)
    path = str(tmp_path / "port.ckpt")
    tckpt.save_ckpt(path, model)
    template = vitess_init(jax.random.PRNGKey(0), _jax_cfg(CFG))
    got_p, got_s = load_params_only(path, *template)
    _assert_tree_equal(serialization.to_state_dict(_np(got_p)),
                       serialization.to_state_dict(_np(params)))
    _assert_tree_equal(serialization.to_state_dict(_np(got_s)),
                       serialization.to_state_dict(_np(state)))
    raw = tckpt.read_ckpt(path)
    assert raw["step"] == 0 and raw["opt_state"] == {}


@pytest.mark.parametrize("cfg", [
    ModelConfig(transformer_depth=3), ModelConfig(transformer_depth=1),
    ModelConfig(transformer_depth=2, noess=True),
    ModelConfig(fusion_transformer=False)])
def test_other_architecture_raises(weights, tmp_path, cfg):
    """A file of the depth-2 flagship read for another configuration names
    the architecture flags, as ``load_params_only`` does."""
    params, state, _, _ = weights
    path = str(tmp_path / "p.ckpt")
    save_checkpoint(path, {"params": params, "bn_state": state})
    with pytest.raises(ValueError, match="--transformer_depth"):
        tckpt.load_ckpt_state_dict(path, cfg)


def test_model_from_jax_ckpt_gives_jax_poses(weights, tmp_path):
    params, state, _, _ = weights
    path = str(tmp_path / "p.ckpt")
    save_checkpoint(path, {"params": params, "bn_state": state,
                           "opt_state": {}, "step": 0})
    rng = np.random.default_rng(53)
    images = rng.integers(0, 256, (3, 2, 3, 256, 256), dtype=np.uint8)
    want, _ = vitess_forward(params, state, _jax_cfg(CFG),
                             jnp.asarray(images),
                             jnp.asarray(np.tile(INTERIORNET, (3, 2, 1))),
                             training=False)
    pred = PosePredictor.from_checkpoint(path, CFG, device="cpu",
                                         intrinsics=INTERIORNET)
    np.testing.assert_allclose(pred.predict_batch(images), np.asarray(want),
                               rtol=0, atol=2e-5)


@pytest.fixture(scope="module")
def jax_steps(weights, tmp_path_factory):
    """One JAX step from the seeded weights, saved; then a second from
    that state on batch 1: (path, state after step 1, after step 2,
    step 2's loss)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("RELPOSE_NO_PALLAS", "1")
    try:
        params, state, _, batches = weights
        tx, _ = jmake_optimizer(LR, STEPS, WARMUP)
        step_fn = make_train_step(_jax_cfg(CFG), tx)
        st = TrainState.create(jax.tree.map(jnp.array, params),
                               jax.tree.map(jnp.array, state), tx)
        st1, _, _ = step_fn(st, *map(jnp.asarray, batches[0]))
        path = str(tmp_path_factory.mktemp("steps") / "step1.ckpt")
        st1 = jax.device_get(st1)
        save_checkpoint(path, st1)
        st2, metrics, _ = step_fn(jax.tree.map(jnp.array, st1),
                                  *map(jnp.asarray, batches[1]))
        return path, st1, _np(st2), float(metrics["loss"])
    finally:
        mp.undo()


def _port_from(path):
    model = ViTEss(CFG, device="cpu")
    opt, sched = make_optimizer(model, LR, STEPS, WARMUP)
    return model, opt, sched, tckpt.load_ckpt_train_state(path, model, opt,
                                                          sched)


def _moments(model, opt):
    named = dict(model.named_parameters())
    return {k: opt.state[named[k]] for k in named}


def test_train_state_loads_moments_and_schedule(jax_steps):
    """The file's Adam moments become exp_avg / exp_avg_sq bit for bit
    (Linear weights transposed), its count Adam's step, and the schedule
    stands at the file's step, as ``make_scheduler(step=1)`` builds it."""
    path, st1, _, _ = jax_steps
    model, opt, sched, step = _port_from(path)
    assert step == 1
    adam = st1.opt_state[2]
    moments = _moments(model, opt)
    for jpath, key, transpose in key_map(CFG):
        if jpath[0] != "params":
            continue
        for name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            want = np.asarray(_lookup(tree, jpath[1:]))
            got = moments[key][name].numpy()
            np.testing.assert_array_equal(got, want.T if transpose else want,
                                          err_msg=f"{key} {name}")
        assert float(moments[key]["step"]) == 1.0
    ref = make_scheduler(make_optimizer(ViTEss(CFG, device="meta"), LR,
                                        STEPS, WARMUP)[0], LR, STEPS,
                         WARMUP, step=1)
    assert sched.last_epoch == 1
    assert sched.get_last_lr() == ref.get_last_lr()
    assert [g["lr"] for g in opt.param_groups] == ref.get_last_lr()


def test_train_step_after_load_matches_jax(weights, jax_steps):
    _, _, _, batches = weights
    path, _, st2, jloss = jax_steps
    model, opt, sched, _ = _port_from(path)
    metrics, _ = train_step(model, opt, sched,
                            *(torch.from_numpy(a) for a in batches[1]))
    np.testing.assert_allclose(metrics["loss"].item(), jloss, rtol=1e-5)
    assert sched.last_epoch == 2
    adam = st2.opt_state[2]
    moments = _moments(model, opt)
    for name, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        pairs = []
        for jpath, key, transpose in key_map(CFG):
            if jpath[0] == "params":
                want = np.asarray(_lookup(tree, jpath[1:]))
                pairs.append((key, moments[key][name].numpy(),
                              want.T if transpose else want))
        scale = max(np.linalg.norm(w) for _, _, w in pairs)
        bad = [f"{k}: {np.linalg.norm(g - w):.3e} vs {np.linalg.norm(w):.3e}"
               for k, g, w in pairs
               if not np.linalg.norm(g - w) <= 5e-3 * np.linalg.norm(w)
               + 1e-6 * scale]
        assert not bad, (name, bad)
    assert all(float(s["step"]) == 2.0 for s in opt.state.values())


def test_params_only_file_leaves_the_optimizer_fresh(weights, tmp_path):
    params, state, sd, _ = weights
    path = str(tmp_path / "p.ckpt")
    save_checkpoint(path, {"params": params, "bn_state": state,
                           "opt_state": {}, "step": 0})
    model, opt, sched, step = _port_from(path)
    assert step is None and not opt.state and sched.last_epoch == 0
    for k, v in sd.items():
        assert torch.equal(model.state_dict()[k], v), k


def test_convert_checkpoint_cli_matches_jax_conversion(weights, tmp_path,
                                                        capsys):
    """``python -m rel_pose_tpu_torch.cli.convert_checkpoint`` on a
    reference-style ``.pth`` (``module.`` keys) writes the ``.ckpt`` the
    JAX package's ``load_params_only`` reads as its own converter's
    ``load_torch_checkpoint`` reads the ``.pth``: equal arrays."""
    from rel_pose_tpu.utils.convert import load_torch_checkpoint
    from rel_pose_tpu_torch.cli import convert_checkpoint
    _, _, sd, _ = weights
    pth, out = tmp_path / "ref.pth", tmp_path / "ref.ckpt"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}}, pth)
    assert convert_checkpoint.main(["--ckpt", str(pth), "--out", str(out),
                                    "--transformer_depth", "2"]) == 0
    assert f"converted {pth} -> {out}" in capsys.readouterr().out
    want_p, want_s = load_torch_checkpoint(str(pth), _jax_cfg(CFG))
    got_p, got_s = load_params_only(
        str(out), *vitess_init(jax.random.PRNGKey(0), _jax_cfg(CFG)))
    for got, want in ((got_p, want_p), (got_s, want_s)):
        _assert_tree_equal(serialization.to_state_dict(_np(got)),
                           serialization.to_state_dict(_np(want)))
    with pytest.raises(SystemExit, match="expected a .pth"):
        convert_checkpoint.main(["--ckpt", str(out), "--out", "x.ckpt"])
