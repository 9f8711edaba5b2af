"""The port's data parallelism (``rel_pose_tpu_torch.parallel``) on the CPU.

Two gloo ranks and a world of one, each a process running
tests/torch_ddp_worker.py (started side by side with ``subprocess`` on free
ports, as tests/test_multihost.py starts its JAX processes, each with its
own timeout), on the small flagship of tests/multihost_worker.py: depth 2,
feature 8x8, fc 64, fp32, 96x128 uint8 pairs, a global batch of 4 split
into two contiguous halves.  The rule under test: an N-rank step on N
equal shards computes what one process computes on their union, up to
summation order.

Tolerances, with their reasons:

  * ``batchnorm_train`` over two ranks against one process on the union,
    float64: the output, the input gradient (of a seeded cotangent) and
    the running statistics within 1e-12 -- the same arithmetic with the
    batch sums split in two (2.2e-16 measured);
  * the DDP step against the JAX package's ``make_train_step`` on the
    whole batch, with tests/test_torch_train.py's stated bounds and
    reasons: the global loss rtol 1e-5; the parameters' one-step updates
    elementwise within 2 lr of JAX's, per leaf within 25% in norm and the
    median leaf within 1%; the running statistics 1e-5 relative, counts
    exact;
  * the DDP step against the port's own step on the whole batch: the loss
    rtol 1e-6 (fp32, the BatchNorm sums split in two; 1e-7 measured), the
    post-clip gradients per leaf within tests/test_torch_train.py's
    gradient bound, 5e-3 of the leaf's norm plus 1e-6 of the largest --
    training BatchNorm's cancellation amplifies the split's rounding on
    the trunk (1.7e-3 measured on resnet.layer2.1.bn1.bias, 3.5e-6 the
    median leaf), the conv biases before a BatchNorm have an exact
    gradient of 0;
  * bit for bit: the two ranks' parameters, buffers and Adam moments after
    the step; a world of one under DDP against the plain step;
  * exactly: the FLOP count of a train step that each rank of the 2 and
    the world of one takes on the meta device (the training CLI's MFU
    numerator).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from rel_pose_tpu import config as jconfig
from rel_pose_tpu.train import TrainState
from rel_pose_tpu.train import make_optimizer as jmake_optimizer
from rel_pose_tpu.train import make_train_step
from rel_pose_tpu.train.optim import onecycle_schedule
from rel_pose_tpu.utils.convert import convert_torch_state_dict
from rel_pose_tpu_torch.models.vitess import ViTEss
from rel_pose_tpu_torch.nn.init import seeded_state_dict
from rel_pose_tpu_torch.utils.convert import key_map, state_dict_from_jax
import torch_ddp_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = worker.CFG


def _free_port():
    from rel_pose_tpu_torch.parallel.dist import free_port
    return free_port()


def run_world(world, out_dir, timeout=300):
    """Start ``world`` ranks of tests/torch_ddp_worker.py on a free port;
    -> the Popen handles."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_ddp_worker.py"),
             str(out_dir)], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return [(p, timeout) for p in procs]


def wait_all(procs):
    outs = []
    for p, timeout in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            raise
        outs.append(out)
    for (p, _), out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def _lookup(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' results ({"r0", "r1": the two ranks', "one": the world
    of one's}) and the JAX step's, computed while the workers run."""
    out = tmp_path_factory.mktemp("ddp")
    procs = run_world(2, out) + run_world(1, out)
    try:
        reference = jax_step()
    finally:
        wait_all(procs)
    load = lambda name: torch.load(out / name, weights_only=False)
    return {"r0": load("rank0_of2.pt"), "r1": load("rank1_of2.pt"),
            "one": load("rank0_of1.pt")}, reference


@pytest.fixture(scope="module")
def results(runs):
    return runs[0]


def jax_step():
    """The JAX package's ``make_train_step`` on the whole batch from the
    workers' weights: (weights before, state after, loss, lr of the
    step)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("RELPOSE_NO_PALLAS", "1")
    try:
        jcfg = jconfig.ModelConfig(**dataclasses.asdict(CFG))
        sd = seeded_state_dict(ViTEss(CFG, device="meta"), worker.SEED)
        params, state = convert_torch_state_dict(sd, jcfg)
        to_np = lambda tree: jax.tree.map(np.asarray, tree)
        back = state_dict_from_jax(to_np(params), to_np(state), CFG)
        for k, v in sd.items():
            torch.testing.assert_close(back[k], v, rtol=0, atol=0)
        tx, _ = jmake_optimizer(worker.LR, worker.STEPS, worker.WARMUP)
        jstate = TrainState.create(jax.tree.map(jnp.array, params),
                                   jax.tree.map(jnp.array, state), tx)
        step_fn = make_train_step(jcfg, tx)
        jstate, metrics, _ = step_fn(
            jstate, *map(jnp.asarray, worker.global_batch()))
        lr = float(onecycle_schedule(worker.LR, worker.STEPS,
                                     worker.WARMUP)(0))
        return params, jstate, float(metrics["loss"]), lr
    finally:
        mp.undo()


def test_batchnorm_two_ranks_match_one_process(results):
    want = results["one"]["bn"]
    got = [results[r]["bn"] for r in ("r0", "r1")]
    for key in ("y", "dx"):
        torch.testing.assert_close(torch.cat([g[key] for g in got]),
                                   want[key], rtol=0, atol=1e-12)
    for g in got:
        for key in ("mean", "var"):
            torch.testing.assert_close(g[key], want[key], rtol=0,
                                       atol=1e-12)
        assert g["count"] == want["count"] == 1


def test_ddp_step_matches_jax_on_the_union(runs):
    results, (params, jstate, jloss, lr) = runs
    train = results["r0"]["train"]
    np.testing.assert_allclose(train["metrics"]["loss"], jloss, rtol=1e-5)
    state = train["state"]
    rel, n_state = [], 0
    for path, key, transpose in key_map(CFG):
        if path[0] == "state":
            want = _lookup(jstate.bn_state, path[1:])
            got = state[key].numpy()
            if key.endswith("num_batches_tracked"):
                assert got == want == 1, key
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           atol=1e-5 * np.abs(want).max(),
                                           err_msg=key)
            n_state += 1
            continue
        before = _lookup(params, path[1:])
        want = _lookup(jstate.params, path[1:]) - before
        if transpose:
            before, want = before.T, want.T
        got = state[key].numpy() - before
        assert np.abs(got - want).max() <= 2 * lr, key
        rel.append(np.linalg.norm(got - want) / np.linalg.norm(want))
    assert n_state == 3 * 13
    assert max(rel) <= 0.25 and np.median(rel) <= 1e-2, (max(rel),
                                                         np.median(rel))


def test_ddp_step_matches_the_port_on_the_union(results):
    got, want = results["r0"]["train"], results["one"]["plain"]
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-6,
                                   err_msg=k)
    scale = max(g.norm().item() for g in want["grads"].values())
    bad = []
    for k, g in want["grads"].items():
        err = (got["grads"][k] - g).norm().item()
        if not err <= 5e-3 * g.norm().item() + 1e-6 * scale:
            bad.append(f"{k}: {err:.3e} vs |g| {g.norm().item():.3e}")
    assert not bad, bad


def _assert_equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal_trees(a[k], b[k])
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    else:
        assert a == b


def test_ranks_hold_the_same_state_bit_for_bit(results):
    a, b = results["r0"]["train"], results["r1"]["train"]
    for key in ("metrics", "state", "grads", "adam"):
        _assert_equal_trees(a[key], b[key])


def test_world_of_one_is_the_plain_step_bit_for_bit(results):
    plain, ddp = results["one"]["plain"], results["one"]["ddp"]
    for key in ("metrics", "state", "grads", "adam"):
        _assert_equal_trees(plain[key], ddp[key])


def test_ddp_step_raises_no_warning(results):
    """No DDP warning in the step: a gradient whose strides differ from
    its bucket view's would raise one every step."""
    for r in ("r0", "r1"):
        assert results[r]["train"]["warnings"] == []
    assert results["one"]["ddp"]["warnings"] == []


@pytest.mark.parametrize("case,counts", [("gather_a", (3, 0)),
                                         ("gather_b", (0, 2))])
def test_allgather_ragged_is_rank_major(results, case, counts):
    """Rank r's rows are ``[10 r + i] * d``, i < its count: the gathered
    rows are rank 0's then rank 1's, float32, the same on both ranks."""
    for name, d in (("a", 3), ("b", 4)):
        want = np.array([[10 * r + i] * d for r in range(2)
                         for i in range(counts[r])],
                        np.float32).reshape(-1, d)
        for r in ("r0", "r1"):
            got = results[r][case][name]
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def test_step_flops_in_a_world_are_one_process_s(results):
    """The training CLI's MFU numerator: a train step of the global batch
    counted on the meta device inside a world of 2 (where training
    BatchNorm would all-reduce) equals the count of a world of one."""
    flops = [results[k]["flops"] for k in ("r0", "r1", "one")]
    assert flops[0] is not None and flops[0] > 0
    assert flops == [flops[0]] * 3


def test_unequal_shards_are_refused_on_every_rank(results):
    for r in ("r0", "r1"):
        assert results[r]["unequal"].startswith(
            "unequal shards: the ranks hold [2, 1] samples")
