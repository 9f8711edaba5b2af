"""One rank of the port's data-parallel CPU checks (tests/test_torch_ddp.py).

    RANK=r WORLD_SIZE=w LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/torch_ddp_worker.py <out_dir>

joins the gloo world of its environment (``parallel.init_distributed``)
and writes ``<out_dir>/rank<r>_of<w>.pt``.  It imports torch and the port,
never jax.  In a world of 2 each rank takes its contiguous half of the
seeded global batch (:func:`global_batch`) and runs:

  * ``train``: one ``train_step`` of the DDP-wrapped model (:data:`CFG`,
    weights ``seeded_state_dict(seed=SEED)``); its metrics, state dict,
    gradients and Adam state, and the warnings the step raised;
  * ``gather_a`` / ``gather_b``: ``allgather_ragged`` with 3 rows on rank
    0 and none on rank 1, then none on rank 0 and 2 on rank 1;
  * ``unequal``: the message of the ``ValueError`` that ``train_step``
    raises when rank 1 holds one pair fewer;
  * ``bn``: ``batchnorm_train`` in float64 on the rank's half of
    :func:`bn_inputs`: its output, input gradient and running statistics.

In a world of 1 it runs the references: ``plain`` (the step without DDP
on the whole batch), ``ddp`` (the same step under DDP) and ``bn`` (the
float64 BatchNorm on the whole input).  In both worlds ``flops`` is
``utils.profiling.estimate_step_flops`` of a train step of the global
batch, counted on the meta device inside the world, as the training CLI
counts it for MFU.
"""

import contextlib
import os
import sys
import warnings

import numpy as np
import torch

torch.set_num_threads(2)

SEED = 11
B, H, W = 4, 96, 128
LR, STEPS, WARMUP = 5e-4, 20, 5


def config():
    from rel_pose_tpu_torch.config import ModelConfig
    return ModelConfig(compute_dtype="float32", transformer_depth=2,
                       feature_height=8, feature_width=8, pool_size=8,
                       fc_hidden_size=64)


CFG = config()


def random_poses(rng, n):
    poses = np.zeros((n, 2, 7), np.float32)
    poses[..., 6] = 1.0
    q = rng.standard_normal((n, 4))
    q[:, 3] = np.abs(q[:, 3]) + 2.0
    poses[:, 1, 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    poses[:, 1, :3] = 0.3 * rng.standard_normal((n, 3))
    return poses


def global_batch():
    """(images uint8, poses, intrinsics) of the B pairs of the global
    batch."""
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (B, 2, 3, H, W), dtype=np.uint8)
    intr = np.tile(np.float32([100, 100, W / 2, H / 2]), (B, 2, 1))
    return images, random_poses(rng, B), intr


def bn_inputs():
    """float64 x (4, 8, 5, 7), a cotangent of its shape, and the
    BatchNorm's weight, bias and running statistics."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((4, 8, 5, 7)) * 2 + 0.5
    cot = rng.standard_normal(x.shape)
    affine = [1 + 0.1 * rng.standard_normal(8), 0.1 * rng.standard_normal(8),
              0.1 * rng.standard_normal(8), rng.uniform(0.5, 1.5, 8)]
    return x, cot, affine


def state_dict(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def step(model, batch, ddp):
    """One ``train_step`` of ``model`` (under DDP when ``ddp``) ->
    metrics, state dict, post-clip gradients, Adam state, warnings."""
    from rel_pose_tpu_torch import parallel
    from rel_pose_tpu_torch.train.optim import make_optimizer
    from rel_pose_tpu_torch.train.step import train_step
    opt, sched = make_optimizer(model, LR, STEPS, WARMUP)
    run = parallel.wrap_ddp(model, torch.device("cpu")) if ddp else model
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        metrics, _ = train_step(run, opt, sched,
                                *(torch.from_numpy(a) for a in batch))
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "state": state_dict(model),
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()},
            "adam": opt.state_dict()["state"],
            "warnings": [str(w.message) for w in caught]}


@contextlib.contextmanager
def float64_casts():
    """``Tensor.float`` widens to float64 (``batchnorm_train`` takes its
    statistics through it), as tests/test_torch_train.py's float64 child
    does."""
    saved = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: self.double()
    try:
        yield
    finally:
        torch.Tensor.float = saved


def batchnorm(lo, hi):
    """float64 ``batchnorm_train`` on rows lo:hi of :func:`bn_inputs`."""
    from rel_pose_tpu_torch.nn.layers import batchnorm_train
    x, cot, affine = bn_inputs()
    bn = torch.nn.BatchNorm2d(8).double()
    with torch.no_grad():
        for t, v in zip((bn.weight, bn.bias, bn.running_mean,
                         bn.running_var), affine):
            t.copy_(torch.from_numpy(v))
    xs = torch.from_numpy(x[lo:hi]).requires_grad_()
    with float64_casts():
        y = batchnorm_train(xs, bn)
        (y * torch.from_numpy(cot[lo:hi])).sum().backward()
    return {"y": y.detach(), "dx": xs.grad, "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone(),
            "count": int(bn.num_batches_tracked)}


def model():
    from rel_pose_tpu_torch.models.vitess import ViTEss
    from rel_pose_tpu_torch.nn.init import seeded_state_dict
    m = ViTEss(CFG, device="cpu")
    m.load_state_dict(seeded_state_dict(ViTEss(CFG, device="meta"), SEED))
    return m


def main(out_dir):
    from rel_pose_tpu_torch import parallel
    from rel_pose_tpu_torch.train.step import train_step
    parallel.init_distributed("cpu")
    rank, world = parallel.rank(), parallel.world_size()
    batch = global_batch()
    from rel_pose_tpu_torch.utils.profiling import estimate_step_flops
    out = {"flops": estimate_step_flops(CFG, B, "train")}
    if world == 1:
        out["plain"] = step(model(), batch, ddp=False)
        out["ddp"] = step(model(), batch, ddp=True)
        out["bn"] = batchnorm(0, B)
    else:
        per = B // world
        local = tuple(a[rank * per:(rank + 1) * per] for a in batch)
        out["train"] = step(model(), local, ddp=True)
        rows = {"a": ([[rank * 10 + i] * 3 for i in range(3)], 3),
                "b": ([[rank * 10 + i] * 4 for i in range(3)], 4)}
        for case, counts in (("gather_a", (3, 0)), ("gather_b", (0, 2))):
            n = counts[rank]
            out[case] = parallel.allgather_ragged(
                {k: (v[:n], d) for k, (v, d) in rows.items()})
        m = parallel.wrap_ddp(model(), torch.device("cpu"))
        from rel_pose_tpu_torch.train.optim import make_optimizer
        opt, sched = make_optimizer(m, LR, STEPS, WARMUP)
        short = tuple(torch.from_numpy(a[:per - rank]) for a in local)
        try:
            train_step(m, opt, sched, *short)
            out["unequal"] = None
        except ValueError as e:
            out["unequal"] = str(e)
        out["bn"] = batchnorm(rank * per, (rank + 1) * per)
    torch.save(out, os.path.join(out_dir, f"rank{rank}_of{world}.pt"))
    parallel.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
