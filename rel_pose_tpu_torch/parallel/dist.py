"""Data parallelism over processes: one rank per GPU, as the reference's
``mp.spawn`` + DDP runs it (its ``train.py:28-36``), with the JAX package's
global-batch semantics.

Counterpart of ``rel_pose_tpu/parallel/mesh.py`` in torch's idiom.  Where
the JAX package jits one program over a ``('data',)`` mesh, the port runs
one process per device and joins them in a ``torch.distributed`` world:

  * :func:`init_distributed` joins the world that torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) describes, a no-op without it (as
    ``maybe_init_distributed``, ``mesh.py:33-52``, is on one host);
    :func:`spawn` starts such a world of local ranks, as ``--gpus N``
    does;
  * :func:`wrap_ddp` puts a model under ``DistributedDataParallel``, which
    averages the gradients over the ranks in the backward;
  * ``nn.layers.batchnorm_train`` takes the training BatchNorm statistics
    over the global batch (:func:`all_reduce_sum`, differentiable), as XLA
    does over the mesh (``rel_pose_tpu/nn/layers.py:82-111``), and
    :func:`all_reduce_mean` turns each rank's metrics into the global means
    that the JAX step returns.  Together: an N-rank step on N equal shards
    computes what one process computes on their union, up to summation
    order (:func:`check_equal_shards` asserts the shards are equal);
  * :func:`allgather_ragged` gathers the eval CLIs' per-pair rows
    (``mesh.py:107-136``).

Host-side collectives (the gather, the shard sizes, barriers) go over a
gloo group beside the default one, so they work beside NCCL and with
several ranks sharing one card; with a gloo default group it is that
group.
"""

import datetime
import hashlib
import os
import socket
import warnings

import numpy as np
import torch
import torch.distributed as dist

#: how long a collective may wait for the other ranks before it fails
TIMEOUT = datetime.timedelta(minutes=10)

_host_group = None


def launched():
    """True when torchrun's environment names a world to join."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_distributed(device_type, backend=None):
    """Join the world of torchrun's environment and return this rank's
    device; without that environment, return the process's device and
    join nothing.

    ``backend`` defaults to ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``;
    callers may name another (``gloo`` on ``cuda`` lets several ranks share
    one card, which NCCL refuses).  On ``cuda`` the rank's device,
    ``cuda:<LOCAL_RANK>``, is made current before anything touches the
    card: the kernel library launches on the current device's current
    stream (``ops._build.prepare_launch``).  Over gloo, ranks beyond the
    visible GPUs wrap around onto them."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"init_distributed: device type {device_type!r}")
    if not launched():
        return (torch.device("cuda", torch.cuda.current_device())
                if device_type == "cuda" else torch.device("cpu"))
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = torch.device("cpu")
    if device_type == "cuda":
        n = torch.cuda.device_count()
        if backend == "nccl" and local >= n:
            raise SystemExit(f"LOCAL_RANK {local}, but {n} GPUs are "
                             "visible: NCCL takes one GPU a rank")
        device = torch.device("cuda", local % n)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                timeout=TIMEOUT)
    global _host_group
    _host_group = (dist.group.WORLD if dist.get_backend() == "gloo"
                   else dist.new_group(backend="gloo", timeout=TIMEOUT))
    return device


def shutdown():
    """Leave the world (after a barrier, so that no rank tears its end down
    while another still talks); a no-op outside one."""
    global _host_group
    if dist.is_initialized():
        barrier()
        dist.destroy_process_group()
    _host_group = None


def joined():
    """True inside a world (of any size) this process has joined."""
    return dist.is_initialized()


def backend():
    """The default group's backend, or None outside a world."""
    return dist.get_backend() if dist.is_initialized() else None


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def is_main():
    return rank() == 0


def barrier():
    if dist.is_initialized():
        dist.barrier(group=_host_group)


def build_kernels_once(device):
    """On the card in a world of several ranks, rank 0 builds the kernel
    library (``ops._build.build``) while the others wait at a barrier, so
    that one ``nvcc`` build runs, not one a rank; they then load its
    file.  (A concurrent build would also be safe: it writes per-process
    temporaries and renames the library into place.)"""
    if device.type != "cuda" or world_size() <= 1:
        return
    if is_main():
        from ..ops import _build
        _build.build()
    barrier()


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(local_rank, fn, nprocs, port, args):
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(nprocs), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    fn(*args)


def spawn(fn, nprocs, args=()):
    """Run ``fn(*args)`` in ``nprocs`` new local processes that form a
    world on a free port (``torch.multiprocessing.spawn``, the reference's
    ``mp.spawn``); each finds torchrun's variables set, so ``fn`` joins with
    :func:`init_distributed`.  Raises ``SystemExit`` when a rank fails; the
    others are stopped."""
    import torch.multiprocessing as mp
    try:
        mp.spawn(_rank_entry, args=(fn, nprocs, free_port(), args),
                 nprocs=nprocs, join=True)
    except (mp.ProcessExitedException, mp.ProcessRaisedException) as e:
        raise SystemExit(f"rank {e.error_index} of {nprocs} failed: "
                         f"{e}") from None


def wrap_ddp(model, device):
    """``model`` under ``DistributedDataParallel``, with the options the
    port's step relies on:

      * ``broadcast_buffers=False``: the BatchNorm running statistics move
        by the same all-reduced numbers on every rank, so they stay equal
        by construction (the tests check it); a broadcast every forward
        would cost a collective and hide a divergence;
      * ``find_unused_parameters=False``: every configuration's every
        parameter gets a gradient (conv biases before a BatchNorm get
        their near-zero one);
      * ``gradient_as_bucket_view=True``: each gradient is copied once into
        its all-reduce bucket and then stays a view of it, where the
        default copies it back after the all-reduce.  The ViT stack's
        backward writes its 12 stacked fp32 gradients at once; the stack's
        autograd hands each block its contiguous slice, whose strides are
        the bucket view's, so DDP warns of no stride mismatch.

    The hand kernels' backward launches on the stream that is current
    inside ``backward``, the one the autograd engine gives the node (its
    forward's), and the reducer copies each gradient into its bucket on
    that stream after the node has run: no bucket is read before its
    kernel wrote it."""
    from torch.nn.parallel import DistributedDataParallel
    ids = [device.index] if device.type == "cuda" else None
    with warnings.catch_warnings():
        # newer PyTorch names the option forward_sync_buffers, which still
        # broadcasts the buffers at construction; broadcast_buffers=False
        # is the option that does not
        warnings.filterwarnings("ignore", ".*broadcast_buffers",
                                FutureWarning)
        return DistributedDataParallel(
            model, device_ids=ids, output_device=ids[0] if ids else None,
            broadcast_buffers=False, find_unused_parameters=False,
            gradient_as_bucket_view=True)


def unwrap(model):
    """The module under a ``DistributedDataParallel``, else ``model``."""
    from torch.nn.parallel import DistributedDataParallel
    return model.module if isinstance(model, DistributedDataParallel) \
        else model


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; its backward sums the cotangents the same way,
    so each rank's input gradient carries every rank's loss."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def all_reduce_sum(x):
    """Differentiable sum of ``x`` over the ranks of the default group."""
    return _AllReduceSum.apply(x)


def all_reduce_mean(metrics):
    """``{name: scalar tensor}`` of this rank -> the means over the ranks,
    one all-reduce for all of them; unchanged in a world of one."""
    if world_size() <= 1:
        return metrics
    names = list(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in names])
    dist.all_reduce(flat)
    flat = flat / world_size()
    return {k: flat[i].to(metrics[k].dtype) for i, k in enumerate(names)}


def gather_objects(obj):
    """Every rank's picklable ``obj``, in rank order (``[obj]`` outside a
    world), over the host group."""
    if world_size() <= 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj, group=_host_group)
    return out


def shard_sizes(n):
    """Every rank's ``n``, in rank order."""
    return gather_objects(int(n))


def state_digest(model):
    """sha256 of ``model``'s state dict (names and bytes), parameters and
    buffers; a module under DDP is digested as the module it wraps."""
    h = hashlib.sha256()
    for k, v in unwrap(model).state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def check_same_state(model, when):
    """Raise ``RuntimeError`` on every rank unless every rank holds the
    same parameters and buffers, bit for bit."""
    digests = gather_objects(state_digest(model))
    if len(set(digests)) > 1:
        raise RuntimeError(f"{when}: the ranks' parameters and buffers "
                           f"differ (digests {[d[:12] for d in digests]})")


def check_equal_shards(n):
    """Raise ``ValueError`` on every rank unless every rank holds ``n``
    samples: DDP averages each rank's mean loss, which is the mean over
    the global batch only when the shards are equal."""
    sizes = shard_sizes(n)
    if len(set(sizes)) > 1:
        raise ValueError(f"unequal shards: the ranks hold {sizes} samples; "
                         "data parallelism needs the same number on every "
                         "rank")


def allgather_ragged(named_lists):
    """Gather per-rank ragged row lists across all ranks.

    ``named_lists``: dict of name -> (list of length-d rows, d).  Every
    rank participates (collective over the gloo host group); returns dict
    of name -> (sum_p n_p, d) float32 arrays holding every rank's rows in
    rank-major order, identical on all ranks.  The eval CLIs assemble the
    per-pair predictions with it after each rank evaluated its shard of
    the test set."""
    flat = {k: (np.asarray(v, np.float32).reshape(len(v), d)
                if len(v) else np.zeros((0, d), np.float32))
            for k, (v, d) in named_lists.items()}
    ns = {a.shape[0] for a in flat.values()}
    assert len(ns) == 1, f"ragged lists disagree on local count: {ns}"
    gathered = gather_objects(flat)
    return {k: np.concatenate([g[k] for g in gathered]) for k in flat}
