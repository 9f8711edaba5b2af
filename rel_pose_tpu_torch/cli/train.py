"""Training CLI of the PyTorch port, on one GPU or data parallel over
several.

    python -m rel_pose_tpu_torch.cli.train --name exp --dataset matterport \\
        --datapath <root> --batch 6 --fusion_transformer --gpus 4 \\
        --compute_dtype bfloat16
    torchrun --nproc_per_node 4 -m rel_pose_tpu_torch.cli.train ...

Counterpart of the JAX package's ``train.py`` with the same flags and
defaults (``train.py:35-71``), plus ``--device`` (``cuda``, the default, or
``cpu``).  Without ``--fusion_transformer`` it trains the no-fusion
baseline, as ``train.py`` does.  What it keeps of ``train.py:72-315``:

  * the args snapshot ``output/<name>/args_<stamp>.txt``;
  * weights from PyTorch's default initializers under
    ``torch.manual_seed(0)``; Adam + OneCycle (``train.optim``);
  * ``--resnet_pretrained``: the conv trunk from a local torchvision
    resnet18 file, overridden by any checkpoint restored after it;
  * ``--ckpt`` on a ``.pth``: the model and the Adam moments, with the
    learning-rate schedule and the step count fresh (the reference's
    ``train.py:75-86``); on a ``.ckpt`` of the JAX package: a full train
    state goes on from its step (weights, Adam moments, the schedule at
    that step), a weights-only file (``convert_checkpoint``) restores the
    weights with a fresh optimizer, as ``train.py:127-156`` does; else
    auto-resume from the newest ``output/<name>/checkpoints/*.pth``;
  * the subepoch protocol: subepochs 0-9 train on the dataset, subepoch 10
    validates (``train.step.eval_step``) for Matterport, InteriorNet and
    StreetLearn reset at 10;
  * a checkpoint every ``--ckpt_every`` steps and at ``--steps``, written
    on a worker thread (``train.checkpoint.AsyncCheckpointer``,
    ``train.py:200,289-295,309``): the loop waits only for the host copy,
    and the writer is drained before "finished training!", also when the
    loop raises;
  * step k's metrics read on the host (``.item()``) only after step k + 1
    is queued, so that the card is never drained to log;
  * ``--remat``: the forward rematerialized in the backward
    (``train.step.train_step(..., remat=True)``, as ``train.py:58-60``
    passes it to ``make_train_step``): less activation memory, so larger
    per-GPU batches, for one more forward of the checkpointed stages a
    step; the update is the one the step makes without it;
  * a one-batch device prefetch: batch k + 1 is pinned and copied
    ``non_blocking`` before step k runs; uint8 images go to the card as
    they are, and the model casts them.

Data parallel (``parallel``), one process per GPU as the reference's
``mp.spawn`` + DDP: ``--gpus N`` (default: every visible GPU; 1 with
``--device cpu``) starts N local ranks, each on ``cuda:<local rank>`` over
NCCL, or on the CPU over gloo with ``--device cpu``; under torchrun the CLI
joins the world it is given; ``--no_ddp`` trains in one process.  The
global batch is ``--batch`` x the world size: each rank's loader takes
shard ``rank`` of ``world`` at ``--batch`` (``train.py:216-219`` with one
device a process), its model is under ``DistributedDataParallel``, the
training BatchNorm's statistics and the logged metrics are the global
batch's.  Every rank draws the same weights and restores the same
checkpoint, and the ranks' weights are checked equal after DDP's initial
broadcast; rank 0 alone writes the args snapshot, the logger's files and
the checkpoints (``train.py:244,287-293``), whose keys are the unwrapped
model's.  On the card, rank 0 builds the kernel library while the others
wait, so that one ``nvcc`` build runs, not N.

``--image_size`` is accepted and, as in ``train.py``, not passed to the
datasets (they resize to 384x512).  At the end it writes one record with
the steady-state pairs/s (``utils.profiling.StepTimer``) and the share of
the loop's time spent waiting on the data loader to
``output/<name>/runs/metrics.jsonl``.  Where a peak is known
(``utils.profiling.peak_flops``: ``$RELPOSE_PEAK_TFLOPS``, or a bf16 model
on an H100 SXM) the training metrics and that record carry ``mfu``: the
global batch's matmul / conv FLOPs (``estimate_step_flops``, counted once
at start: the model's FLOPs, without ``--remat``'s recompute) x steps/s /
world size / peak, as ``train.py:167-199,251-252``; otherwise MFU is left
out.

It refuses, with a message: ``--device cuda`` without a GPU (there is no
CPU fallback), ``--gpus`` beyond the visible GPUs or other than torchrun's
world, ``--no_ddp`` under a world of several ranks, and ranks given
unequal ``--batch`` (unequal shards).
"""

import argparse
import contextlib
import os
import sys
import time
from datetime import datetime

import numpy as np
import torch

from .. import parallel
from ..config import add_model_flags, model_config_from_args

SEED = 0   # the reference's torch.manual_seed(0) (train.py:35)


def build_parser():
    parser = argparse.ArgumentParser(
        prog="python -m rel_pose_tpu_torch.cli.train")
    # training (reference flags, train.py:219-231)
    parser.add_argument("--w_tr", type=float, default=10.0)
    parser.add_argument("--w_rot", type=float, default=10.0)
    parser.add_argument("--warmup", type=int, default=10000)
    parser.add_argument("--batch", type=int, default=1,
                        help="per-device batch (DDP semantics)")
    parser.add_argument("--steps", type=int, default=120000)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--clip", type=float, default=2.5)
    parser.add_argument("--weight_decay", type=float, default=1e-5)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--no_ddp", action="store_true", default=False,
                        help="train in one process on a single device")
    parser.add_argument("--gpus", type=int, default=None,
                        help="local ranks to start, one a GPU (default: "
                             "every visible GPU; 1 with --device cpu)")
    parser.add_argument("--ckpt", help="a .pth checkpoint to warm-start "
                        "from (model and Adam moments), or a .ckpt of the "
                        "JAX package (a full train state, or weights only)")
    parser.add_argument("--resnet_pretrained",
                        help="path to torchvision resnet18 weights "
                             "(ImageNet) to initialize the conv trunk of a "
                             "fresh run")
    parser.add_argument("--name", default="bla", help="name your experiment")
    parser.add_argument("--remat", action="store_true", default=False,
                        help="rematerialize the forward in the backward "
                             "pass (larger per-GPU batches at about one "
                             "more forward a step)")
    # data
    parser.add_argument("--datapath")
    parser.add_argument("--image_size", default=[384, 512],
                        help="accepted and unused, as in train.py")
    parser.add_argument("--exp")
    parser.add_argument("--use_mini_dataset", action="store_true")
    parser.add_argument("--streetlearn_interiornet_type", default="",
                        choices=("", "T"))
    parser.add_argument("--dataset", default="matterport",
                        choices=("matterport", "interiornet", "streetlearn"))
    parser.add_argument("--ckpt_every", type=int, default=10000)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (a GPU a rank) or cpu (gloo ranks)")
    add_model_flags(parser)
    return parser


def _refuse(message):
    raise SystemExit(f"rel_pose_tpu_torch.cli.train: {message}")


def check_args(args):
    """Refuse what the port does not do; -> the number of local ranks to
    start (1: this process trains, alone or as a rank of torchrun's
    world)."""
    if args.gpus is not None and args.gpus < 1:
        _refuse(f"--gpus {args.gpus}: at least one rank")
    if args.device == "cuda" and not torch.cuda.is_available():
        _refuse("--device cuda, but no CUDA device is visible; pass "
                "--device cpu to train on the CPU")
    if parallel.launched():
        world = int(os.environ["WORLD_SIZE"])
        if args.no_ddp and world > 1:
            _refuse(f"--no_ddp under torchrun's world of {world} ranks")
        if not args.no_ddp and args.gpus not in (None, world):
            _refuse(f"--gpus {args.gpus} under torchrun's world of {world} "
                    "ranks")
        return 1
    if args.no_ddp:
        return 1
    if args.device == "cpu":
        return args.gpus or 1
    visible = torch.cuda.device_count()
    if args.gpus is not None and args.gpus > visible:
        _refuse(f"--gpus {args.gpus}, but {visible} GPUs are visible")
    return args.gpus or visible


class _TimedIter:
    """An iterator that adds the seconds its ``next`` blocks to ``wait``."""

    def __init__(self, iterable):
        self._it = iter(iterable)
        self.wait = 0.0

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        try:
            return next(self._it)
        finally:
            self.wait += time.perf_counter() - t0


def device_batches(host_batches, device):
    """One-batch device prefetch: batch k + 1's host-to-device copy is
    queued (pinned memory, ``non_blocking``) before batch k is handed out,
    so the copy overlaps step k.  Yields ``(host arrays, device tensors)``."""
    cuda = device.type == "cuda"
    prev = None
    for host in host_batches:
        ts = tuple(torch.from_numpy(a) for a in host)
        if cuda:
            ts = tuple(t.pin_memory().to(device, non_blocking=True)
                       for t in ts)
        if prev is not None:
            yield prev
        prev = (host, ts)
    if prev is not None:
        yield prev


def build_model(cfg, device, seed=SEED):
    """The model with PyTorch's default initializers under
    ``torch.manual_seed(seed)``, drawn on the CPU as the reference's model
    is (built on the CPU, then moved), then moved to ``device``."""
    from ..models.vitess import ViTEss
    from ..nn.init import torch_default_init
    torch.manual_seed(seed)
    model = torch_default_init(ViTEss(cfg, device="cpu"))
    return model.to(device)


def load_resnet_pretrained(model, path):
    from ..utils.convert import load_torchvision_resnet18
    trunk = load_torchvision_resnet18(path)
    expected = {k for k in model.state_dict() if k.startswith("resnet.")}
    missing = expected - set(trunk)
    if missing:
        _refuse(f"--resnet_pretrained {path}: no "
                f"{sorted(missing)[:3]} ... ({len(missing)} trunk entries "
                "missing); expected a torchvision resnet18 state dict")
    model.load_state_dict(trunk, strict=False)


def restore(path, model, opt):
    """The model and the Adam moments from ``path``; the optimizer's groups
    keep this run's learning-rate schedule.  -> the checkpoint dict."""
    from ..train.checkpoint import load_checkpoint
    hyper = [{k: v for k, v in g.items() if k != "params"}
             for g in opt.param_groups]
    ckpt = load_checkpoint(path, model, opt)
    for group, h in zip(opt.param_groups, hyper):
        group.update(h)
    return ckpt


def restore_ckpt(path, model, opt, sched, log=print):
    """A JAX ``.ckpt``: its full train state (weights, Adam moments, the
    schedule at its step; -> that step), or its weights with ``opt`` and
    ``sched`` left fresh (-> 0)."""
    from ..train.checkpoint import load_ckpt_train_state
    step = load_ckpt_train_state(path, model, opt, sched)
    if step is None:
        log("restored weights only (no optimizer state in the file); "
            "the optimizer starts fresh")
        return 0
    log(f"restored the full train state at step {step}")
    return step


def _quiet(*args, **kwargs):
    pass


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if os.environ.get("RANK", "0") == "0":
        print(args)
    nprocs = check_args(args)
    if nprocs > 1:
        print(f"starting {nprocs} ranks ({args.device})")
        parallel.spawn(train, nprocs, args=(args,))
        return 0
    return train(args)


def train(args):
    """Train in this process: alone (``--no_ddp``, or no world to join), or
    as one rank of the world torchrun's environment names."""
    if args.no_ddp:
        device = (torch.device("cpu") if args.device == "cpu" else
                  torch.device("cuda", torch.cuda.current_device()))
    else:
        device = parallel.init_distributed(args.device)
    code = _train(args, device)
    parallel.shutdown()
    return code


def _train(args, device):
    from ..data import DataLoader, dataset_factory
    from ..train.checkpoint import (AsyncCheckpointer, checkpoint_path,
                                    ensure_output_dirs,
                                    find_resume_checkpoint)
    from ..train.logger import Logger
    from ..train.optim import make_optimizer, make_scheduler
    from ..train.step import eval_step, train_step
    from ..utils.profiling import StepTimer, estimate_step_flops, peak_flops

    world, rank = parallel.world_size(), parallel.rank()
    main_rank = rank == 0
    log = print if main_rank else _quiet
    sizes = parallel.shard_sizes(args.batch)
    if len(set(sizes)) > 1:
        _refuse(f"unequal shards: the ranks were given --batch {sizes}; "
                "data parallelism needs the same batch on every rank")
    cfg = model_config_from_args(args)
    if cfg.fusion_transformer:
        parallel.build_kernels_once(device)

    if main_rank:
        ensure_output_dirs(args.name)
        # args snapshot (train.py:278-283)
        stamp = datetime.now().strftime("%Y-%m-%d_%H-%M")
        with open(f"output/{args.name}/args_{stamp}.txt", "w") as f:
            for k, v in vars(args).items():
                f.write(f"{k}  {v}\n")

    global_batch = args.batch * world
    where = f"{device} on rank 0" + (f", {parallel.backend()}"
                                     if parallel.joined() else "")
    log(f"devices: {world} ({where}), per-device batch {args.batch}, "
        f"global batch {global_batch}")

    model = build_model(cfg, device)
    opt, sched = make_optimizer(model, lr=args.lr, steps=args.steps,
                                warmup=args.warmup,
                                weight_decay=args.weight_decay)

    # ImageNet-pretrained trunk for fresh runs (reference src/model.py:31);
    # a checkpoint restored below overrides it
    if args.resnet_pretrained:
        load_resnet_pretrained(model, args.resnet_pretrained)
        log("initialized conv trunk from", args.resnet_pretrained)

    # restore, on every rank: --ckpt warm start (a .pth: schedule and step
    # count fresh; a .ckpt's full train state goes on from its step), else
    # auto-resume from the newest checkpoint, its step count kept and the
    # schedule of these arguments taken at that step, as the JAX CLI's
    # schedule is a function of the restored count
    train_steps = 0
    resume = find_resume_checkpoint(args.name)
    if args.ckpt is not None:
        log("loading separate checkpoint", args.ckpt)
        if args.ckpt.endswith(".pth"):
            restore(args.ckpt, model, opt)
        else:
            train_steps = restore_ckpt(args.ckpt, model, opt, sched, log)
    elif resume is not None:
        log("loading existing checkpoint", resume)
        train_steps = int(restore(resume, model, opt)["scheduler"]
                          ["last_epoch"])
        if train_steps < args.steps:
            sched = make_scheduler(opt, args.lr, args.steps, args.warmup,
                                   step=train_steps)

    step_model = model
    if parallel.joined():
        step_model = parallel.wrap_ddp(model, device)
        parallel.check_same_state(model, "after DDP's initial broadcast")

    logger = Logger(args.name, sched) if main_rank else None
    # MFU: the global batch's model FLOPs (matmul / conv, forward and
    # backward, counted on the meta device) over the GPU's peak; left out
    # where no peak is known
    peak = peak_flops(device, cfg.compute_dtype)
    step_flops = (estimate_step_flops(cfg, global_batch, "train")
                  if peak else None)
    timer = StepTimer(pairs_per_step=global_batch, num_chips=world,
                      flops_per_step=step_flops, peak_flops=peak)
    # rank 0 writes the checkpoints on a worker thread; leaving the block
    # drains it, also when the loop raises, so the last file is whole
    with (AsyncCheckpointer() if main_rank
          else contextlib.nullcontext()) as writer:
        waited = 0.0            # loader wait inside the timer's timed steps
        subepoch = 0
        epoch_count = 0
        should_keep_training = train_steps < args.steps

        while should_keep_training:
            is_training = subepoch != 10
            train_val = "train" if is_training else "val"

            db = dataset_factory(
                [args.dataset], datapath=args.datapath, subepoch=subepoch,
                is_training=is_training,
                streetlearn_interiornet_type=args.streetlearn_interiornet_type,
                use_mini_dataset=args.use_mini_dataset)
            loader = DataLoader(
                db, batch_size=args.batch, shuffle=is_training, seed=SEED,
                epoch=epoch_count * 11 + subepoch,
                num_workers=args.num_workers, num_shards=world,
                shard_index=rank)
            n_batches = len(loader)
            host_batches = _TimedIter(loader)

            def flush_logging(i_batch, metrics, poses_est, poses):
                """Read one step's metrics on the host and log them (rank
                0)."""
                if not main_rank:
                    return
                host_metrics = {k: v.item() for k, v in metrics.items()
                                if k != "loss"}
                if is_training:
                    host_metrics["pairs_per_sec_per_chip"] = \
                        timer.pairs_per_sec_per_chip
                    if timer.mfu is not None:
                        host_metrics["mfu"] = timer.mfu
                logger.push(host_metrics)
                if i_batch % 20 == 0:
                    np.set_printoptions(suppress=True, linewidth=150)
                    print("\n estimated pose")
                    print(poses_est[0].cpu().numpy())
                    print("ground truth pose")
                    print(np.asarray(poses[0]))
                if (i_batch + 10) % 20 == 0:
                    print("\n metrics:",
                          {k: v.item() for k, v in metrics.items()}, "\n")
                if i_batch % 100 == 0:
                    print(f"epoch {epoch_count}\nsubepoch: {subepoch}\n"
                          f"using {train_val} set\n"
                          f"batch {i_batch} of {n_batches}")

            pending_log = None
            for i_batch, (host_batch, batch) in enumerate(
                    device_batches(host_batches, device)):
                poses = host_batch[1]
                if is_training:
                    metrics, poses_est = train_step(
                        step_model, opt, sched, *batch, w_tr=args.w_tr,
                        w_rot=args.w_rot, clip=args.clip, remat=args.remat)
                    train_steps += 1
                else:
                    metrics, poses_est = eval_step(
                        model, *batch, w_tr=args.w_tr, w_rot=args.w_rot,
                        train_val=train_val)

                if pending_log is not None:
                    flush_logging(*pending_log)
                pending_log = (i_batch, metrics, poses_est, poses)
                if is_training:
                    wait, host_batches.wait = host_batches.wait, 0.0
                    if timer.tick() is not None:
                        waited += wait

                done = train_steps >= args.steps
                if main_rank and (done or (
                        is_training and train_steps % args.ckpt_every == 0)):
                    writer.save(checkpoint_path(args.name, train_steps),
                                model, opt, sched)
                if done:
                    should_keep_training = False
                    break

            if pending_log is not None:
                flush_logging(*pending_log)

            subepoch += 1
            if subepoch == 11 or (subepoch == 10 and args.dataset in
                                  ("interiornet", "streetlearn")):
                # no val subepoch for interiornet / streetlearn
                # (train.py:205-208)
                subepoch = 0
                epoch_count += 1

        if timer.timed_steps and main_rank:
            share = waited / timer.total_time
            mfu = "" if timer.mfu is None else f", MFU {100 * timer.mfu:.3f}%"
            print(f"throughput: {timer.pairs_per_sec_per_chip:.2f} pairs/s on "
                  f"{device} over {timer.timed_steps} steps after "
                  f"{timer.warmup}{mfu}; waiting on the data loader "
                  f"{100 * share:.2f}% of that time")
            record = {"pairs_per_sec_per_chip": timer.pairs_per_sec_per_chip,
                      "loader_wait_share": share,
                      "timed_steps": timer.timed_steps}
            if timer.mfu is not None:
                record["mfu"] = timer.mfu
            logger.write_dict(record, step=train_steps)
    log("finished training!")
    if logger is not None:
        logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
