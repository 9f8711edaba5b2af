"""What the port's eval CLIs share (``test_matterport``,
``test_streetlearn_interiornet``): their common flags, the device, the
sharded evaluation, and the host decode pipeline of
``test_matterport.py:183-211``.

One process evaluates each ``--batch`` over every visible GPU when
``--batch`` divides their count (``infer.PosePredictor``'s ``shard``), as
the JAX CLIs do over a host's chips (``test_matterport.py:132-151``).
Under torchrun (``torchrun --nproc_per_node N -m
rel_pose_tpu_torch.cli.test_matterport ...``) each rank evaluates the
strided shard ``items[rank::world]`` on its own device and the per-pair
rows are gathered in rank-major order (``parallel.allgather_ragged``), as
the JAX CLIs do over processes (``test_matterport.py:126-131,240``); rank
0 writes the metrics and the CSVs.  That host gather is the only
collective, so the world is a gloo one and several ranks may share a card
(ranks beyond the visible GPUs wrap around onto them).

The pipeline decodes a chunk of ``--batch`` pairs on a thread pool
(``--decode_workers``, OpenCV releases the GIL) while the card runs the
previous chunk: one chunk of look-ahead.  It times the loop as
``utils.profiling.StepTimer`` times the training CLI's steps, the first
``WARMUP_CHUNKS`` chunks (the kernels' build, cuDNN's plans) left out, and
counts the seconds the loop spends blocked on decode in the timed chunks.
"""

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import infer, parallel
from ..config import add_model_flags
from ..utils.profiling import StepTimer

WARMUP_CHUNKS = 2


def add_eval_flags(parser):
    """The flags both eval CLIs take (``test_matterport.py:77-91``) and
    ``--device``."""
    parser.add_argument("--datapath", required=True)
    parser.add_argument("--weights")
    parser.add_argument("--image_size", default=[384, 512])
    parser.add_argument("--exp", required=True)
    parser.add_argument("--ckpt", required=True,
                        help="a .pth or a .ckpt checkpoint")
    parser.add_argument("--gamma", type=float, default=0.9)
    parser.add_argument("--batch", type=int, default=16,
                        help="inference batch size (results are those of "
                             "batch 1: BatchNorm is in eval mode)")
    parser.add_argument("--decode_workers", type=int, default=0,
                        help="image-decode threads; 0 = min(8, cpu_count). "
                             "Decode of chunk k+1 overlaps the forward of "
                             "chunk k")
    add_device_flag(parser)
    add_model_flags(parser)
    return parser


def add_device_flag(parser):
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (a GPU a process, the default) or cpu")


def resolve_device(name, prog):
    """``--device`` -> a torch device; ``cuda`` without a visible GPU
    refuses with a message (there is no CPU fallback)."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(f"{prog}: --device cuda, but no CUDA device is "
                         "visible; pass --device cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def init_eval_world(device, kernels):
    """Join torchrun's world, if there is one, over gloo: -> this rank's
    device (``device`` outside a world).  Rank 0 builds the kernel library
    first when the model launches ``kernels``."""
    if parallel.launched():
        device = parallel.init_distributed(device.type, backend="gloo")
        if kernels:
            parallel.build_kernels_once(device)
    return device


def load_predictor(path, cfg, device, batch, **kwargs):
    """The CLIs' ``PosePredictor`` at ``--batch``: sharded over every local
    device outside a torchrun world (a rank keeps its one device), saying
    whether it shards as the JAX CLIs do."""
    one_process = parallel.world_size() == 1
    predictor = infer.PosePredictor.from_checkpoint(
        path, cfg, device=device, batch_size=batch, shard=one_process,
        **kwargs)
    n = len(infer.local_devices(device)) if one_process else 1
    if len(predictor.devices) > 1:
        print(f"eval sharded over {len(predictor.devices)} local devices")
    elif n > 1:
        print(f"NOTE: --batch {batch} is not divisible by the {n} local "
              f"devices; falling back to single-device eval (use --batch a "
              f"multiple of {n} for sharded eval)")
    return predictor


def shard(items):
    """This rank's strided shard ``items[rank::world]``."""
    world, rank = parallel.world_size(), parallel.rank()
    if world == 1:
        return items
    print(f"rank {rank}/{world}: evaluating {len(items[rank::world])} of "
          f"{len(items)} pairs")
    return items[rank::world]


def gather_predictions(predictions):
    """Every rank's per-pair rows in rank-major order, identical on every
    rank (``test_matterport.py:68-80``; float32, as there); unchanged
    outside a world."""
    if parallel.world_size() == 1:
        return predictions
    cam = predictions["camera"]
    g = parallel.allgather_ragged({
        "pt": (cam["preds"]["tran"], 3), "pr": (cam["preds"]["rot"], 4),
        "gt": (cam["gts"]["tran"], 3), "gr": (cam["gts"]["rot"], 4)})
    return {"camera": {
        "preds": {"tran": list(g["pt"]), "rot": list(g["pr"])},
        "gts": {"tran": list(g["gt"]), "rot": list(g["gr"])}}}


class DecodePipeline:
    """Iterate ``(chunk, images)`` over ``items`` in chunks of ``batch``:
    ``images`` is the chunk's ``(n, 2, 3, H, W)`` uint8 stack of
    ``load_pair`` results, decoded one chunk ahead.  Call :meth:`tick`
    after each chunk's forward has finished."""

    def __init__(self, items, load_pair, batch, workers=0):
        self.items, self.load_pair, self.batch = items, load_pair, batch
        self.workers = workers or min(8, os.cpu_count() or 1)
        self.timer = StepTimer(pairs_per_step=batch, warmup=WARMUP_CHUNKS)
        self.waited = 0.0       # blocked on decode inside the timed chunks
        self._wait = 0.0

    def _chunk(self, pool, start):
        chunk = self.items[start:start + self.batch]
        return chunk, np.stack(list(pool.map(self.load_pair, chunk)))

    def __iter__(self):
        try:  # one cv2 parallel region per decode thread oversubscribes
            import cv2
            # one worker: a negative count restores cv2's own pool (0
            # would turn its internal threads off)
            cv2.setNumThreads(max(1, (os.cpu_count() or 1) // self.workers)
                              if self.workers > 1 else -1)
        except ImportError:
            pass
        starts = list(range(0, len(self.items), self.batch))
        with ThreadPoolExecutor(max_workers=self.workers) as pool, \
                ThreadPoolExecutor(max_workers=1) as ahead:
            pending = ahead.submit(self._chunk, pool, starts[0]) \
                if starts else None
            for n in range(len(starts)):
                t0 = time.perf_counter()
                chunk, images = pending.result()
                self._wait = time.perf_counter() - t0
                if n + 1 < len(starts):
                    pending = ahead.submit(self._chunk, pool, starts[n + 1])
                yield chunk, images

    def tick(self):
        if self.timer.tick() is not None:
            self.waited += self._wait

    def report(self, device):
        """The steady-state line, or why there is none."""
        t = self.timer
        if not t.timed_steps:
            return (f"throughput: not timed ({t.count} chunks, the first "
                    f"{t.warmup} are warm-up)")
        return (f"throughput: {t.pairs_per_sec_per_chip:.2f} pairs/s on "
                f"{device} over {t.timed_steps} chunks of {self.batch} after "
                f"{t.warmup}; waiting on decode "
                f"{100 * self.waited / t.total_time:.2f}% of that time")


def write_results(metrics, folder):
    """Print the metrics and write them to ``<folder>/results.txt``."""
    for k in metrics:
        print(k, metrics[k])
    with open(os.path.join(folder, "results.txt"), "w") as f:
        for k in metrics:
            print(k, metrics[k], file=f)
