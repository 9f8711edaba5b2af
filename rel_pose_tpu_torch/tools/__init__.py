"""Command-line tools of the port, run as ``python -m
rel_pose_tpu_torch.tools.<name>``: ``check_grads`` (gradient
triangulation), ``mfu_report`` (whole-step MFU and the kernels' floors),
``convergence_run`` (the overfit protocol through the training CLI), and
the measuring tools ``bench_stages`` (the eval forward's time by stage),
``bench_stages_bwd`` (the training forward and backward by stage),
``bench_train`` (train-step ms and pairs/s), ``bench_infer_latency``
(``PosePredictor`` request latency, and with ``--trace`` a batch call's
split on the card's timeline) and ``bench_loader`` (the host data
pipeline's pairs/s).  Each measuring tool runs on the card unless given
``--device cpu``, and prints one JSON line per reading with the card's
name and power limit."""

import os
import pathlib
import subprocess
import time

import torch

REPO = pathlib.Path(__file__).resolve().parents[2]


def child_env(**extra):
    """This process's environment with the repository first on
    ``PYTHONPATH``, plus ``extra``, for ``python -m`` child processes."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        **extra)


def card_line():
    """nvidia-smi's name and power limit, or why there is none."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip() or "nvidia-smi printed nothing"
    except OSError:
        return "no nvidia-smi"


class Clock:
    """Marks on ``device``'s timeline: CUDA events recorded on the current
    stream of a GPU, the host clock on the CPU (where an op has finished
    when it returns).  ``ms(a, b)`` is valid after :meth:`sync`."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()
