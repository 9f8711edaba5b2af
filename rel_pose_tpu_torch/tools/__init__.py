"""Command-line tools of the port, run as ``python -m
rel_pose_tpu_torch.tools.<name>``: ``check_grads`` (gradient
triangulation), ``mfu_report`` (whole-step MFU and the kernels' floors),
``convergence_run`` (the overfit protocol through the training CLI)."""

import os
import pathlib

REPO = pathlib.Path(__file__).resolve().parents[2]


def child_env(**extra):
    """This process's environment with the repository first on
    ``PYTHONPATH``, plus ``extra``, for ``python -m`` child processes."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        **extra)
