"""Training checkpoints in the reference's ``.pth`` layout.

Counterpart of ``rel_pose_tpu/train/checkpoint.py`` for PyTorch: a
checkpoint is ``{"model", "optimizer", "scheduler"}`` state dicts
(the reference's ``train.py:189-203``) saved as
``<output_dir>/<name>/checkpoints/%06d.pth``, the number being the steps
taken.  A write goes through a temporary file and ``os.replace``, so a
reader never sees half a file.  On start, :func:`resume` loads the newest
checkpoint (``most_recent_ckpt.pth`` first, else the highest number).
``infer.PosePredictor.from_checkpoint`` reads the same files.

A reference training checkpoint loads too: ``utils.convert.load_pth``
reads it although its scheduler state holds a pickled function, and its
Adam state, whose group also lists the frozen ``resnet.layer3/4`` and
``fc`` that the port does not hold, is remapped by parameter name
(``utils.convert.remap_reference_adam_state``).
"""

import os
import re

import torch

from ..utils.convert import (load_pth, load_reference_state_dict,
                             remap_reference_adam_state)

SUFFIX = ".pth"


def ensure_output_dirs(name, output_dir="output"):
    """Create the reference's output layout (``train.py:255-260``)."""
    for sub in ("checkpoints", "runs", "train_output/images"):
        os.makedirs(os.path.join(output_dir, name, sub), exist_ok=True)


def checkpoint_path(name, step, output_dir="output"):
    return os.path.join(output_dir, name, "checkpoints",
                        f"{step:06d}{SUFFIX}")


def save_checkpoint(path, model, opt, sched):
    """Write the model, optimizer and scheduler state to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": model.state_dict(), "optimizer": opt.state_dict(),
                "scheduler": sched.state_dict()}, tmp)
    os.replace(tmp, path)


def find_resume_checkpoint(name, output_dir="output"):
    """The newest checkpoint in ``<output_dir>/<name>/checkpoints``, or
    None."""
    d = os.path.join(output_dir, name, "checkpoints")
    if not os.path.isdir(d):
        return None
    entries = os.listdir(d)
    if f"most_recent_ckpt{SUFFIX}" in entries:
        return os.path.join(d, f"most_recent_ckpt{SUFFIX}")
    steps = [int(m.group(1)) for f in entries
             if (m := re.fullmatch(r"(\d+)" + re.escape(SUFFIX), f))]
    if not steps:
        return None
    return checkpoint_path(name, max(steps), output_dir)


def load_checkpoint(path, model, opt=None, sched=None):
    """Load ``path`` into the model (and the optimizer and scheduler, when
    given); a reference checkpoint's ``module.`` keys, frozen parameters
    and pickled scheduler function are accepted."""
    ckpt = load_pth(path)
    model.load_state_dict(load_reference_state_dict(ckpt["model"]))
    if opt is not None:
        opt.load_state_dict(remap_reference_adam_state(
            ckpt["optimizer"], ckpt["model"], model, opt))
    if sched is not None:
        sched.load_state_dict(ckpt["scheduler"])
    return ckpt


def resume(name, model, opt, sched, output_dir="output"):
    """Load the newest checkpoint of run ``name`` if there is one; return
    the number of steps already taken (0 for a fresh run)."""
    path = find_resume_checkpoint(name, output_dir)
    if path is None:
        return 0
    load_checkpoint(path, model, opt, sched)
    return sched.last_epoch
