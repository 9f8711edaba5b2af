"""Training checkpoints in the reference's ``.pth`` layout.

Counterpart of ``rel_pose_tpu/train/checkpoint.py`` for PyTorch: a
checkpoint is ``{"model", "optimizer", "scheduler"}`` state dicts
(the reference's ``train.py:189-203``) saved as
``<output_dir>/<name>/checkpoints/%06d.pth``, the number being the steps
taken.  A write goes through a temporary file and ``os.replace``, so a
reader never sees half a file.  On start, :func:`resume` loads the newest
checkpoint (``most_recent_ckpt.pth`` first, else the highest number).
:class:`AsyncCheckpointer` (``rel_pose_tpu/train/checkpoint.py:45-90``)
writes the same file on a worker thread while training goes on; both take
a host copy of every tensor first (:func:`host_state`), so the files hold
CPU tensors wherever the model lives.
``infer.PosePredictor.from_checkpoint`` reads the same files.  A model
under ``DistributedDataParallel`` is saved and loaded as the module it
wraps, so the keys carry no ``module.`` prefix and the files are those of
one process.

A reference training checkpoint loads too: ``utils.convert.load_pth``
reads it although its scheduler state holds a pickled function, and its
Adam state, whose group also lists the frozen ``resnet.layer3/4`` and
``fc`` that the port does not hold, is remapped by parameter name
(``utils.convert.remap_reference_adam_state``).

The JAX package's msgpack ``.ckpt`` files (``rel_pose_tpu/train/
checkpoint.py``) are read and written through ``utils.msgpack`` and
``utils.convert.key_map``: :func:`load_ckpt_state_dict` takes the weights
(the counterpart of its ``load_params_only``), :func:`load_ckpt_train_state`
a full train state ``{params, bn_state, opt_state, step}`` with its Adam
moments, and :func:`save_ckpt` writes ``{params, bn_state, opt_state: {},
step}`` as ``convert_checkpoint.py`` does.
"""

import copy
import os
import re
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import parallel
from ..utils import msgpack
from ..utils.convert import (key_map, load_pth, load_reference_state_dict,
                             remap_reference_adam_state, state_dict_from_jax)

SUFFIX = ".pth"


def ensure_output_dirs(name, output_dir="output"):
    """Create the reference's output layout (``train.py:255-260``)."""
    for sub in ("checkpoints", "runs", "train_output/images"):
        os.makedirs(os.path.join(output_dir, name, sub), exist_ok=True)


def checkpoint_path(name, step, output_dir="output"):
    return os.path.join(output_dir, name, "checkpoints",
                        f"{step:06d}{SUFFIX}")


def _host(obj, storages):
    """``obj`` with every tensor copied to host memory, storages shared as
    in ``obj`` (``storages``: device storage -> its copy), and everything
    else deep-copied."""
    if torch.is_tensor(obj):
        storage = obj.untyped_storage()
        key = (obj.device, storage.data_ptr())
        if key not in storages:
            # a device storage's .cpu() is a synchronous copy; a host one's
            # is itself
            storages[key] = (storage.cpu() if obj.device.type != "cpu"
                             else storage.clone())
        return torch.empty((0,), dtype=obj.dtype).set_(
            storages[key], obj.storage_offset(), obj.size(), obj.stride())
    if isinstance(obj, dict):
        out = type(obj)((k, _host(v, storages)) for k, v in obj.items())
        if hasattr(obj, "__dict__"):     # a state dict's _metadata
            out.__dict__.update(copy.deepcopy(obj.__dict__))
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v, storages) for v in obj)
    return copy.deepcopy(obj)


def host_state(model, opt, sched):
    """``{"model", "optimizer", "scheduler"}`` state dicts as host copies
    that the next training step cannot touch: Adam updates the parameters
    and its moments in place, and ``state_dict()`` hands out those live
    tensors.  The device-to-host copies have finished when it returns."""
    return _host({"model": parallel.unwrap(model).state_dict(),
                  "optimizer": opt.state_dict(),
                  "scheduler": sched.state_dict()}, {})


def write_checkpoint(path, state):
    """``torch.save`` ``state`` to a temporary name beside ``path``, then
    rename it into place."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def save_checkpoint(path, model, opt, sched):
    """Write the model, optimizer and scheduler state to ``path``."""
    write_checkpoint(path, host_state(model, opt, sched))


class AsyncCheckpointer:
    """Checkpoint writes on a worker thread, overlapping the next steps.

    ``save()`` takes the host copy on the caller's thread (the only part
    the training loop waits for), then hands it to one worker thread for
    ``torch.save`` and the rename: the file is :func:`save_checkpoint`'s.
    At most one write is in flight: ``save()`` first waits for the previous
    one and re-raises its error, so a crash loses at most the newest
    checkpoint and every file on disk is whole.  Call ``close()`` (or
    ``wait()``) before the process ends."""

    def __init__(self):
        self._ex = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="ckpt-writer")
        self._fut = None

    def save(self, path, model, opt, sched):
        self.wait()
        state = host_state(model, opt, sched)
        self._fut = self._ex.submit(write_checkpoint, path, state)

    def wait(self):
        """Block until the write in flight, if any, has ended; re-raise its
        error."""
        if self._fut is not None:
            fut, self._fut = self._fut, None
            fut.result()

    def close(self):
        try:
            self.wait()
        finally:
            self._ex.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


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
    model = parallel.unwrap(model)
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


# ------------------------------------------------ the JAX package's .ckpt --

def read_ckpt(path):
    """A ``.ckpt`` file -> its tree, flax's digit-keyed maps turned back
    into lists."""
    with open(path, "rb") as f:
        return _as_lists(msgpack.unpackb(f.read()))


def _as_lists(tree):
    if not isinstance(tree, dict):
        return tree
    out = {k: _as_lists(v) for k, v in tree.items()}
    if out and set(out) == {str(i) for i in range(len(out))}:
        return [out[str(i)] for i in range(len(out))]
    return out


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix}
    return set().union(*[_leaf_paths(v, prefix + (k,)) for k, v in items]) \
        if tree else set()


def _numpy(tree):
    """Leaves as numpy; bfloat16 tensors widened to float32."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    if torch.is_tensor(tree):
        return tree.float().numpy()
    return tree


def _mismatch(path, detail):
    return ValueError(
        f"checkpoint {path} does not match the model configuration -- "
        "check the architecture flags (--transformer_depth, "
        f"--fusion_transformer, --noess, ...) used when it was trained: "
        f"{detail}")


def _trees_state_dict(raw, cfg, path):
    """(params, bn_state) of a read ``.ckpt`` -> the port's state dict;
    the file's leaves must be exactly those of ``cfg``'s key map."""
    if not isinstance(raw, dict) or "params" not in raw \
            or "bn_state" not in raw:
        raise ValueError(f"{path}: no params / bn_state entries")
    trees = {"params": raw["params"], "state": raw["bn_state"]}
    want = {p for p, _, _ in key_map(cfg)}
    have = {("params",) + p for p in _leaf_paths(trees["params"])} | \
        {("state",) + p for p in _leaf_paths(trees["state"])}
    if want != have:
        missing, extra = sorted(map(str, want - have)), sorted(
            map(str, have - want))
        raise _mismatch(path, f"missing {missing[:3]} ({len(missing)}), "
                        f"unexpected {extra[:3]} ({len(extra)})")
    return state_dict_from_jax(_numpy(trees["params"]),
                               _numpy(trees["state"]), cfg)


def load_ckpt_state_dict(path, cfg):
    """The weights of a ``.ckpt`` of the model ``cfg`` describes, as the
    port's state dict (``load_params_only``,
    ``rel_pose_tpu/train/checkpoint.py:100-117``): its ``params`` and
    ``bn_state``; anything else in the file is ignored."""
    return _trees_state_dict(read_ckpt(path), cfg, path)


def _adam_state(opt_state):
    """optax's ``scale_by_adam`` state in a chain's state, or None."""
    entries = opt_state if isinstance(opt_state, list) else [opt_state]
    for s in entries:
        if isinstance(s, dict) and {"count", "mu", "nu"} <= set(s):
            return s
    return None


def _advance(sched, step):
    """``sched`` as ``train.optim.make_scheduler(step=step)`` builds it:
    the schedule at ``step`` updates, the groups' lr set to lr(step)."""
    sched.last_epoch = min(step, sched.total_steps)
    with warnings.catch_warnings():
        # get_lr outside step(): the lr of last_epoch is what is asked for
        warnings.simplefilter("ignore", UserWarning)
        lrs = sched.get_lr()
    for group, lr in zip(sched.optimizer.param_groups, lrs):
        group["lr"] = lr
    sched._last_lr = list(lrs)


def load_ckpt_train_state(path, model, opt, sched):
    """Restore a ``.ckpt`` written by the JAX package's ``train.py`` into
    ``model``, ``opt`` (torch Adam over ``model.parameters()``) and
    ``sched``.  A full train state gives the weights; optax
    ``scale_by_adam``'s ``mu`` / ``nu`` (``rel_pose_tpu/train/optim.py:
    85-89``: on disk the chain's state is a map keyed "0"-"3") become each
    parameter's ``exp_avg`` / ``exp_avg_sq`` through ``key_map``, Linear
    weights transposed, and its ``count`` Adam's ``step``; the schedule is
    advanced to the file's ``step``.  Returns that step.  A params-only
    file (``{params, bn_state, step=0}``, as ``convert_checkpoint.py``
    writes) restores the weights, leaves ``opt`` and ``sched`` fresh and
    returns None."""
    raw = read_ckpt(path)
    model = parallel.unwrap(model)
    model.load_state_dict(_trees_state_dict(raw, model.cfg, path))
    adam = _adam_state(raw.get("opt_state"))
    if adam is None:
        return None
    mu, nu = _numpy(adam["mu"]), _numpy(adam["nu"])
    count = float(np.asarray(adam["count"]))
    moments = {}
    for jpath, key, transpose in key_map(model.cfg):
        if jpath[0] != "params":
            continue
        pair = []
        for tree in (mu, nu):
            for p in jpath[1:]:
                tree = tree[p]
            arr = np.asarray(tree, np.float32)
            pair.append(torch.from_numpy(np.ascontiguousarray(
                arr.T if transpose else arr)))
        moments[key] = pair
    names = {id(p): n for n, p in model.named_parameters()}
    state, groups = {}, []
    for group in opt.param_groups:
        idx = []
        for p in group["params"]:
            exp_avg, exp_avg_sq = moments[names[id(p)]]
            idx.append(len(state))
            state[len(state)] = {"step": torch.tensor(count),
                                 "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}
        groups.append({**{k: v for k, v in group.items() if k != "params"},
                       "params": idx})
    opt.load_state_dict({"state": state, "param_groups": groups})
    step = int(np.asarray(raw["step"]))
    _advance(sched, step)
    return step


def save_ckpt(path, model, step=0):
    """Write ``model``'s weights as a ``.ckpt`` the JAX package reads
    (``load_params_only``, or ``train.py --ckpt`` as a warm start):
    ``{params, bn_state, opt_state: {}, step}``, float32 weights and int32
    BatchNorm counts under the JAX tree's names."""
    model = parallel.unwrap(model)
    sd = model.state_dict()
    trees = {"params": {}, "state": {}}
    for jpath, key, transpose in key_map(model.cfg):
        t = sd[key].detach().cpu()
        t = t.T if transpose else t
        dtype = np.int32 if key.endswith("num_batches_tracked") \
            else np.float32
        node = trees[jpath[0]]
        for p in jpath[1:-1]:
            node = node.setdefault(str(p), {})
        node[jpath[-1]] = np.array(t.numpy(), dtype, order="C")
    data = msgpack.packb({"params": trees["params"],
                          "bn_state": trees["state"], "opt_state": {},
                          "step": step})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
