"""Weights into the port's ``ViTEss``.

Counterpart of ``rel_pose_tpu/utils/convert.py``, for every configuration:

  * ``state_dict_from_jax`` turns the JAX package's ``(params, state)``
    pytrees, as numpy arrays, into the port's state dict.  The key names
    are those of the JAX package's ``build_key_maps`` (``:95-164``); Linear
    weights go from (in, out) to (out, in).
  * ``load_reference_state_dict`` prepares a reference ``.pth`` ``model``
    dict: it strips the DDP ``module.`` prefix and drops what the port does
    not hold (``resnet.layer3/4/fc``, never run by the reference forward,
    and the extractor's ``downsample.1`` alias of ``norm3``).
  * ``load_torchvision_resnet18`` reads a local torchvision resnet18
    state dict into the trunk's ``resnet.*`` keys (``--resnet_pretrained``);
  * ``load_pth`` reads a ``.pth`` file, also one whose ``"scheduler"``
    holds a pickled function (the reference's OneCycleLR ``anneal_func``).
  * ``remap_reference_adam_state`` turns the reference's Adam state into
    the port optimizer's, by parameter name (``convert_torch_adam_state``,
    ``rel_pose_tpu/utils/convert.py:308-383``, for the JAX package).
"""

import pickle
import types

import numpy as np
import torch


def _bn(jax_path, key):
    """BatchNorm: affine in params, running statistics in state."""
    return [(("params",) + jax_path + ("scale",), f"{key}.weight", False),
            (("params",) + jax_path + ("bias",), f"{key}.bias", False),
            (("state",) + jax_path + ("mean",), f"{key}.running_mean", False),
            (("state",) + jax_path + ("var",), f"{key}.running_var", False),
            (("state",) + jax_path + ("count",),
             f"{key}.num_batches_tracked", False)]


def _conv(jax_path, key, bias=True):
    out = [(("params",) + jax_path + ("w",), f"{key}.weight", False)]
    if bias:
        out.append((("params",) + jax_path + ("b",), f"{key}.bias", False))
    return out


def _linear(jax_path, key):
    return [(("params",) + jax_path + ("w",), f"{key}.weight", True),
            (("params",) + jax_path + ("b",), f"{key}.bias", False)]


def _ln(jax_path, key):
    return [(("params",) + jax_path + ("scale",), f"{key}.weight", False),
            (("params",) + jax_path + ("bias",), f"{key}.bias", False)]


def _conv_pool(jax_path, key):
    """nn.Sequential(conv, BN, ReLU, conv, BN) heads: ``_conv_pool_maps``
    (``rel_pose_tpu/utils/convert.py:83-92``)."""
    return (_conv(jax_path + ("conv1",), f"{key}.0")
            + _bn(jax_path + ("bn1",), f"{key}.1")
            + _conv(jax_path + ("conv2",), f"{key}.3")
            + _bn(jax_path + ("bn2",), f"{key}.4"))


def _fusion_transformer(cfg):
    ft = "fusion_transformer"
    m = [(("params", "pos_embed"), f"{ft}.pos_embed", False)]
    for i in range(cfg.transformer_depth - 1):
        jp, tk = ("blocks", i), f"{ft}.blocks.{i}"
        m += _ln(jp + ("norm1",), f"{tk}.norm1")
        m += _linear(jp + ("qkv",), f"{tk}.attn.qkv")
        m += _linear(jp + ("proj",), f"{tk}.attn.proj")
        m += _ln(jp + ("norm2",), f"{tk}.norm2")
        m += _linear(jp + ("mlp", "fc1"), f"{tk}.mlp.fc1")
        m += _linear(jp + ("mlp", "fc2"), f"{tk}.mlp.fc2")
    jp, tk = ("cross_block",), f"{ft}.blocks.{cfg.transformer_depth - 1}"
    m += _ln(jp + ("norm1",), f"{tk}.norm1")
    m += _linear(jp + ("cross_attn", "qkv"), f"{tk}.cross_attn.qkv")
    proj = "proj" if cfg.noess else "proj_fundamental"
    m += _linear(jp + ("cross_attn", proj), f"{tk}.cross_attn.{proj}")
    m += _ln(jp + ("norm2",), f"{tk}.norm2")
    m += _linear(jp + ("mlp", "fc1"), f"{tk}.mlp.fc1")
    m += _linear(jp + ("mlp", "fc2"), f"{tk}.mlp.fc2")
    m += _ln(("norm",), f"{ft}.norm")
    return m


def key_map(cfg):
    """[(JAX tree path, port state-dict key, transpose)] for ``cfg``."""
    m = _conv(("resnet", "conv1"), "resnet.conv1", bias=False)
    m += _bn(("resnet", "bn1"), "resnet.bn1")
    for layer in (1, 2):
        for i in (0, 1):
            jp, tk = ("resnet", f"layer{layer}_{i}"), f"resnet.layer{layer}.{i}"
            m += _conv(jp + ("conv1",), f"{tk}.conv1", bias=False)
            m += _bn(jp + ("bn1",), f"{tk}.bn1")
            m += _conv(jp + ("conv2",), f"{tk}.conv2", bias=False)
            m += _bn(jp + ("bn2",), f"{tk}.bn2")
            if layer == 2 and i == 0:
                m += _conv(jp + ("downsample_conv",), f"{tk}.downsample.0",
                           bias=False)
                m += _bn(jp + ("downsample_bn",), f"{tk}.downsample.1")
    ex, ek = ("extractor_final_conv",), "extractor_final_conv"
    m += _conv(ex + ("conv1",), f"{ek}.conv1") + _bn(ex + ("norm1",),
                                                      f"{ek}.norm1")
    m += _conv(ex + ("conv2",), f"{ek}.conv2") + _bn(ex + ("norm2",),
                                                      f"{ek}.norm2")
    m += _conv(ex + ("downsample_conv",), f"{ek}.downsample.0")
    m += _bn(ex + ("norm3",), f"{ek}.norm3")
    if cfg.fusion_transformer:
        m += _fusion_transformer(cfg)
    else:
        m += _conv_pool(("pool_transformer_output",),
                        "pool_transformer_output")
    if cfg.noess:
        m += _conv_pool(("pool_attn",), "pool_attn")
    for j, idx in (("fc1", 0), ("fc2", 2), ("fc3", 4)):
        m += _linear(("pose_regressor", j), f"pose_regressor.{idx}")
    return m


def state_dict_from_jax(params, state, cfg):
    """JAX ``(params, state)`` pytrees of numpy arrays -> port state dict
    (fp32 tensors; BatchNorm counts as int64)."""
    trees = {"params": params, "state": state}
    out = {}
    for path, key, transpose in key_map(cfg):
        node = trees[path[0]]
        for p in path[1:]:
            node = node[p]
        arr = np.asarray(node)
        if transpose:
            arr = arr.T
        dtype = np.int64 if key.endswith("num_batches_tracked") \
            else np.float32
        out[key] = torch.from_numpy(np.array(arr, dtype, order="C"))
    return out


def load_reference_state_dict(sd):
    """Reference ``.pth`` ``model`` state dict -> the port's keys."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith(("resnet.layer3.", "resnet.layer4.", "resnet.fc.",
                         "extractor_final_conv.downsample.1.")):
            continue
        out[k] = v
    return out


_TRUNK_PREFIXES = ("conv1.", "bn1.", "layer1.", "layer2.")


def load_torchvision_resnet18(path):
    """A torchvision ``resnet18`` weights file (a state dict, or one under
    ``"model"`` / ``"state_dict"``, keys with or without ``module.``) ->
    the executed trunk's entries as the port's ``resnet.*`` state-dict
    keys: conv1, bn1, layer1 and layer2 with their BatchNorm buffers
    (``load_torchvision_resnet18``, ``rel_pose_tpu/utils/convert.py:215-254``;
    layer3 / layer4 / fc never run and are left out)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    out = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if k.startswith(_TRUNK_PREFIXES):
            out[f"resnet.{k}"] = v.float() if v.is_floating_point() else v
    return out


# ------------------------------------------------------------ .pth files --

class _Stub:
    """Stands in for a global of a ``.pth`` file that holds neither weights
    nor optimizer state, such as the OneCycleLR ``anneal_func`` that
    PyTorch 1.8 pickled into the scheduler state (and whatever that
    function's pickle brings along)."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


# the globals a tensor, a parameter or a state dict's containers need
_ALLOWED = {
    ("collections", "OrderedDict"), ("collections", "defaultdict"),
    ("torch._utils", "_rebuild_tensor_v2"),
    ("torch._utils", "_rebuild_parameter"),
    ("torch._utils", "_rebuild_parameter_with_state"),
    ("torch._tensor", "_rebuild_from_type_v2"),
    ("torch.nn.parameter", "Parameter"), ("torch", "Tensor"),
    ("torch", "Size"), ("torch", "device"), ("_codecs", "encode"),
}


class _StubUnpickler(pickle.Unpickler):
    """Resolves the globals of :data:`_ALLOWED` and torch's dtypes, and
    replaces any other by :class:`_Stub`: nothing of the file runs."""

    def find_class(self, module, name):
        if (module, name) in _ALLOWED or (
                module == "torch"
                and isinstance(getattr(torch, name, None), torch.dtype)):
            return super().find_class(module, name)
        return _Stub


_stub_pickle = types.ModuleType("rel_pose_tpu_torch_stub_pickle")
_stub_pickle.Unpickler = _StubUnpickler
_stub_pickle.load = pickle.load
_stub_pickle.__name__ = "rel_pose_tpu_torch_stub_pickle"


def _has_stub(obj):
    if isinstance(obj, _Stub):
        return True
    if isinstance(obj, dict):
        return any(_has_stub(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_has_stub(v) for v in obj)
    return False


def load_pth(path):
    """A ``.pth`` checkpoint on the CPU.  Files that hold only tensors and
    containers load with ``weights_only=True``.  A reference training
    checkpoint fails that: its ``"scheduler"`` holds OneCycleLR's pickled
    ``anneal_func``.  It is read again with an unpickler that runs nothing
    and stubs every other global; scheduler entries that held one are
    dropped (the port's own OneCycleLR anneals by ``_anneal_func_type``).
    Raises ``ValueError`` if ``"model"`` or ``"optimizer"`` held one."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        pass
    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_stub_pickle)
    if not isinstance(ckpt, dict) or "model" not in ckpt:
        raise ValueError(f"{path}: neither a state dict nor a checkpoint "
                         "with a 'model' entry")
    for key in ("model", "optimizer"):
        if _has_stub(ckpt.get(key)):
            raise ValueError(f"{path}: {key!r} holds objects other than "
                             "tensors and containers")
    if isinstance(ckpt.get("scheduler"), dict):
        ckpt["scheduler"] = {k: v for k, v in ckpt["scheduler"].items()
                             if not _has_stub(v)}
    return ckpt


# ------------------------------------------------------ the Adam state --

_BUFFER_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked")


def reference_param_names(model_sd):
    """The parameter names of a reference ``model`` state dict, in the
    order of ``model.parameters()`` (the ids of its Adam state), with the
    ``module.`` prefix stripped: buffers and the extractor's
    ``downsample.1`` alias of ``norm3`` (one module registered twice, which
    ``parameters()`` lists once) left out."""
    names = []
    for k in model_sd:
        if k.startswith("module."):
            k = k[len("module."):]
        if not k.endswith(_BUFFER_SUFFIXES) and not k.startswith(
                "extractor_final_conv.downsample.1."):
            names.append(k)
    return names


def remap_reference_adam_state(opt_sd, model_sd, model, opt):
    """The reference's Adam ``state_dict`` -> one that ``opt`` (an
    optimizer over ``model``'s parameters) loads.

    The reference's single group lists every parameter of its model,
    including the frozen ``resnet.layer3/4`` and ``fc`` that the port does
    not hold, so the ids are matched by name: id i of the reference is the
    i-th name of :func:`reference_param_names` ``(model_sd)``.  Each port
    parameter takes its state by name; one without state starts from zero
    moments at the largest step of the file, as the JAX package's single
    Adam count does.  The groups' hyperparameters (lr and the OneCycle
    entries) come from the file."""
    names = reference_param_names(model_sd)
    ids = [pid for g in opt_sd["param_groups"] for pid in g["params"]]
    if len(ids) != len(names):
        raise ValueError(
            f"the optimizer state lists {len(ids)} parameters, the model "
            f"state dict {len(names)}: they are not of one checkpoint")
    if len(opt_sd["param_groups"]) != len(opt.param_groups):
        raise ValueError(
            f"the optimizer state has {len(opt_sd['param_groups'])} groups, "
            f"the optimizer {len(opt.param_groups)}")
    by_name = {names[pos]: opt_sd["state"][pid]
               for pos, pid in enumerate(ids) if pid in opt_sd["state"]}
    step = max((float(s["step"]) for s in by_name.values()), default=0.0)
    param_name = {id(p): n for n, p in model.named_parameters()}
    state, groups = {}, []
    for ref_group, group in zip(opt_sd["param_groups"], opt.param_groups):
        idx = []
        for p in group["params"]:
            s = by_name.get(param_name[id(p)])
            if s is None:
                s = {"step": torch.tensor(step),
                     "exp_avg": torch.zeros_like(p, device="cpu"),
                     "exp_avg_sq": torch.zeros_like(p, device="cpu")}
            idx.append(len(state))
            state[len(state)] = s
        hyper = {k: v for k, v in group.items() if k != "params"}
        hyper.update({k: v for k, v in ref_group.items() if k != "params"})
        groups.append({**hyper, "params": idx})
    return {"state": state, "param_groups": groups}
