"""Weights into the port's ``ViTEss``.

Counterpart of ``rel_pose_tpu/utils/convert.py``, for the flagship and
--noess configurations:

  * ``state_dict_from_jax`` turns the JAX package's ``(params, state)``
    pytrees, as numpy arrays, into the port's state dict.  The key names
    are those of the JAX package's ``build_key_maps`` (``:95-164``); Linear
    weights go from (in, out) to (out, in).
  * ``load_reference_state_dict`` prepares a reference ``.pth`` ``model``
    dict: it strips the DDP ``module.`` prefix and drops what the port does
    not hold (``resnet.layer3/4/fc``, never run by the reference forward,
    and the extractor's ``downsample.1`` alias of ``norm3``).
"""

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
    ft = "fusion_transformer"
    m.append((("params", "pos_embed"), f"{ft}.pos_embed", False))
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
    if cfg.noess:   # nn.Sequential(conv, BN, ReLU, conv, BN)
        jp = ("pool_attn",)
        m += _conv(jp + ("conv1",), "pool_attn.0") + _bn(jp + ("bn1",),
                                                         "pool_attn.1")
        m += _conv(jp + ("conv2",), "pool_attn.3") + _bn(jp + ("bn2",),
                                                         "pool_attn.4")
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
