"""Weights for a model built empty.

A model is built without initializing its parameters.  Two ways fill it:

  * ``seeded_state_dict`` makes a state dict at the model's shapes from a
    numpy seed, so the same seed gives the same weights on any host
    (numpy's generator, unlike the framework ones, is the same in both
    packages' tests and on the GPU host);
  * ``torch_default_init`` initializes it in place from PyTorch's global
    generator as a freshly built reference model is (each module's
    ``reset_parameters``), under the training CLI's ``torch.manual_seed(0)``.
"""

import numpy as np
import torch
from torch import nn


def seeded_state_dict(model, seed):
    """A state dict for ``model`` with values drawn in key order from
    ``numpy.random.default_rng(seed)``: Linear / Conv weights and biases
    uniform in +-1/sqrt(fan_in) (PyTorch's default bound), LayerNorm and
    BatchNorm affine near (1, 0), BatchNorm running mean near 0 and
    running variance in [0.5, 1.5), ``pos_embed`` ~ N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)
    out = {}
    for prefix, mod in model.named_modules():
        p = f"{prefix}." if prefix else ""
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            w = mod.weight
            bound = 1.0 / np.sqrt(np.prod(w.shape[1:]))
            out[p + "weight"] = rng.uniform(-bound, bound, w.shape)
            if mod.bias is not None:
                out[p + "bias"] = rng.uniform(-bound, bound, mod.bias.shape)
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d)):
            n = mod.weight.shape[0]
            out[p + "weight"] = 1.0 + 0.1 * rng.standard_normal(n)
            out[p + "bias"] = 0.1 * rng.standard_normal(n)
            if isinstance(mod, nn.BatchNorm2d):
                out[p + "running_mean"] = 0.1 * rng.standard_normal(n)
                out[p + "running_var"] = rng.uniform(0.5, 1.5, n)
                out[p + "num_batches_tracked"] = np.zeros((), np.int64)
        for name, param in mod.named_parameters(recurse=False):
            if p + name not in out:
                out[p + name] = 0.02 * rng.standard_normal(param.shape)
    return {k: torch.from_numpy(np.asarray(
        v, np.int64 if k.endswith("num_batches_tracked") else np.float32))
        for k, v in out.items()}


def torch_default_init(model):
    """PyTorch's default initialization of every Linear, Conv2d, LayerNorm
    and BatchNorm2d (``reset_parameters``: kaiming-uniform weights, uniform
    biases, unit affine, zero running mean and unit running variance), and
    xavier-uniform for the other parameters (``pos_embed``), as the JAX
    package's ``vitess_init`` draws them.  In place, from the global
    generator: call it under ``torch.manual_seed``."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.LayerNorm,
                            nn.BatchNorm2d)):
            mod.reset_parameters()
        else:
            for param in mod.parameters(recurse=False):
                nn.init.xavier_uniform_(param)
    return model
