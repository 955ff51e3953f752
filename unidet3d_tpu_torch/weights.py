"""Weights for the port's detector: conversion of a flax variables tree, and
a seeded random initialisation.

The port's module and parameter names mirror the flax tree, so the
conversion renames paths and fixes layouts:
  * subm conv kernels (27, Cin, Cout), strided/inverse kernels (8, Cin, Cout)
    and the 1x1 ``i_branch`` (Cin, Cout) keep their layout;
  * ``Dense`` kernels (in, out) become ``nn.Linear`` weights (out, in);
  * ``DenseGeneral`` q/k/v kernels (d, h, hd) and biases (h, hd) become
    (h*hd, d) and (h*hd,); the out kernel (h, hd, d) becomes (d, h*hd);
  * norm ``scale``/``bias`` become ``weight``/``bias``; batch statistics
    ``mean``/``var`` become ``running_mean``/``running_var``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

_CONV_MODULES = ("input_conv", "conv1", "conv2")
_QKV = ("query", "key", "value")


def _flatten(tree, prefix=()):
    if hasattr(tree, "items"):  # dict or flax FrozenDict
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree)


def _convert(collection: str, path: tuple, x: np.ndarray):
    *mods, leaf = path
    parent = mods[-1] if mods else ""
    prefix = ".".join(mods)
    if collection == "batch_stats":
        if leaf in ("mean", "var"):
            return f"{prefix}.running_{leaf}", x
    elif leaf == "scale":
        return f"{prefix}.weight", x
    elif leaf == "i_branch" or (
        leaf.startswith("level") and leaf.endswith(("_down_kernel", "_up_kernel"))
    ):
        return f"{prefix}.{leaf}", x
    elif leaf == "kernel":
        if parent in _QKV and x.ndim == 3:
            return f"{prefix}.weight", x.reshape(x.shape[0], -1).T
        if parent == "out" and x.ndim == 3:
            return f"{prefix}.weight", x.reshape(-1, x.shape[-1]).T
        if parent in _CONV_MODULES and x.ndim == 3 and x.shape[0] == 27:
            return f"{prefix}.weight", x
        if x.ndim == 2:
            return f"{prefix}.weight", x.T
    elif leaf == "bias":
        if parent in _QKV:
            return f"{prefix}.bias", x.reshape(-1)
        return f"{prefix}.bias", x
    raise ValueError(
        f"flax leaf {collection}/{'/'.join(path)} {x.shape} has no "
        "counterpart in the port"
    )


def from_flax(variables) -> dict:
    """{"params": ..., "batch_stats": ...} of arrays -> a state_dict for
    ``models.detector.UniDet3D``. Raises on any leaf it does not consume;
    ``load_state_dict`` (strict) raises on any parameter left unfilled."""
    out = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"flax collection {collection!r} is not consumed")
        for path, leaf in _flatten(tree):
            key, value = _convert(collection, path, leaf)
            out[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return out


@torch.no_grad()
def seeded_init_(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from a seeded torch.Generator (on the CPU, then
    copied to the model's device), following the JAX package's initialisers:
    conv kernels Kaiming-uniform over (K*Cin), the 1x1 identity branch
    LeCun-uniform, Linear weights normal with std 1/sqrt(fan_in) and zero
    bias, norms one and zero with running statistics (0, 1)."""
    gen = torch.Generator().manual_seed(seed)

    def uniform(shape, bound):
        return (torch.rand(shape, generator=gen) * 2 - 1) * bound

    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() == 3:  # (K, Cin, Cout) conv kernel
            fan_in = p.shape[0] * p.shape[1]
            val = uniform(p.shape, (6.0 / fan_in) ** 0.5) / 2.0**0.5
        elif leaf == "i_branch":
            val = uniform(p.shape, (3.0 / p.shape[0]) ** 0.5)
        elif p.dim() == 2:  # nn.Linear weight (out, in)
            val = torch.randn(p.shape, generator=gen) / p.shape[1] ** 0.5
        elif leaf == "weight":  # norm scale
            val = torch.ones(p.shape)
        else:  # biases
            val = torch.zeros(p.shape)
        p.copy_(val)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.zero_()
        elif name.endswith("running_var"):
            buf.fill_(1.0)
    return model
