"""Masked batch normalization, eval branch.

The port of the JAX package's ``models/norm.py::MaskedBatchNorm`` with
``use_running_average=True``: the running statistics normalise every row,
``(x - mean) * rsqrt(var + eps) * scale + bias`` with eps 1e-4. Training
(masked batch moments, SyncBN) belongs to a later slice.
"""
from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-4):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * (inv * self.weight) + self.bias
