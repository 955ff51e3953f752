"""Masked batch normalization for padded sparse features.

The port of the JAX package's ``models/norm.py::MaskedBatchNorm``, eps 1e-4,
momentum 0.1 (torch convention: new = (1 - m) * old + m * batch):

  * eval (``train=False``): the running statistics normalise every row,
    ``(x - mean) * rsqrt(var + eps) * scale + bias``;
  * train: the moments are taken over the rows that `mask` marks valid only
    (count clamped to >= 1, biased variance clamped to >= 0), they normalise
    the batch, and the running statistics move towards them, the variance
    with the unbiased factor cnt / max(cnt - 1, 1).

Synchronising the moments across cards (SyncBN) belongs to a later slice.
"""
from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-4, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor | None = None,
        train: bool = False,
    ) -> torch.Tensor:
        """x (N, C); mask (N,) bool, needed when `train`."""
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            m = mask.to(x.dtype)[:, None]
            cnt = m.sum().clamp(min=1.0)
            mean = (x * m).sum(0) / cnt
            var = ((x * x * m).sum(0) / cnt - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                mo = self.momentum
                self.running_mean.copy_((1 - mo) * self.running_mean + mo * mean)
                self.running_var.copy_((1 - mo) * self.running_var + mo * unbiased)
        inv = torch.rsqrt(var + self.eps)
        return (x - mean) * (inv * self.weight) + self.bias
