"""Masked (sync) batch normalization for padded sparse features.

The port of the JAX package's ``models/norm.py::MaskedBatchNorm``, eps 1e-4,
momentum 0.1 (torch convention: new = (1 - m) * old + m * batch):

  * eval (``train=False``): the running statistics normalise every row,
    ``(x - mean) * rsqrt(var + eps) * scale + bias``;
  * train: the moments are taken over the rows that `mask` marks valid only
    (count clamped to >= 1, biased variance clamped to >= 0), they normalise
    the batch, and the running statistics move towards them, the variance
    with the unbiased factor cnt / max(cnt - 1, 1).

In training under a process group of more than one rank (data parallelism,
``parallel/distributed.py``) the count, sum and sum of squares are summed
over the group in one differentiable all-reduce of 2C + 1 values before the
moments are taken: the JAX package's ``psum`` over its mesh axis, so every
rank normalises with the global batch's moments and keeps the same running
statistics. A rank with no valid row still joins the all-reduce.
"""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.distributed import all_reduce_sum, world_size


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
            cnt, s, ss = m.sum(), (x * m).sum(0), (x * x * m).sum(0)
            if world_size() > 1:
                c = x.shape[1]
                cnt, s, ss = all_reduce_sum(
                    torch.cat([cnt.reshape(1), s, ss])).split([1, c, c])
                cnt = cnt[0]
            cnt = cnt.clamp(min=1.0)
            mean = s / cnt
            var = (ss / cnt - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                unbiased = var * cnt / (cnt - 1.0).clamp(min=1.0)
                mo = self.momentum
                self.running_mean.copy_((1 - mo) * self.running_mean + mo * mean)
                self.running_var.copy_((1 - mo) * self.running_var + mo * unbiased)
        inv = torch.rsqrt(var + self.eps)
        return (x - mean) * (inv * self.weight) + self.bias
