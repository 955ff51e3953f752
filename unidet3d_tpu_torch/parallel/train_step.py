"""The training step on one card, the port of the JAX package's
``parallel/train_step.py::make_train_step`` without the mesh: forward in
train mode, ``detection_loss``, backward (through the conv and attention
backward kernels), global-norm clipping and AdamW. Data parallelism with
masked SyncBN belongs to a later slice.
"""
from __future__ import annotations

import torch

from ..core.config import ModelConfig
from ..models.detector import GTBatch, PointBatch, detection_loss
from ..ops.gridpack import GridPack
from ..train.optim import ClippedAdamW


def make_train_step(model: torch.nn.Module, cfg: ModelConfig,
                    optimizer: ClippedAdamW):
    """Returns step(batch, gt, pack, generator) -> {"loss", "grad_norm"}.

    `batch`, `gt` and `pack` are on the model's device (``to_device``,
    ``gt_to_device``); `generator` draws the query selection (or a given
    (B, S) `query_noise` replaces the draw). The model's
    parameters, running statistics and the optimizer state are updated in
    place. Both metrics are device scalars; grad_norm is taken before
    clipping."""

    def step(batch: PointBatch, gt: GTBatch, pack: GridPack,
             generator: torch.Generator | None = None,
             query_noise: torch.Tensor | None = None) -> dict:
        out, aux = model(batch, pack, train=True, generator=generator,
                         query_noise=query_noise)
        loss = detection_loss(cfg, out, aux, batch, gt)
        optimizer.zero_grad()
        loss.backward()
        grad_norm = optimizer.step()
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return step
