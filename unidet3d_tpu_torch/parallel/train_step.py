"""The training step, the port of the JAX package's
``parallel/train_step.py::make_train_step``: forward in train mode,
``detection_loss``, backward (through the conv and attention backward
kernels), global-norm clipping and AdamW.

Under a process group of more than one rank (``parallel/distributed.py``)
each rank runs the step on its own scenes of the global batch: the batch
norms and the criterion sum their statistics over the group inside the
forward and backward, and between the backward and the optimizer the
gradients are averaged over the group and the loss is taken to the group's
mean, as the JAX step's ``pmean``s do. The collectives of one step, in the
order every rank issues them (at the production widths): 45 batch-norm
forwards, the criterion's count, 45 batch-norm backwards, the gradient
buffer, the loss.
"""
from __future__ import annotations

import torch

from ..core.config import ModelConfig
from ..models.detector import GTBatch, PointBatch, detection_loss
from ..ops.gridpack import GridPack
from ..train.optim import ClippedAdamW
from ..train.profiling import span
from .distributed import average_gradients, mean_over_group


def make_train_step(model: torch.nn.Module, cfg: ModelConfig,
                    optimizer: ClippedAdamW):
    """Returns step(batch, gt, pack, generator) -> {"loss", "grad_norm"}.

    `batch`, `gt` and `pack` are on the model's device (``to_device``,
    ``gt_to_device``); `generator` draws the query selection (or a given
    (B, S) `query_noise` replaces the draw); `host_dataset_ids`, the
    collated batch's numpy dataset ids, tell the criterion its rotated
    scenes without a read from the card (``detection_loss``). The model's
    parameters, running statistics and the optimizer state are updated in
    place. Both metrics are device scalars, the group's mean loss and the
    norm of the averaged gradient, taken before clipping.

    The step is a span ("step", keyed by the optimizer's count) whose four
    children cover it: "step.forward", "step.loss", "step.backward" (with
    the group's gradient and loss means) and "step.optimizer"."""

    def step(batch: PointBatch, gt: GTBatch, pack: GridPack,
             generator: torch.Generator | None = None,
             query_noise: torch.Tensor | None = None,
             host_dataset_ids=None) -> dict:
        with span("step", optimizer.count):
            with span("step.forward"):
                out, aux = model(batch, pack, train=True, generator=generator,
                                 query_noise=query_noise)
            with span("step.loss"):
                loss = detection_loss(cfg, out, aux, batch, gt, host_dataset_ids)
            with span("step.backward"):
                optimizer.zero_grad()
                loss.backward()
                average_gradients(optimizer.params)
                loss = mean_over_group(loss.detach())
            with span("step.optimizer"):
                grad_norm = optimizer.step()
        return {"loss": loss, "grad_norm": grad_norm}

    return step
