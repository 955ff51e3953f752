"""Optimizer and learning-rate schedule, the port of the JAX package's
``train/optim.py``: gradient clipping by global norm 10, then AdamW (lr 2e-4,
weight decay 0.05 on every parameter, betas (0.9, 0.999), eps 1e-8) with a
polynomial decay of power 0.9 over the whole schedule.

The semantics are optax's, where they differ from PyTorch's helpers:
  * clipping scales the gradients by max_norm / |g| only when |g| >= max_norm
    (``clip_grad_norm_`` adds 1e-6 to the norm and always scales);
  * step t (from 0) uses the schedule's value at t, so the first step takes
    the base learning rate; a restored ``state_dict`` carries t on.
"""
from __future__ import annotations

from typing import Iterable

import torch


def poly_schedule(base_lr: float, total_steps: int, power: float = 0.9):
    def fn(step: int) -> float:
        frac = 1.0 - (step / max(total_steps, 1))
        return base_lr * (frac**power)

    return fn


class ClippedAdamW:
    """Global-norm clipping + AdamW with a per-step learning rate."""

    def __init__(self, params: Iterable[torch.nn.Parameter], base_lr: float,
                 weight_decay: float, total_steps: int, power: float,
                 clip_norm: float):
        self.params = list(params)
        self.clip_norm = clip_norm
        self.schedule = poly_schedule(base_lr, total_steps, power)
        self.adamw = torch.optim.AdamW(
            self.params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )
        self.count = 0

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip the parameters' .grad in place, take one AdamW step, and
        return the global gradient norm before clipping (a device scalar;
        nothing is read back to the host)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
        torch._foreach_mul_(grads, scale)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        """The step count (the schedule's position, as optax's restored
        ``opt_state`` count) and the AdamW moments and per-parameter steps."""
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        """Restores ``state_dict()``'s output: the next step uses the
        schedule's value at the restored count. The moments land on the
        parameters' device (``torch.optim.Optimizer.load_state_dict``)."""
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_optimizer(
    params: Iterable[torch.nn.Parameter],
    base_lr: float = 2e-4,
    weight_decay: float = 0.05,
    total_steps: int = 100_000,
    power: float = 0.9,
    clip_norm: float = 10.0,
) -> ClippedAdamW:
    return ClippedAdamW(params, base_lr, weight_decay, total_steps, power,
                        clip_norm)
