"""Data-parallel training over ``torch.distributed``.

The port of the JAX package's ``parallel/distributed.py`` and of the
collectives of its ``shard_map`` train step. One process per card, launched
the usual way:

    torchrun --nproc_per_node N -m unidet3d_tpu_torch.tools.train <config.py>

Every rank holds the whole model and trains on its own B / N scenes of the
global batch B. The collectives do what the JAX package's ``psum`` /
``pmean`` do, and nothing more:

  * masked SyncBN: each batch norm's (count, sum, sum of squares) summed
    over the group in training (``models/norm.py``), forward and backward;
  * the criterion's count of scenes with matched pairs, per decoder output
    set, summed over the group (``losses/criterion.py``);
  * the gradient mean and the loss mean after the backward
    (``parallel/train_step.py``).

So N processes of B / N scenes give the one-process step's loss, gradients
and running statistics (up to the order of floating-point sums). There is
no ``DistributedDataParallel``: with the decoder's unused heads it would
need ``find_unused_parameters`` and reduce other gradients than ``pmean``
does. The JAX ``local_to_global`` / ``replicate_global`` have no counterpart:
each rank holds its own slice, and ``broadcast_module`` replicates the
weights from rank 0. Each rank drives one card, so a loader never splits
its batch into shards.

Without a process group (or in a group of one) every function here is the
identity or a no-op, so the one-process path issues no collective.
"""
from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("unidet3d_tpu_torch")


def rank_world() -> tuple:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world_size() -> int:
    return rank_world()[1]


def is_primary() -> bool:
    return rank_world()[0] == 0


def local_batch_size(global_batch_size: int) -> int:
    """This rank's share of the global batch."""
    n = world_size()
    if global_batch_size % n:
        raise ValueError(
            f"global batch size {global_batch_size} must divide over {n} processes")
    return global_batch_size // n


def choose_backend(local_world_size: int, n_cards: int) -> str:
    """"nccl" when every local rank has a card of its own, else "gloo" (the
    CPU, or more local ranks than visible cards: NCCL refuses two ranks on
    one card, and gloo stages CUDA tensors through host memory)."""
    if n_cards > 0 and local_world_size <= n_cards and dist.is_nccl_available():
        return "nccl"
    return "gloo"


def maybe_initialize() -> bool:
    """Joins the process group that torchrun's environment describes
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR /
    MASTER_PORT). Returns True when it created the group (the caller then
    destroys it), False in one process or when a group already exists.

    With a card it first selects card LOCAL_RANK % device_count (the NCCL
    collectives, and ``all_gather_object`` in ``train/metric.py``, use the
    current card). When WORLD_SIZE > 1 and initialisation fails, the error
    propagates: it never goes on in one process."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return False
    if not dist.is_available():
        raise RuntimeError(f"WORLD_SIZE={world} but torch.distributed is not available")
    if "RANK" not in os.environ:
        raise RuntimeError(f"WORLD_SIZE={world} but RANK is not set (launch with torchrun)")
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards:
        torch.cuda.set_device(local_rank % n_cards)
    backend = choose_backend(local_world, n_cards)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    log.info("torch.distributed: rank %d of %d (local rank %d of %d), backend %s, %s", rank,
             world, local_rank, local_world, backend,
             f"card {torch.cuda.current_device()} of {n_cards}" if n_cards else "no card")
    return True


def rank_device(device="cuda") -> torch.device:
    """`device`, with a card index picked for this rank when it names the
    card without one: LOCAL_RANK % device_count (card 0 in one process)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    return device


def destroy(created: bool) -> None:
    """Leaves the process group if `created` (maybe_initialize's result)."""
    if created and dist.is_initialized():
        dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce whose backward is the SUM all-reduce of the cotangent:
    the transpose of ``jax.lax.psum`` under ``shard_map``."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out)
        return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the group, differentiably; x itself without a group."""
    if world_size() == 1:
        return x
    return _AllReduceSum.apply(x)


@torch.no_grad()
def average_gradients(params) -> None:
    """Every parameter's .grad replaced by its mean over the group: one flat
    fp32 buffer, one SUM all-reduce, a division by the world size, written
    back (``jax.lax.pmean(grads)``). A parameter whose .grad is None enters
    as zeros, as JAX's dense gradients do, and leaves with the mean."""
    world = world_size()
    if world == 1:
        return
    params = list(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                      .reshape(-1).float() for p in params])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    for p in params:
        g = flat[offset:offset + p.numel()].view_as(p).to(p.dtype)
        offset += p.numel()
        if p.grad is None:
            p.grad = g.clone()
        else:
            p.grad.copy_(g)


def mean_over_group(x: torch.Tensor) -> torch.Tensor:
    """x (no gradient) averaged over the group (``jax.lax.pmean``)."""
    world = world_size()
    if world == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out)
    return out / world


@torch.no_grad()
def broadcast_module(module: torch.nn.Module) -> None:
    """Every tensor of `module`'s state dict (parameters and running
    statistics) set to rank 0's: once after the weights are initialised,
    loaded or restored, so that every rank starts the same step from the
    same state (the contract of JAX's ``replicate_global``). The state
    dict's tensors share storage with the module's."""
    if world_size() == 1:
        return
    for t in module.state_dict().values():
        dist.broadcast(t, src=0)


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()
