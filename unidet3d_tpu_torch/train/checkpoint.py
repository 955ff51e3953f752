"""Checkpoints: periodic training checkpoints with keep-last-k, resume, and
prefix-restricted initialisation from a converted reference checkpoint.

The port of the JAX package's ``train/checkpoint.py`` (orbax) over
``torch.save``:
  * ``CheckpointManager`` writes one file per step, ``<step>.pth`` holding
    ``{"step", "model": state_dict, "optimizer": ClippedAdamW.state_dict()}``,
    through a temporary name and ``os.replace``, so that a cut run never
    leaves a half file for ``--resume auto`` (orbax commits atomically too);
    it keeps the newest ``max_to_keep`` steps, as orbax's
    ``CheckpointManagerOptions(max_to_keep=...)`` does; in data-parallel
    training rank 0 writes and every rank restores the same file;
  * ``save_params`` / ``restore_params`` handle a plain state dict (the
    converter's output, ``load_from``'s input);
  * ``merge_by_prefix`` works over flat state-dict names and takes every
    donor tensor under the prefix, parameters and running statistics alike.
    Unlike the JAX version, which finds nothing when given the converter's
    whole ``{"params", "batch_stats"}`` tree and returns the parameters
    unchanged, it raises when the donor holds no name under the prefix.
"""
from __future__ import annotations

import logging
import os
import re

import torch

from ..parallel.distributed import barrier, is_primary

log = logging.getLogger("unidet3d_tpu_torch")

_STEP_FILE = re.compile(r"^(\d+)\.pth$")


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _atomic_save(obj, path: str) -> None:
    """torch.save to a temporary name beside `path`, then os.replace."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load(path: str, map_location):
    return torch.load(path, map_location=map_location, weights_only=True)


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


class CheckpointManager:
    """Training checkpoints under `directory`, one ``<step>.pth`` each; the
    directory is made on the first save."""

    def __init__(self, directory: str, max_to_keep: int = 16):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep {max_to_keep} < 1")
        self.directory = _abs(directory)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pth")

    def all_steps(self) -> list:
        """The steps with a complete checkpoint, ascending (temporary files
        of a save in progress or cut are not steps)."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: torch.nn.Module, optimizer) -> str:
        """Writes step `step`'s checkpoint (replacing one of the same step),
        then removes all but the newest max_to_keep; returns its path.

        Under a process group only rank 0 writes and prunes (every rank holds
        the same state), then every rank waits at a barrier, so that the
        file is complete wherever the call returns (a shared file system is
        assumed, as by the JAX loop and the reference's rank-0 torch.save)."""
        path = self.path(step)
        if is_primary():
            os.makedirs(self.directory, exist_ok=True)
            _atomic_save({"step": int(step), "model": model.state_dict(),
                          "optimizer": optimizer.state_dict()}, path)
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        barrier()
        return path

    def restore(self, model: torch.nn.Module, optimizer=None, step: int | None = None):
        """Loads step `step` (the latest when None) into `model` (strict) and
        `optimizer` (when given), on the model's device. Returns the step, or
        None when `step` is None and the directory holds no checkpoint; a
        named step that is missing raises."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        path = self.path(step)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint of step {step} in {self.directory} "
                                    f"(steps: {self.all_steps()})")
        ckpt = _load(path, _device_of(model))
        model.load_state_dict(ckpt["model"], strict=True)
        if optimizer is not None:
            optimizer.load_state_dict(ckpt["optimizer"])
        return int(ckpt["step"])

    def close(self) -> None:
        """Nothing is held open between calls (orbax's manager has threads
        to stop); kept so that the loop's lifetime reads as the JAX one's."""


def save_params(path: str, state_dict: dict) -> None:
    """A plain state dict (tensors moved to the CPU) to `path`, atomically."""
    path = _abs(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _atomic_save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def restore_params(path: str) -> dict:
    """The state dict that ``save_params`` wrote, on the CPU."""
    return _load(_abs(path), "cpu")


def merge_by_prefix(state_dict: dict, donor: dict, prefix: str) -> dict:
    """`state_dict` with every donor tensor named under `prefix` (``prefix.``
    ...; "" takes every name) put in its place: parameters and running
    statistics alike (mmengine's ``load_from`` takes both). Names the donor
    lacks keep their value. Raises when the donor has no name under the
    prefix, when a donor name under it is not in `state_dict`, or on a
    shape mismatch."""
    def under(name: str) -> bool:
        return prefix == "" or name.startswith(prefix + ".")

    taken = [k for k in donor if under(k)]
    if not taken:
        raise ValueError(
            f"the donor has no tensor under {prefix!r} (its names start with "
            f"{sorted({k.split('.')[0] for k in donor})}); nothing would be loaded")
    unknown = [k for k in taken if k not in state_dict]
    if unknown:
        raise KeyError(f"donor tensors under {prefix!r} that the model does not have: "
                       f"{unknown[:8]}{' ...' if len(unknown) > 8 else ''}")
    bad = [(k, tuple(donor[k].shape), tuple(state_dict[k].shape)) for k in taken
           if donor[k].shape != state_dict[k].shape]
    if bad:
        raise ValueError(f"shape mismatch (name, donor, model): {bad[:8]}")
    merged = dict(state_dict)
    for k in taken:
        merged[k] = donor[k].to(dtype=state_dict[k].dtype, device=state_dict[k].device)
    n_under = sum(under(k) for k in state_dict)
    log.info("merge_by_prefix: took %d of the model's %d tensors under %r from the donor",
             len(taken), n_under, prefix)
    return merged
