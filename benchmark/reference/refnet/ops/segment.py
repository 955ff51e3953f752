"""Segment reductions with a static segment count.

As in the JAX package's ``ops/segment.py``, ids outside [0, num_segments)
are DROPPED: the detector uses one-past-the-end sentinels for padding.
``index_add_`` raises on such ids, so they are masked out first.
"""
from __future__ import annotations

import torch


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Sum `data` (N, ...) into `num_segments` rows by `segment_ids` (N,)."""
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(keep, segment_ids, 0).long()
    shape = (-1,) + (1,) * (data.dim() - 1)
    vals = torch.where(keep.reshape(shape), data, 0.0)
    out = torch.zeros(
        (num_segments,) + tuple(data.shape[1:]), dtype=data.dtype,
        device=data.device,
    )
    return out.index_add_(0, ids, vals)


def segment_count(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    ones = torch.ones(
        segment_ids.shape[:1], dtype=torch.float32, device=segment_ids.device
    )
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Mean of `data` rows per segment; empty segments yield zeros."""
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_count(segment_ids, num_segments)
    shape = (num_segments,) + (1,) * (data.dim() - 1)
    return total / count.reshape(shape).clamp(min=1.0)
