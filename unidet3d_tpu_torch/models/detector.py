"""UniDet3D detector, eval forward: voxel mean -> sparse U-Net -> superpoint
pooling -> transformer decoder.

The port of the JAX package's ``models/detector.py::UniDet3DTPU.__call__``,
eval branch, on host-built rulebooks: every superpoint slot is a query
(Q = S), superpoint centers are taken from the RAW points so that
predictions land in the input frame. Padding is handled with one-past-the-end
sentinel ids that the segment reductions drop.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..core.class_table import ClassTable
from ..core.config import ModelConfig
from ..device import resolve_device
from ..ops.gridpack import GridPack
from ..ops.segment import segment_mean, segment_sum
from ..ops.sparse_conv import gather_rows
from .decoder import DecoderOutput, UniDecoder
from .unet import UNetBackbone

BIG = 1e9
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PointBatch(NamedTuple):
    """Padded input batch.

    points: (B, P, 3) raw xyz.
    vox_src: (B, P, 3) coordinates in voxel units (points / voxel_size).
    features: (B, P, 6) [colors, xyz - mean(xyz)].
    valid: (B, P) bool.
    sp_ids: (B, P) int32 superpoint id in [0, S), compacted per scene.
    dataset_ids: (B,) int32 index into cfg.datasets.
    """

    points: object
    vox_src: object
    features: object
    valid: object
    sp_ids: object
    dataset_ids: object


class ForwardAux(NamedTuple):
    sp_centers: torch.Tensor  # (B, S, 3) raw frame
    sp_valid: torch.Tensor  # (B, S)
    query_sp: torch.Tensor  # (B, Q) superpoint slot of each query
    query_valid: torch.Tensor  # (B, Q)
    shift: torch.Tensor  # (B, 1, 3) scene min-shift in metres
    geom_points: torch.Tensor  # (B, P, 3) points in the geometry frame


class UniDet3D(nn.Module):
    """Backbone + decoder; ``forward`` returns (DecoderOutput, ForwardAux).

    Parameters live on `device` ("cuda" unless the caller asks for "cpu");
    the weights are zeros until ``weights.seeded_init_`` or
    ``load_state_dict(weights.from_flax(...))`` fills them."""

    def __init__(self, cfg: ModelConfig, table: ClassTable, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dtype = DTYPES[cfg.compute_dtype]
        self.backbone = UNetBackbone(cfg.in_channels, cfg.num_planes, dtype)
        self.decoder = UniDecoder(
            in_channels=cfg.num_planes[0],
            num_layers=cfg.num_layers,
            d_model=cfg.d_model,
            num_heads=cfg.num_heads,
            hidden_dim=cfg.hidden_dim,
            activation=cfg.activation,
            cls_gather=table.gather,
            angles=cfg.angles,
            dtype=dtype,
        )
        self.to(device)
        self.eval()

    @torch.no_grad()
    def forward(self, batch: PointBatch, pack: GridPack):
        cfg = self.cfg
        b, p, _ = batch.points.shape
        s = cfg.max_superpoints

        # Scene min-shift (the training geometry frame; eval reports it).
        vs = torch.where(batch.valid[..., None], batch.vox_src, BIG)
        pmin = vs.amin(dim=1, keepdim=True)
        pmin = torch.where(pmin >= BIG, 0.0, pmin)

        flat_valid = batch.valid.reshape(-1)
        v0 = pack.capacity(0)
        # Voxel features: per-voxel mean of the point features.
        pinv = torch.where(flat_valid, pack.point_inverse, v0)
        vox_feats = segment_mean(batch.features.reshape(b * p, -1), pinv, v0)

        feats = self.backbone(vox_feats, pack)

        # Voxel -> point -> superpoint pooling.
        point_feats = gather_rows(feats, pinv)
        scene = torch.arange(b, device=pinv.device)[:, None] * s
        sp_flat = (scene + batch.sp_ids.long().clamp(0, s - 1)).reshape(-1)
        sp_flat = torch.where(flat_valid, sp_flat, b * s)  # sentinel dropped
        sp_feats = segment_mean(point_feats, sp_flat, b * s).reshape(b, s, -1)
        sp_counts = segment_sum(flat_valid.float(), sp_flat, b * s).reshape(b, s)
        sp_valid = sp_counts > 0
        sp_centers = segment_mean(
            batch.points.reshape(b * p, 3), sp_flat, b * s
        ).reshape(b, s, 3)

        # Eval: every superpoint slot is a query.
        query_sp = torch.arange(s, device=pinv.device).expand(b, s)
        out: DecoderOutput = self.decoder(
            sp_feats, sp_valid, sp_centers, batch.dataset_ids
        )
        aux = ForwardAux(
            sp_centers=sp_centers,
            sp_valid=sp_valid,
            query_sp=query_sp,
            query_valid=sp_valid,
            shift=pmin * cfg.voxel_size,
            geom_points=batch.points,
        )
        return out, aux
