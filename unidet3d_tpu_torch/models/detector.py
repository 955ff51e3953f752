"""UniDet3D detector: voxel mean -> sparse U-Net -> superpoint pooling ->
transformer decoder, plus the ground-truth preparation and the loss.

The port of the JAX package's ``models/detector.py`` on host-built
rulebooks. Padding is handled with one-past-the-end sentinel ids that the
segment reductions drop. Geometry frames follow the JAX package:

  * eval: every superpoint slot is a query (Q = S), and superpoint centers
    are taken from the RAW points so that predictions land in the input
    frame;
  * train: every scene is shifted so that min(coords) = 0 (GT boxes are
    shifted the same way), and min(query_thr, S) superpoints are drawn at
    random as queries, padded to a multiple of 512 slots (Q = 3072 at the
    production config).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..core.class_table import ClassTable
from ..core.config import ModelConfig
from ..device import resolve_device
from ..losses.criterion import SceneGT, criterion
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


class GTBatch(NamedTuple):
    """Padded ground truth (training only).

    labels: (B, G) int32; boxes: (B, G, 7) gravity-center, RAW frame;
    valid: (B, G) bool.
    sp_masks: (B, G, S) bool host-computed superpoint instance masks
        (ScanNet / S3DIS pipelines); ignored for target_by_distance datasets.
    inst_ids: (B, P) int32 per-point instance id in [-1, G), for the boxes
        of bbox_by_mask datasets.
    """

    labels: object
    boxes: object
    valid: object
    sp_masks: object
    inst_ids: object


class ForwardAux(NamedTuple):
    sp_centers: torch.Tensor  # (B, S, 3) in the geometry frame
    sp_valid: torch.Tensor  # (B, S)
    query_sp: torch.Tensor  # (B, Q) superpoint slot of each query
    query_valid: torch.Tensor  # (B, Q)
    shift: torch.Tensor  # (B, 1, 3) scene min-shift in metres (train frame)
    geom_points: torch.Tensor  # (B, P, 3) points in the geometry frame


class UniDet3D(nn.Module):
    """Backbone + decoder; ``forward`` returns (DecoderOutput, ForwardAux).

    Parameters live on `device` ("cuda" unless the caller asks for "cpu");
    the weights are zeros until ``weights.seeded_init_`` or
    ``load_state_dict(weights.from_flax(...))`` fills them. ``forward``
    records a graph when gradients are enabled: eval callers run it under
    ``torch.no_grad()``."""

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

    def forward(
        self,
        batch: PointBatch,
        pack: GridPack,
        train: bool = False,
        generator: torch.Generator | None = None,
        query_noise: torch.Tensor | None = None,
    ):
        """Args:
            batch, pack: a collated batch and its rulebooks on the device.
            train: the training branch (masked batch moments, train frame,
                random query selection).
            generator: draws the (B, S) query-selection noise in training
                (on its own device, then moved to the model's).
            query_noise: (B, S) noise to use instead of drawing it.
        """
        cfg = self.cfg
        b, p, _ = batch.points.shape
        s = cfg.max_superpoints

        # Scene min-shift: the training geometry frame.
        vs = torch.where(batch.valid[..., None], batch.vox_src, BIG)
        pmin = vs.amin(dim=1, keepdim=True)
        pmin = torch.where(pmin >= BIG, 0.0, pmin)

        flat_valid = batch.valid.reshape(-1)
        v0 = pack.capacity(0)
        # Voxel features: per-voxel mean of the point features.
        pinv = torch.where(flat_valid, pack.point_inverse, v0)
        vox_feats = segment_mean(batch.features.reshape(b * p, -1), pinv, v0)

        feats = self.backbone(vox_feats, pack, train)

        # Voxel -> point -> superpoint pooling.
        point_feats = gather_rows(feats, pinv)
        scene = torch.arange(b, device=pinv.device)[:, None] * s
        sp_flat = (scene + batch.sp_ids.long().clamp(0, s - 1)).reshape(-1)
        sp_flat = torch.where(flat_valid, sp_flat, b * s)  # sentinel dropped
        sp_feats = segment_mean(point_feats, sp_flat, b * s).reshape(b, s, -1)
        sp_counts = segment_sum(flat_valid.float(), sp_flat, b * s).reshape(b, s)
        sp_valid = sp_counts > 0
        geom = (batch.vox_src - pmin) * cfg.voxel_size if train else batch.points
        sp_centers = segment_mean(geom.reshape(b * p, 3), sp_flat, b * s).reshape(b, s, 3)

        if train:
            q_real = min(cfg.query_thr, s)
            q = min(-(-q_real // 512) * 512, s) if q_real >= 512 else q_real
            if query_noise is None:
                if generator is None:
                    raise ValueError("train=True needs a generator or query_noise")
                query_noise = torch.rand(
                    (b, s), generator=generator, device=generator.device
                )
            noise = torch.where(sp_valid, query_noise.to(sp_valid.device), BIG)
            # Valid superpoints first in a random order; a stable sort, as
            # jnp.argsort.
            query_sp = torch.sort(noise, dim=1, stable=True).indices[:, :q]
            n_sp = sp_valid.sum(1)
            query_valid = (
                torch.arange(q, device=n_sp.device)[None, :]
                < n_sp.clamp(max=q_real)[:, None]
            )
            queries = torch.gather(
                sp_feats, 1, query_sp[..., None].expand(-1, -1, sp_feats.shape[-1])
            )
            centers = torch.gather(sp_centers, 1, query_sp[..., None].expand(-1, -1, 3))
        else:  # every superpoint slot is a query
            query_sp = torch.arange(s, device=pinv.device).expand(b, s)
            query_valid, queries, centers = sp_valid, sp_feats, sp_centers
        out: DecoderOutput = self.decoder(
            queries, query_valid, centers, batch.dataset_ids
        )
        aux = ForwardAux(
            sp_centers=sp_centers,
            sp_valid=sp_valid,
            query_sp=query_sp,
            query_valid=query_valid,
            shift=pmin * cfg.voxel_size,
            geom_points=geom,
        )
        return out, aux


def _bboxes_from_masks(geom_points, valid, inst_ids, g_cap: int) -> torch.Tensor:
    """Axis-aligned boxes (B, G, 7) of the points of each instance id.

    geom_points (B, P, 3); valid (B, P); inst_ids (B, P) in [-1, G). A GT
    with no point gets a zero box."""
    b = geom_points.shape[0]
    gid = torch.where((inst_ids >= 0) & valid, inst_ids.long(), g_cap)
    idx = gid[..., None].expand(-1, -1, 3)
    # Empty segments keep the identity, as jax.ops.segment_max / _min.
    pmax = geom_points.new_full((b, g_cap + 1, 3), float("-inf")).scatter_reduce(
        1, idx, torch.where(valid[..., None], geom_points, -BIG), "amax"
    )[:, :g_cap]
    pmin = geom_points.new_full((b, g_cap + 1, 3), float("inf")).scatter_reduce(
        1, idx, torch.where(valid[..., None], geom_points, BIG), "amin"
    )[:, :g_cap]
    boxes = torch.cat(
        [(pmax + pmin) / 2, pmax - pmin, torch.zeros_like(pmax[..., :1])], dim=-1
    )
    empty = pmax[..., 0] < -BIG / 2
    return torch.where(empty[..., None], 0.0, boxes)


def _distance_topk_masks(sp_centers, sp_valid, boxes, gt_valid, topk: int):
    """Distance-based target assignment: (B, G, S) bool, superpoint s goes to
    the nearest box among those whose (topk + 1) nearest superpoints it is
    strictly inside of.

    sp_centers (B, S, 3); sp_valid (B, S); boxes (B, G, 7); gt_valid (B, G)."""
    g_cap = boxes.shape[1]
    d = ((sp_centers[:, :, None, :] - boxes[:, None, :, :3]) ** 2).sum(-1)  # (B, S, G)
    d = torch.where(sp_valid[:, :, None] & gt_valid[:, None, :], d, BIG)
    k = int(topk) + 1
    # Ascending distances per box; a stable sort, as the matcher's.
    top = torch.sort(d.transpose(1, 2), dim=-1, stable=True).values[..., :k]
    n_sp = sp_valid.sum(1)
    kth = (n_sp.clamp(min=1).clamp(max=k) - 1)[:, None, None].expand(-1, g_cap, 1)
    thresh = torch.gather(top, 2, kth)[..., 0]  # (B, G)
    dm = torch.where(d < thresh[:, None, :], d, BIG)
    assigned = dm.amin(dim=2) < BIG
    min_g = dm.argmin(dim=2)  # the first nearest box, as jnp.argmin
    g_ids = torch.arange(g_cap, device=d.device)
    return (assigned[:, None, :] & (min_g[:, None, :] == g_ids[None, :, None])) & (
        gt_valid[..., None]
    )


def prepare_gt(cfg: ModelConfig, batch: PointBatch, gt: GTBatch,
               aux: ForwardAux) -> SceneGT:
    """The criterion's SceneGT: boxes from the instance masks
    (bbox_by_mask) or the raw boxes shifted into the train frame, and
    superpoint masks by distance (target_by_distance) or from the host,
    gathered at the selected queries."""
    ds = batch.dataset_ids.long()
    dev = ds.device
    bbox_by_mask = torch.as_tensor(cfg.bbox_by_mask, device=dev)[ds]
    tbd = torch.as_tensor(cfg.target_by_distance, device=dev)[ds]

    mask_boxes = _bboxes_from_masks(
        aux.geom_points, batch.valid, gt.inst_ids, gt.labels.shape[1]
    )
    shifted = torch.cat([gt.boxes[..., :3] - aux.shift, gt.boxes[..., 3:]], dim=-1)
    boxes = torch.where(bbox_by_mask[:, None, None], mask_boxes, shifted)

    dist_masks = _distance_topk_masks(
        aux.sp_centers, aux.sp_valid, boxes, gt.valid, cfg.train_topk_targets
    )
    sp_masks = torch.where(tbd[:, None, None], dist_masks, gt.sp_masks)
    g_cap = gt.labels.shape[1]
    query_masks = torch.gather(
        sp_masks, 2, aux.query_sp[:, None, :].expand(-1, g_cap, -1)
    )
    return SceneGT(labels=gt.labels, boxes=boxes, valid=gt.valid,
                   query_masks=query_masks)


def detection_loss(cfg: ModelConfig, out: DecoderOutput, aux: ForwardAux,
                   batch: PointBatch, gt: GTBatch) -> torch.Tensor:
    """The training loss: prepare_gt, then the criterion over all decoder
    output sets."""
    scene_gt = prepare_gt(cfg, batch, gt, aux)
    ds = batch.dataset_ids.long()
    dev = ds.device

    def per_scene(values, dtype=None):
        return torch.as_tensor(values, dtype=dtype, device=dev)[ds]

    return criterion(
        out.cls_logits,
        out.boxes,
        aux.query_valid,
        scene_gt,
        per_scene(cfg.angles),
        per_scene(cfg.topk),
        per_scene(cfg.datasets_weights, torch.float32),
        loss_weight=cfg.loss_weight,
        non_object_weight=cfg.non_object_weight,
    )
