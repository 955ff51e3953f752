"""Inference post-processing: top-k selection, class-wise NMS, superpoint
box trimming.

The port of the JAX package's ``models/postprocess.py`` for the
non-rotated datasets. Predictions are fixed-size (topk_insts,) arrays with a
validity mask; the dataset index is a host int per scene group.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.boxes import get_face_distances
from ..core.config import ModelConfig
from ..ops.nms import greedy_nms, pairwise_iou_aa
from ..ops.segment import segment_mean


class SceneDetections(NamedTuple):
    boxes: torch.Tensor  # (K, 7)
    labels: torch.Tensor  # (K,)
    scores: torch.Tensor  # (K,)
    valid: torch.Tensor  # (K,)


def select_topk_instances(
    cls_logits: torch.Tensor,  # (Q, NC+1) padded-gathered logits
    boxes: torch.Tensor,  # (Q, 7)
    query_valid: torch.Tensor,  # (Q,)
    k: int,
):
    """softmax -> drop no_obj -> flat (query, class) top-k."""
    nc = cls_logits.shape[1] - 1
    probs = torch.softmax(cls_logits, dim=-1)[:, :nc]
    probs = torch.where(query_valid[:, None], probs, 0.0)
    flat = probs.reshape(-1)
    scores, idx = torch.topk(flat, min(k, flat.shape[0]))
    return boxes[idx // nc], idx % nc, scores


def trim_boxes_by_superpoints(
    cfg: ModelConfig,
    boxes: torch.Tensor,  # (K, 7)
    keep: torch.Tensor,  # (K,)
    points: torch.Tensor,  # (P, 3)
    point_valid: torch.Tensor,  # (P,)
    sp_ids: torch.Tensor,  # (P,) in [0, S)
    chunk: int = 128,
):
    """Superpoint-vote box trimming, chunked over boxes.

    Returns refitted axis-aligned (K, 7) boxes (yaw zeroed) and the updated
    validity mask (boxes that end with no inside points are dropped)."""
    s = cfg.max_superpoints
    sp_safe = torch.where(point_valid, sp_ids.long().clamp(0, s - 1), s)
    valid_col = point_valid[:, None]
    new_boxes, has = [], []
    for c0 in range(0, boxes.shape[0], chunk):
        bb = boxes[c0:c0 + chunk]
        c = bb.shape[0]
        fd = get_face_distances(points[:, None, :], bb[None, :, :])  # (P, c, 6)
        inside = (fd.amin(dim=-1) > 0) & valid_col
        # (S, c) fraction of each superpoint inside each box.
        sp_inside = segment_mean(inside.float(), sp_safe, s)
        sp_del = torch.cat([sp_inside < cfg.low_sp_thr,
                            inside.new_ones((1, c))])
        sp_add = torch.cat([sp_inside > cfg.up_sp_thr,
                            inside.new_zeros((1, c))])
        inside = (inside & ~sp_del[sp_safe]) | (sp_add[sp_safe] & valid_col)
        pts = points[:, None, :]
        pmax = torch.where(inside[..., None], pts, float("-inf")).amax(dim=0)
        pmin = torch.where(inside[..., None], pts, float("inf")).amin(dim=0)
        h = inside.any(dim=0)
        nb = torch.cat([(pmax + pmin) / 2, pmax - pmin, pmax.new_zeros((c, 1))], -1)
        new_boxes.append(torch.where(h[:, None], nb, 0.0))
        has.append(h)
    return torch.cat(new_boxes), keep & torch.cat(has)


def predict_scene(
    cfg: ModelConfig,
    dataset_idx: int,
    cls_logits: torch.Tensor,  # (Q, NC+1) last decoder layer, one scene
    boxes: torch.Tensor,  # (Q, 7)
    query_valid: torch.Tensor,
    points: torch.Tensor,  # (P, 3) raw
    point_valid: torch.Tensor,
    sp_ids: torch.Tensor,
) -> SceneDetections:
    """Full single-scene post-processing."""
    if cfg.angles[dataset_idx]:
        raise NotImplementedError(
            f"dataset {cfg.datasets[dataset_idx]!r} needs rotated-box NMS "
            "(ops/rotated_iou.py), not ported yet: ROADMAP.md Queue 1, item 7"
        )
    sel_boxes, labels, scores = select_topk_instances(
        cls_logits, boxes, query_valid, cfg.topk_insts
    )
    valid = scores > cfg.score_thr
    keep = greedy_nms(
        pairwise_iou_aa(sel_boxes), scores, labels, valid,
        cfg.iou_thr[dataset_idx],
    )
    out_boxes = sel_boxes.clone()
    out_boxes[:, 6] = 0.0
    if cfg.use_superpoints[dataset_idx]:
        out_boxes, keep = trim_boxes_by_superpoints(
            cfg, out_boxes, keep, points, point_valid, sp_ids
        )
    return SceneDetections(
        boxes=out_boxes, labels=labels, scores=scores, valid=keep
    )


def predict_batch(
    cfg: ModelConfig,
    dataset_idx: int,
    cls_logits: torch.Tensor,  # (B, Q, NC+1)
    boxes: torch.Tensor,  # (B, Q, 7)
    query_valid: torch.Tensor,  # (B, Q)
    points: torch.Tensor,  # (B, P, 3)
    point_valid: torch.Tensor,  # (B, P)
    sp_ids: torch.Tensor,  # (B, P)
) -> SceneDetections:
    """predict_scene over a scene group of one dataset; fields stacked on a
    leading (B,) axis."""
    per_scene = [
        predict_scene(cfg, dataset_idx, *args)
        for args in zip(cls_logits, boxes, query_valid, points, point_valid,
                        sp_ids)
    ]
    return SceneDetections(*(torch.stack(f) for f in zip(*per_scene)))
