"""Inference post-processing: top-k selection, class-wise NMS, superpoint
box trimming.

The port of the JAX package's ``models/postprocess.py``. Predictions are
fixed-size (topk_insts,) arrays with a validity mask; the dataset index is a
host int per scene group, which picks the rotated (ARKitScenes) or the
axis-aligned NMS and whether boxes are trimmed by superpoints. Trimming runs
the card's kernel (``ops/sp_trim_cuda.py``) on CUDA tensors and
``trim_boxes_by_superpoints``, its plain version, on CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.boxes import get_face_distances
from ..core.config import ModelConfig
from ..ops.nms import greedy_nms, pairwise_iou_aa, pairwise_iou_rotated
from ..ops.segment import segment_mean
from ..ops.sp_trim_cuda import sp_trim_cuda
from ..train.profiling import span


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
    """Superpoint-vote box trimming, chunked over boxes: the plain version
    of the card's kernel (``ops/sp_trim_cuda.py``), which it must equal.

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


def _select_and_suppress(cfg: ModelConfig, dataset_idx: int, cls_logits: torch.Tensor,
                         boxes: torch.Tensor, query_valid: torch.Tensor):
    """One scene's top-k selection and class-wise NMS (span "post.nms"):
    its (K, 7) boxes (yaw zeroed unless the dataset is rotated), labels,
    scores and NMS keep mask."""
    rotated = cfg.angles[dataset_idx]
    sel_boxes, labels, scores = select_topk_instances(
        cls_logits, boxes, query_valid, cfg.topk_insts
    )
    valid = scores > cfg.score_thr
    with span("post.nms"):
        iou = pairwise_iou_rotated(sel_boxes) if rotated else pairwise_iou_aa(sel_boxes)
        keep = greedy_nms(iou, scores, labels, valid, cfg.iou_thr[dataset_idx])
    out_boxes = sel_boxes
    if not rotated:
        out_boxes = sel_boxes.clone()
        out_boxes[:, 6] = 0.0
    return out_boxes, labels, scores, keep


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
    """Full single-scene post-processing: predict_batch on a group of one."""
    det = predict_batch(cfg, dataset_idx, *(x[None] for x in (
        cls_logits, boxes, query_valid, points, point_valid, sp_ids)))
    return SceneDetections(*(f[0] for f in det))


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
    """Post-processing of a scene group of one dataset, fields stacked on a
    leading (B,) axis: each scene's top-k and NMS (span "post.nms"), then
    the group's trimming (span "post.trim"), on the card one kernel launch
    for the whole group, on the CPU the plain version scene by scene.
    Trimming does not read the NMS mask; its "has" is and-ed into it."""
    out_boxes, labels, scores, keep = (torch.stack(f) for f in zip(*(
        _select_and_suppress(cfg, dataset_idx, *args)
        for args in zip(cls_logits, boxes, query_valid))))
    if cfg.use_superpoints[dataset_idx]:
        with span("post.trim"):
            if points.is_cuda:
                out_boxes, has = sp_trim_cuda(
                    points.contiguous(), point_valid.contiguous(), sp_ids.int().contiguous(),
                    out_boxes, cfg.max_superpoints, cfg.low_sp_thr, cfg.up_sp_thr,
                )
                keep = keep & has
            else:
                out_boxes, keep = (torch.stack(f) for f in zip(*(
                    trim_boxes_by_superpoints(cfg, *args)
                    for args in zip(out_boxes, keep, points, point_valid, sp_ids))))
    return SceneDetections(
        boxes=out_boxes, labels=labels, scores=scores, valid=keep
    )
