"""OneFormer3D's instance post-processing (the public ``pred_inst`` with its
ScanNet ``test_cfg``) and semantic map (``pred_sem``), on a scene group of
one dataset at once, on the card for CUDA tensors:

  1. scores: the instance queries' softmax class probabilities without the
     no-object column, the top ``topk_insts`` over (query x class);
  2. ``obj_normalization``: each score times its mask's mean sigmoid over
     the superpoints whose logit is > 0;
  3. matrix NMS with the linear kernel over the soft (sigmoid) superpoint
     masks (``mask_matrix_nms``): a (K x S) x (S x K) product per scene;
  4. the superpoint masks ``sigmoid > sp_score_thr``; kept where the decayed
     score is > ``inst_score_thr`` and the mask holds more than
     ``npoint_thr`` points.

The semantic map is the arg-max, per superpoint, of the semantic queries'
mask sigmoids. The span "post.masks" covers the group. Padded superpoint
slots are no part of any mask; padded queries score 0 and are never kept.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import OneFormer3DConfig
from ..train.profiling import span


class InstancePredictions(NamedTuple):
    """A group's instances, fixed-size (K = topk_insts) per scene in
    descending order of their decayed scores (matrix NMS's second sort)."""

    masks: torch.Tensor  # (B, K, S) bool, sigmoid > sp_score_thr on valid slots
    labels: torch.Tensor  # (B, K) int64 instance class
    scores: torch.Tensor  # (B, K) float32
    keep: torch.Tensor  # (B, K) bool
    queries: torch.Tensor  # (B, K) int64 superpoint slot of the instance's query
    semantic: torch.Tensor  # (B, S) int64 semantic class per superpoint slot


def _take(order, *rows):
    """Each (B, K, ...) tensor of `rows` reordered along K by (B, K) order."""
    return [torch.gather(x, 1, order.view(*order.shape, *[1] * (x.dim() - 2)).expand_as(x))
            for x in rows]


def matrix_nms(masks: torch.Tensor, labels: torch.Tensor, scores: torch.Tensor):
    """mmdet's ``mask_matrix_nms`` with the linear kernel, batched over
    scenes: masks (B, K, S) float, labels (B, K), scores (B, K) -> (decayed
    scores, labels, masks, order). As mmdet's, it sorts by descending score,
    decays, and sorts again by the decayed scores, so the rows come out in
    descending order of their decayed scores (both sorts stable); order
    holds the input rows' indices in that order."""
    scores, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    labels, masks = _take(order, labels, masks)
    area = masks.sum(-1)
    inter = masks @ masks.transpose(1, 2)
    iou = (inter / (area[:, :, None] + area[:, None, :] - inter)).triu(1)
    same = (labels[:, :, None] == labels[:, None, :]).triu(1)
    decay_iou = iou * same
    compensate = decay_iou.amax(1)  # per column j: its largest IoU with a higher score
    decay = ((1 - decay_iou) / (1 - compensate[:, :, None])).amin(1)
    scores, again = torch.sort(scores * decay, dim=-1, descending=True, stable=True)
    labels, masks, order = _take(again, labels, masks, order)
    return scores, labels, masks, order


def predict_instances(cfg: OneFormer3DConfig, cls_logits: torch.Tensor,
                      mask_logits: torch.Tensor, sp_valid: torch.Tensor,
                      sp_counts: torch.Tensor) -> InstancePredictions:
    """Post-processing of a group (module docstring).

    Args:
        cls_logits: (B, Q, C + 1) last-set class logits of every query.
        mask_logits: (B, Q, S) last-set mask logits.
        sp_valid: (B, S) superpoint slots holding points.
        sp_counts: (B, S) valid points per slot (the npoint_thr counts).
    """
    n_sem, nc = cfg.num_semantic_queries, cfg.num_instance_classes
    b, _, s = mask_logits.shape
    with span("post.masks"):
        probs = torch.softmax(cls_logits[:, n_sem:], dim=-1)[..., :nc]
        probs = torch.where(sp_valid[..., None], probs, 0.0)
        scores, idx = torch.topk(probs.reshape(b, -1), min(cfg.topk_insts, s * nc), dim=-1)
        labels, queries = idx % nc, idx // nc
        logits = torch.gather(mask_logits[:, n_sem:], 1,
                              queries[..., None].expand(-1, -1, s))
        key = sp_valid[:, None, :]
        sig = torch.where(key, torch.sigmoid(logits), 0.0)
        if cfg.obj_normalization:
            pos = (logits > 0) & key
            scores = scores * (sig * pos).sum(-1) / (pos.sum(-1) + 1e-6)
        if cfg.nms:
            if cfg.matrix_nms_kernel != "linear":
                raise ValueError(f"matrix_nms_kernel {cfg.matrix_nms_kernel!r}: only 'linear'")
            scores, labels, sig, order = matrix_nms(sig, labels, scores)
            queries = torch.gather(queries, 1, order)
        masks = sig > cfg.sp_score_thr
        npoints = (masks * sp_counts[:, None, :]).sum(-1)
        keep = (scores > cfg.inst_score_thr) & (npoints > cfg.npoint_thr)
        semantic = torch.sigmoid(mask_logits[:, :n_sem]).argmax(1)
    return InstancePredictions(masks=masks, labels=labels, scores=scores, keep=keep,
                               queries=queries, semantic=semantic)
