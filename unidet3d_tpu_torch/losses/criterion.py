"""Top-k cost matcher and multi-dataset detection criterion.

The port of the JAX package's ``losses/criterion.py`` (``match_scene``,
``layer_loss_scene``, ``criterion``) for the axis-aligned datasets. The JAX
functions work on one scene and are vmapped; here they take a leading batch
dim and match every scene on its own. The semantics are kept exactly:

  * costs 0.5 * (-softmax class score) + 2.0 * DIoU loss, without gradient,
    INF = 1e8 where the query's superpoint is outside the GT's mask, the
    query is padding or the GT is;
  * per GT the MAXK + 1 lowest costs, lower query index first among equal
    costs (``jax.lax.top_k``'s order, here a stable sort), and a match where
    the cost is strictly below the (topk + 1)-th;
  * the class target of a query matched by several GTs is the last GT's;
  * weighted cross entropy (no-object weight 0.1, torch weighted-mean
    semantics, padded queries out) plus the DIoU box loss averaged over each
    scene's matched pairs, scene-averaged over the scenes with pairs, summed
    over every decoder output set with per-layer re-matching.

Rotated scenes (ARKitScenes) need the rotated DIoU, not ported yet: the
criterion raises for them (ROADMAP.md Queue 1, item 3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.boxes import boxes_to_corner_format
from .iou_losses import axis_aligned_diou_loss

INF = 1e8
MAXK = 6  # the largest per-dataset topk


class SceneGT(NamedTuple):
    """Padded ground truth of a batch of scenes.

    labels: (B, G) int in [0, NC); boxes: (B, G, 7) gravity-center, yaw 0;
    valid: (B, G) bool; query_masks: (B, G, Q) bool, the query may match the
    GT."""

    labels: torch.Tensor
    boxes: torch.Tensor
    valid: torch.Tensor
    query_masks: torch.Tensor


class MatchResult(NamedTuple):
    pair_q: torch.Tensor  # (B, G, MAXK) int64 query index per match slot
    pair_valid: torch.Tensor  # (B, G, MAXK) bool
    cls_target: torch.Tensor  # (B, Q) int64 target column (no_obj = nc_max)
    has_match: torch.Tensor  # (B, Q) bool


def _diou_of_boxes(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """DIoU loss of center-size boxes (..., >= 6)."""
    return axis_aligned_diou_loss(
        boxes_to_corner_format(pred[..., :6]), boxes_to_corner_format(target[..., :6])
    )


@torch.no_grad()
def pairwise_bbox_cost(boxes_q: torch.Tensor, boxes_g: torch.Tensor) -> torch.Tensor:
    """(B, Q, 7) x (B, G, 7) -> (B, Q, G) DIoU matching costs."""
    b, q, _ = boxes_q.shape
    g = boxes_g.shape[1]
    return _diou_of_boxes(
        boxes_q[:, :, None, :6].expand(b, q, g, 6),
        boxes_g[:, None, :, :6].expand(b, q, g, 6),
    )


@torch.no_grad()
def match_scene(
    cls_logits: torch.Tensor,  # (B, Q, NC+1), padded columns -1e9
    boxes: torch.Tensor,  # (B, Q, 7)
    query_valid: torch.Tensor,  # (B, Q)
    gt: SceneGT,
    topk: torch.Tensor,  # (B,) int
    cls_weight: float = 0.5,
    bbox_weight: float = 2.0,
    bbox_cost: torch.Tensor | None = None,  # (B, Q, G) precomputed
) -> MatchResult:
    """The reference's top-k matcher on padded tensors, per scene."""
    b, q_cap, ncp1 = cls_logits.shape
    g_cap = gt.labels.shape[1]
    nc_max = ncp1 - 1
    scores = torch.softmax(cls_logits, dim=-1)
    labels = gt.labels.long().clamp(0, nc_max)
    cls_cost = -torch.gather(scores, 2, labels[:, None, :].expand(b, q_cap, g_cap))
    if bbox_cost is None:
        bbox_cost = pairwise_bbox_cost(boxes, gt.boxes)
    cost = cls_weight * cls_cost + bbox_weight * bbox_cost
    allowed = (
        gt.query_masks.transpose(1, 2) & query_valid[:, :, None] & gt.valid[:, None, :]
    )
    cost = torch.where(allowed, cost, INF)

    # Per GT the MAXK + 1 lowest costs; a stable sort keeps the lower query
    # index first among equal costs, as jax.lax.top_k does.
    sorted_costs, idx = torch.sort(cost.transpose(1, 2), dim=-1, stable=True)
    sorted_costs, idx = sorted_costs[..., :MAXK + 1], idx[..., :MAXK + 1]
    kth = topk.long()[:, None, None].expand(b, g_cap, 1)
    thresh = torch.gather(sorted_costs, 2, kth)
    pair_q = idx[..., :MAXK]
    pair_cost = sorted_costs[..., :MAXK]
    pair_valid = (pair_cost < thresh) & (pair_cost < INF) & gt.valid[..., None]

    # Class target: the last (highest-g) matched GT wins.
    matched = torch.zeros((b, q_cap, g_cap), dtype=torch.int32, device=cost.device)
    bi = torch.arange(b, device=cost.device)[:, None, None].expand_as(pair_q)
    gi = torch.arange(g_cap, device=cost.device)[None, :, None].expand_as(pair_q)
    matched.index_put_((bi, pair_q, gi), pair_valid.int(), accumulate=True)
    matched = matched > 0
    has_match = matched.any(-1)
    g_last = g_cap - 1 - torch.argmax(matched.flip(-1).int(), dim=-1)
    cls_target = torch.where(
        has_match, torch.gather(gt.labels.long(), 1, g_last), nc_max
    )
    return MatchResult(pair_q, pair_valid, cls_target, has_match)


def layer_loss_scene(
    cls_logits: torch.Tensor,  # (B, Q, NC+1)
    boxes: torch.Tensor,  # (B, Q, 7)
    query_valid: torch.Tensor,  # (B, Q)
    gt: SceneGT,
    topk: torch.Tensor,  # (B,)
    non_object_weight: float,
    bbox_cost: torch.Tensor | None = None,
):
    """One decoder layer -> per scene (cls_loss, bbox_loss_sum, n_pairs)."""
    b = cls_logits.shape[0]
    nc_max = cls_logits.shape[-1] - 1
    m = match_scene(cls_logits, boxes, query_valid, gt, topk, bbox_cost=bbox_cost)

    logp = F.log_softmax(cls_logits, dim=-1)
    nll = -torch.gather(logp, 2, m.cls_target[..., None])[..., 0]
    w = torch.where(m.cls_target == nc_max, non_object_weight, 1.0)
    w = torch.where(query_valid, w, 0.0)
    cls_loss = (w * nll).sum(-1) / w.sum(-1).clamp(min=1e-8)

    flat_q = m.pair_q.reshape(b, -1)  # (B, G*MAXK), GT-major
    pred = torch.gather(boxes, 1, flat_q[..., None].expand(-1, -1, boxes.shape[-1]))
    tgt = gt.boxes.repeat_interleave(MAXK, dim=1)
    pair_loss = _diou_of_boxes(pred, tgt)
    pv = m.pair_valid.reshape(b, -1)
    bbox_sum = torch.where(pv, pair_loss, 0.0).sum(-1)
    return cls_loss, bbox_sum, pv.sum(-1)


def criterion(
    cls_logits: torch.Tensor,  # (L, B, Q, NC+1)
    boxes: torch.Tensor,  # (L, B, Q, 7)
    query_valid: torch.Tensor,  # (B, Q)
    gt: SceneGT,
    rotated: torch.Tensor,  # (B,) bool
    topk: torch.Tensor,  # (B,)
    dataset_weights: torch.Tensor,  # (B,)
    loss_weight=(0.5, 1.0),
    non_object_weight: float = 0.1,
) -> torch.Tensor:
    """Total detection loss over all decoder output sets (one card)."""
    if bool(rotated.any()):
        raise NotImplementedError(
            "rotated scenes need the rotated DIoU loss and matcher costs "
            "(ops/rotated_iou.py), not ported yet: ROADMAP.md Queue 1, item 3"
        )
    total = cls_logits.new_zeros(())
    for layer in range(cls_logits.shape[0]):
        costs = pairwise_bbox_cost(boxes[layer], gt.boxes)
        cls_l, bbox_sum, n_pairs = layer_loss_scene(
            cls_logits[layer], boxes[layer], query_valid, gt, topk,
            non_object_weight, costs,
        )
        cls_loss = (dataset_weights * cls_l).mean()
        # Scene mean over the scenes that have matched pairs.
        has_pairs = n_pairs > 0
        scene_bbox = dataset_weights * bbox_sum / n_pairs.clamp(min=1)
        bbox_loss = (
            torch.where(has_pairs, scene_bbox, 0.0).sum()
            / has_pairs.sum().clamp(min=1)
        )
        total = total + loss_weight[0] * cls_loss + loss_weight[1] * bbox_loss
    return total
