"""Top-k cost matcher and multi-dataset detection criterion.

The port of the JAX package's ``losses/criterion.py`` (``match_scene``,
``layer_loss_scene``, ``criterion``). The JAX functions work on one scene and
are vmapped; here they take a leading batch dim and match every scene on its
own. The semantics are kept exactly:

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

Rotated scenes (ARKitScenes) take the rotated DIoU (``ops/rotated_iou.py``),
the others the axis-aligned one. Which scenes are rotated is a host tuple of
scene indices (``rotated_scenes``), so that only those scenes pay for the
polygon clip in the matcher, as under the JAX package's per-scene
``lax.cond``, and nothing is read back from the card to find them.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.boxes import boxes_to_corner_format
from ..parallel.distributed import world_size
from .iou_losses import axis_aligned_diou_loss, rotated_diou_3d_loss

INF = 1e8
MAXK = 6  # the largest per-dataset topk
# Well-conditioned stand-ins for the rotated branch's inputs in non-rotated
# scenes (see _sanitize_rot_inputs).
_SAFE_BOX = (0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0)
_SAFE_BOX2 = (0.3, 0.2, 0.1, 1.0, 1.0, 1.0, 0.4)


class SceneGT(NamedTuple):
    """Padded ground truth of a batch of scenes.

    labels: (B, G) int in [0, NC); boxes: (B, G, 7) gravity-center, yaw 0
    unless the scene is rotated; valid: (B, G) bool; query_masks: (B, G, Q)
    bool, the query may match the GT."""

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
    """Axis-aligned DIoU loss of center-size boxes (..., >= 6)."""
    return axis_aligned_diou_loss(
        boxes_to_corner_format(pred[..., :6]), boxes_to_corner_format(target[..., :6])
    )


def _box_like(values, like: torch.Tensor) -> torch.Tensor:
    """A (7,) box on `like`'s device and dtype, written by fills: a copy from
    the host would wait for the card."""
    out = like.new_empty(len(values))
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def _sanitize_rot_inputs(pred, tgt, rotated):
    """Replace the rotated branch's inputs (..., 7) with well-conditioned
    stand-ins where `rotated` (broadcast against pred[..., 0]) is False, so
    that its unselected backward stays NaN-free: the double-where guard,
    which torch.where needs as jnp.where does."""
    r = rotated[..., None]
    p = torch.where(r, pred, _box_like(_SAFE_BOX, pred))
    t = torch.where(r, tgt, _box_like(_SAFE_BOX2, tgt))
    return p, t


@torch.no_grad()
def rotated_costs(boxes_q: torch.Tensor, boxes_g: torch.Tensor,
                  chunk: int = 128) -> torch.Tensor:
    """(..., Q, 7) x (..., G, 7) -> (..., Q, G) rotated DIoU losses, chunked
    over the queries as in the JAX package: whole, the 24-candidate clip's
    temporaries are (..., Q, G, 24, 2) several times over."""
    q = boxes_q.shape[-2]
    bg = boxes_g[..., None, :, :]
    return torch.cat(
        [rotated_diou_3d_loss(boxes_q[..., q0:q0 + chunk, None, :], bg)
         for q0 in range(0, q, chunk)],
        dim=-2,
    )


@torch.no_grad()
def pairwise_costs_batch(boxes_q: torch.Tensor, boxes_g: torch.Tensor,
                         rotated_scenes: Sequence[int] = (),
                         chunk: int = 128) -> torch.Tensor:
    """(..., B, Q, 7) x (B, G, 7) -> (..., B, Q, G) DIoU matching costs.

    The axis-aligned costs of every scene, then the rotated ones, chunked
    over the queries, of the scenes in `rotated_scenes` (host ints) only:
    the clip is the dearest part of the loss, and a scene that is not
    rotated does not pay for it. A leading dim (the decoder's output sets)
    is taken in the same passes."""
    q, g = boxes_q.shape[-2], boxes_g.shape[-2]
    lead = boxes_q.shape[:-2]
    cost = _diou_of_boxes(
        boxes_q[..., :, None, :6].expand(*lead, q, g, 6),
        boxes_g[:, None, :, :6].expand(*lead, q, g, 6),
    )
    if rotated_scenes:
        bq = torch.stack([boxes_q[..., i, :, :] for i in rotated_scenes], dim=-3)
        bg = torch.stack([boxes_g[i] for i in rotated_scenes])
        rot = rotated_costs(bq, bg, chunk)
        for r, i in enumerate(rotated_scenes):
            cost[..., i, :, :] = rot[..., r, :, :]
    return cost


def _elementwise_bbox_loss(pred, tgt, rotated, rotated_scenes):
    """One-to-one DIoU loss (B, N) of boxes (B, N, 7): rotated where the
    scene's flag `rotated` (B,) is set. The rotated branch runs only if the
    batch has a rotated scene."""
    aa = _diou_of_boxes(pred, tgt)
    if not rotated_scenes:
        return aa
    r = rotated[:, None]
    rp, rt = _sanitize_rot_inputs(pred, tgt, r)
    return torch.where(r, rotated_diou_3d_loss(rp, rt), aa)


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
    rotated_scenes: Sequence[int] = (),  # host ints: the rotated scenes
) -> MatchResult:
    """The reference's top-k matcher on padded tensors, per scene."""
    b, q_cap, ncp1 = cls_logits.shape
    g_cap = gt.labels.shape[1]
    nc_max = ncp1 - 1
    scores = torch.softmax(cls_logits, dim=-1)
    labels = gt.labels.long().clamp(0, nc_max)
    cls_cost = -torch.gather(scores, 2, labels[:, None, :].expand(b, q_cap, g_cap))
    if bbox_cost is None:
        bbox_cost = pairwise_costs_batch(boxes, gt.boxes, rotated_scenes)
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
    rotated: torch.Tensor | None = None,  # (B,) bool, needed with rotated_scenes
    rotated_scenes: Sequence[int] = (),  # host ints: the scenes rotated marks
):
    """One decoder layer -> per scene (cls_loss, bbox_loss_sum, n_pairs)."""
    b = cls_logits.shape[0]
    nc_max = cls_logits.shape[-1] - 1
    m = match_scene(cls_logits, boxes, query_valid, gt, topk, bbox_cost=bbox_cost,
                    rotated_scenes=rotated_scenes)

    logp = F.log_softmax(cls_logits, dim=-1)
    nll = -torch.gather(logp, 2, m.cls_target[..., None])[..., 0]
    w = torch.where(m.cls_target == nc_max, non_object_weight, 1.0)
    w = torch.where(query_valid, w, 0.0)
    cls_loss = (w * nll).sum(-1) / w.sum(-1).clamp(min=1e-8)

    flat_q = m.pair_q.reshape(b, -1)  # (B, G*MAXK), GT-major
    pred = torch.gather(boxes, 1, flat_q[..., None].expand(-1, -1, boxes.shape[-1]))
    tgt = gt.boxes.repeat_interleave(MAXK, dim=1)
    pair_loss = _elementwise_bbox_loss(pred, tgt, rotated, rotated_scenes)
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
    rotated_scenes: Sequence[int] | None = None,
) -> torch.Tensor:
    """Total detection loss over all decoder output sets.

    `rotated_scenes` are the indices of the scenes `rotated` marks, as host
    ints (``detection_loss`` takes them from the collated dataset ids).
    Given, the criterion reads nothing back from the card; left None, it
    reads `rotated` (a wait for the card when it lies there).

    Under a process group of more than one rank (data parallelism) the box
    loss's scene mean is taken over the global batch, as under the JAX
    package's ``psum``: the counts of scenes with matched pairs of every
    output set are summed over the group in one all-reduce, issued by every
    rank whatever its scenes, and each local term is scaled by the world
    size, so that the group's mean of the local losses (and of their
    gradients) is the one-process loss on the global batch."""
    if rotated_scenes is None:
        rotated_scenes = [i for i, r in enumerate(rotated.tolist()) if r]
    rotated_scenes = tuple(rotated_scenes)
    # The matcher's box costs of every output set in one pass: they carry no
    # gradient and do not depend on an earlier set's matching.
    costs = pairwise_costs_batch(boxes, gt.boxes, rotated_scenes)
    layers = [
        layer_loss_scene(cls_logits[layer], boxes[layer], query_valid, gt, topk,
                         non_object_weight, costs[layer], rotated, rotated_scenes)
        for layer in range(cls_logits.shape[0])
    ]
    has_pairs = [n_pairs > 0 for _, _, n_pairs in layers]
    n_dev = world_size()
    # (L,) counts of scenes with pairs: outside every data-dependent branch,
    # since a collective that some rank skips never returns.
    global_has = torch.stack([h.sum() for h in has_pairs])
    if n_dev > 1:
        global_has = global_has.float()
        dist.all_reduce(global_has)
    total = cls_logits.new_zeros(())
    for (cls_l, pair_sum, n_pairs), has, n_has in zip(layers, has_pairs, global_has):
        cls_loss = (dataset_weights * cls_l).mean()
        # Scene mean over the (global batch's) scenes that have matched pairs.
        scene_bbox = dataset_weights * pair_sum / n_pairs.clamp(min=1)
        bbox_sum = torch.where(has, scene_bbox, 0.0).sum()
        if n_dev > 1:
            bbox_sum = n_dev * bbox_sum
        bbox_loss = bbox_sum / n_has.clamp(min=1)
        total = total + loss_weight[0] * cls_loss + loss_weight[1] * bbox_loss
    return total
