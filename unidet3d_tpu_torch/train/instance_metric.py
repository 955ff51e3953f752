"""ScanNet instance segmentation AP (AP, AP50, AP25 over 18 classes) and
semantic mIoU (20 classes), from per-superpoint counts.

ScanNet's ``evaluate_semantic_instance`` (as mmdet3d's ``instance_seg_eval``
applies it, with OneFormer3D's (n, P) prediction masks) needs, per scene,
each prediction's point count, its intersection with each ground-truth
instance and with the void points (those in no instance of the 18 classes),
and each ground-truth instance's point count. A prediction is a set of
superpoints, so each of these is exact from a (superpoint x ground-truth
column) point histogram H: intersections = masks @ H. No (K x P) point
mask is built anywhere.

  * ``group_histograms`` (the card, from a group's test-pipeline samples):
    H with column 0 the void points and column 1 + i the points of raw
    instance id i (ids in increasing order, as ``np.unique`` orders them),
    the (superpoint x semantic class) histogram, each column's classes;
  * ``group_counts`` (the card): the products with a group's kept masks and
    its semantic map; ``ground_truth`` (host) keeps the columns that hold
    points; ``count_group``: both for a group's InstancePredictions, as
    the eval loop's post-processing step ends;
  * ``InstanceSegMetric``: ``process_group`` a counted group (the eval
    loop's drain), ``process`` one scene's counts, ``compute`` the
    numbers. The AP follows ``evaluate_matches`` rule for rule: overlaps
    0.5:0.95:0.05 and 0.25, predictions and ground truth of fewer than 100
    points left out (a small instance's intersection and the void's count
    as ignored for an unmatched prediction), greedy matching in prediction
    order, a second match of an instance a false positive at the lower
    score, the interpolated precision-recall sum. mIoU is mmdet3d's
    ``seg_eval`` with the ignore class 20.

Semantic masks hold raw nyu40 ids, mapped to the 20 classes (``point_seg_
class_mapping``); an instance's class is its semantic class less the two
stuff classes (wall, floor).
"""
from __future__ import annotations

import warnings
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import CLASSES_SCANNET
from ..data.dataset_specs import SCANNET_SEG_VALID_CLASS_IDS
from .profiling import span

SEMANTIC_CLASSES = ("wall", "floor") + CLASSES_SCANNET
N_SEM = len(SEMANTIC_CLASSES)  # 20; 20 is the ignore class
N_STUFF = 2
MIN_REGION = 100  # ScanNet's min_region_sizes
OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)

_LUT = np.full(41, N_SEM, np.int64)
_LUT[list(SCANNET_SEG_VALID_CLASS_IDS)] = np.arange(N_SEM)


def semantic_classes(raw: np.ndarray) -> np.ndarray:
    """Raw nyu40 ids -> 0..19, anything else 20 (ignore)."""
    return _LUT[np.clip(np.asarray(raw, np.int64), 0, 40)]


class GroupHistograms(NamedTuple):
    """A group's ground truth as per-superpoint point counts, on the device."""
    hist: torch.Tensor  # (B, S, 1 + G) int64: column 0 the void, 1 + i raw instance id i
    sem_hist: torch.Tensor  # (B, S, 21) int64: points per semantic class, 20 ignore
    label_lo: torch.Tensor  # (B, 1 + G) the smallest and the largest semantic class
    label_hi: torch.Tensor  # of each column's points (a column with none: N_SEM, -1)


def group_histograms(samples: list, num_superpoints: int, device) -> GroupHistograms:
    """The histograms of a group's test-pipeline samples over their
    superpoint ids folded into [0, S) as ``collate`` folds them. The host
    uploads each sample's raw semantic, instance and superpoint ids and reads
    the largest instance id (the column count); the card does the rest."""
    for sample in samples:
        for key in ("pts_semantic_mask", "pts_instance_mask", "sp_pts_mask"):
            if key not in sample:
                raise ValueError(f"instance evaluation needs the sample's {key!r}")
    s = int(num_superpoints)
    b = len(samples)
    g = max([int(np.max(sm["pts_instance_mask"], initial=-1)) + 1 for sm in samples])
    n = [len(sm["pts_semantic_mask"]) for sm in samples]
    raw = np.stack([np.concatenate([np.asarray(sm[k], np.int32) for sm in samples])
                    for k in ("pts_semantic_mask", "pts_instance_mask", "sp_pts_mask")])
    raw = torch.from_numpy(raw).to(device)
    scene = torch.repeat_interleave(torch.arange(b, device=device),
                                    torch.tensor(n, device=device))
    lut = torch.from_numpy(_LUT).to(device)
    sem = lut[raw[0].long().clamp(0, 40)]
    inst = raw[1].long()
    slot = scene * s + raw[2].long().clamp(max=s - 1)
    thing = (inst >= 0) & (sem >= N_STUFF) & (sem < N_SEM)
    col = torch.where(thing, inst + 1, 0)
    hist = torch.bincount(slot * (g + 1) + col, minlength=b * s * (g + 1))
    sem_hist = torch.bincount(slot * (N_SEM + 1) + sem, minlength=b * s * (N_SEM + 1))
    key = scene * (g + 1) + col
    lo = torch.full((b * (g + 1),), N_SEM, dtype=torch.int64, device=device)
    hi = torch.full((b * (g + 1),), -1, dtype=torch.int64, device=device)
    lo = lo.scatter_reduce(0, key, sem, "amin")
    hi = hi.scatter_reduce(0, key, sem, "amax")
    return GroupHistograms(hist.view(b, s, g + 1), sem_hist.view(b, s, N_SEM + 1),
                           lo.view(b, g + 1), hi.view(b, g + 1))


def group_counts(masks: torch.Tensor, semantic: torch.Tensor, hists: GroupHistograms):
    """On the device: (intersections (B, K, 1 + G), column 0 the void's,
    and the semantic confusion (B, 21, 20), rows the ground truth) of a
    group's kept masks (B, K, S) bool and semantic map (B, S). fp64
    products of counts: exact."""
    inter = masks.double() @ hists.hist.double()
    onehot = torch.nn.functional.one_hot(semantic, N_SEM).double()
    conf = hists.sem_hist.double().transpose(1, 2) @ onehot
    return inter.long(), conf.long()


class InstanceGroup(NamedTuple):
    """A group's predictions with their metric counts and its ground
    truth's column numbers, on the device."""
    keep: torch.Tensor  # (B, K)
    labels: torch.Tensor
    scores: torch.Tensor
    inter: torch.Tensor  # (B, K, 1 + G), column 0 the void
    sem_conf: torch.Tensor  # (B, 21, 20)
    gt_sizes: torch.Tensor  # (B, 1 + G) points per column
    label_lo: torch.Tensor  # (B, 1 + G) the classes of each column's points
    label_hi: torch.Tensor
    predictions: object  # the InstancePredictions they were counted from


def count_group(pred, samples: list) -> InstanceGroup:
    """A group's InstancePredictions `pred` with their counts against the
    histograms of its test-pipeline `samples`, on the predictions'
    device."""
    hists = group_histograms(samples, pred.masks.shape[-1], pred.masks.device)
    inter, conf = group_counts(pred.masks, pred.semantic, hists)
    return InstanceGroup(pred.keep, pred.labels, pred.scores, inter, conf,
                         hists.hist.sum(1), hists.label_lo, hists.label_hi, pred)


def ground_truth(hist_sizes, label_lo, label_hi):
    """One scene's ground-truth instances from its fetched histogram
    numbers: (sizes (G,), labels (G,), present (1 + G,) bool column mask of
    the void and the instances that hold points). Raises where an instance
    spans several semantic classes, as ScanNet's ``rename_gt`` asserts."""
    present = np.asarray(hist_sizes) > 0
    present[0] = True
    if np.any((label_lo != label_hi) & present & (np.arange(len(present)) > 0)):
        raise ValueError("a ground-truth instance spans several semantic classes")
    sizes = np.asarray(hist_sizes)[present][1:]
    return sizes, np.asarray(label_lo)[present][1:] - N_STUFF, present


class InstanceSegMetric:
    """Per-scene counts in, ScanNet instance AP and semantic mIoU out."""

    def __init__(self, dataset: str = "scannet"):
        self.dataset = dataset
        self._scenes = []

    def process(self, keep, labels, scores, inter, gt_sizes, gt_labels, sem_conf):
        """Adds one scene: its fixed-size predictions (K,) keep / labels /
        scores in the program's order, their (K, 1 + G) intersections
        (column 0 the void, column 1 + g instance g), the ground truth's
        (G,) point counts and labels, and the (21, 20) semantic confusion.
        Predictions of fewer than 100 points are left out, as ScanNet's
        ``assign_instances_for_scan`` leaves them."""
        inter = np.asarray(inter, np.int64)
        keep = np.asarray(keep, bool) & (inter.sum(1) >= MIN_REGION)
        inter = inter[keep]
        g = len(gt_labels)
        self._scenes.append(dict(
            labels=np.asarray(labels, np.int64)[keep], scores=np.asarray(scores)[keep],
            sizes=inter.sum(1), void=inter[:, 0], inter=inter[:, 1:g + 1],
            gt_sizes=np.asarray(gt_sizes, np.int64), gt_labels=np.asarray(gt_labels, np.int64),
            sem_conf=np.asarray(sem_conf, np.int64)))

    def process_group(self, pred: InstanceGroup, group, viewer=None):
        """Adds an eval group's real scenes (the loop's EvalGroup `group`)
        from its counted predictions: the copy to the host is the span
        "eval.fetch", the rest "eval.metric". Nothing is drawn: evaluate
        refuses a viewer for instances."""
        g = group.index
        with span("eval.fetch", g):
            keep, labels, scores, inter, conf, sizes, lo, hi = (
                x.cpu().numpy() for x in pred[:8])
        with span("eval.metric", g):
            for i in range(len(group.scene_ids)):
                gt_sizes, gt_labels, present = ground_truth(sizes[i], lo[i], hi[i])
                self.process(keep[i], labels[i], scores[i], inter[i][:, present], gt_sizes,
                             gt_labels, conf[i])

    def gather_across_processes(self):
        """Every process contributes its scenes, ordered by rank; a no-op
        without a torch.distributed process group."""
        if not (dist.is_available() and dist.is_initialized()):
            return
        payload = [None] * dist.get_world_size()
        dist.all_gather_object(payload, self._scenes)
        self._scenes = [s for part in payload for s in part]

    def compute(self, logger=print) -> Dict[str, Dict[str, float]]:
        """{dataset: {"AP", "AP50", "AP25", "<class>_AP"..., "mIoU", "acc",
        "acc_cls", "<class>_IoU"...}}; {} without scenes."""
        if not self._scenes:
            return {}
        res = instance_ap(self._scenes, len(CLASSES_SCANNET))
        out = {"AP": res["all_ap"], "AP50": res["all_ap_50%"], "AP25": res["all_ap_25%"]}
        for name, ap in zip(CLASSES_SCANNET, res["classes"]):
            out[f"{name}_AP"], out[f"{name}_AP50"], out[f"{name}_AP25"] = ap
        out.update(semantic_iou(sum(s["sem_conf"][:N_SEM] for s in self._scenes)))
        if logger is not None:
            logger(f"==== {self.dataset} instances ====")
            logger(f"AP {out['AP']:.4f} AP50 {out['AP50']:.4f} AP25 {out['AP25']:.4f} "
                   f"mIoU {out['mIoU']:.4f}")
        return {self.dataset: out}


def _scene_matches(scene: dict, n_classes: int):
    """``evaluate_matches`` over one scene, every overlap at once: the
    (overlap, class, true, score) entries it adds to the precision-recall
    curves, (overlaps, classes) counts of hard false negatives, and has gt
    and has pred per class. The ground-truth instances are matched greedily
    in column order: the first unvisited prediction (in the program's order)
    of the instance's class above the overlap matches and is visited; the
    other eligible ones are false positives at their scores, the instance
    keeps the largest (ScanNet's running max / min gives that multiset)."""
    th = OVERLAPS[:, None, None]
    labels, conf = scene["labels"], scene["scores"]
    gt_labels, gt_sizes = scene["gt_labels"], scene["gt_sizes"]
    inter, sizes = scene["inter"], scene["sizes"]
    same = labels[:, None] == gt_labels[None, :]
    with np.errstate(invalid="ignore", divide="ignore"):
        overlap = inter / (gt_sizes[None, :] + sizes[:, None] - inter)
    over = (inter > 0)[None] & same[None] & (overlap[None] > th)  # (T, P, G)
    big = gt_sizes >= MIN_REGION
    t_n = len(OVERLAPS)
    visited = np.zeros((t_n, len(labels)), bool)
    hard = np.zeros((t_n, n_classes), np.int64)
    entries = []
    rows = np.arange(t_n)
    for j in np.flatnonzero(big):
        eligible = over[:, :, j] & ~visited
        found = eligible.any(1)
        hard[~found, gt_labels[j]] += 1
        if not found.any():
            continue
        visited[rows[found], eligible[found].argmax(1)] = True
        best = np.where(eligible, conf[None, :], -np.inf).argmax(1)
        t_idx, p_idx = np.nonzero(eligible)
        entries.append((t_idx, np.full(len(t_idx), gt_labels[j]),
                        (p_idx == best[t_idx]).astype(np.float64), conf[p_idx]))
    ignore = scene["void"] + (inter * (same & ~big[None, :])).sum(1)
    with np.errstate(invalid="ignore", divide="ignore"):
        fp = ~over.any(2) & (ignore / sizes <= OVERLAPS[:, None])
    t_idx, p_idx = np.nonzero(fp)
    entries.append((t_idx, labels[p_idx], np.zeros(len(t_idx)), conf[p_idx]))
    has_gt = np.bincount(gt_labels[big], minlength=n_classes)[:n_classes] > 0
    has_pred = np.bincount(labels, minlength=n_classes)[:n_classes] > 0
    return entries, hard, has_gt, has_pred


def _average_precision(y_true, y_score, hard_fn) -> float:
    """ScanNet's interpolated precision-recall sum (its loop over the unique
    scores, one array operation per step of it: the same values)."""
    y_true, y_score = np.asarray(y_true, np.float64), np.asarray(y_score, np.float64)
    order = np.argsort(y_score)
    cumsum = np.cumsum(y_true[order])
    _, unique_indices = np.unique(y_score[order], return_index=True)
    num_true = cumsum[-1] if len(cumsum) > 0 else 0
    c = np.append(cumsum, 0)[unique_indices - 1]
    tp = num_true - c
    fp = len(y_score) - unique_indices - tp
    with np.errstate(invalid="ignore", divide="ignore"):
        precision = np.append(tp / (tp + fp), 1.0)
        recall = np.append(tp / (tp + c + hard_fn), 0.0)
    r = np.append(np.append(recall[0], recall), 0.0)
    return float(np.dot(precision, np.convolve(r, [-0.5, 0, 0.5], "valid")))


def instance_ap(scenes: list, n_classes: int) -> dict:
    """{"all_ap", "all_ap_50%", "all_ap_25%", "classes": [(ap, ap50, ap25)]}
    over the scenes' counts (``compute_averages``)."""
    t_n = len(OVERLAPS)
    entries = []
    hard = np.zeros((t_n, n_classes), np.int64)
    has_gt = np.zeros(n_classes, bool)
    has_pred = np.zeros(n_classes, bool)
    for scene in scenes:
        e, h, g, p = _scene_matches(scene, n_classes)
        entries += e
        hard += h
        has_gt |= g
        has_pred |= p
    t_all, lab, true, score = (np.concatenate(x) for x in zip(*entries))
    key = t_all * n_classes + lab  # the entries of each (overlap, class), together
    order = np.argsort(key, kind="stable")
    bounds = np.searchsorted(key[order], np.arange(t_n * n_classes + 1))
    ap = np.zeros((n_classes, t_n))
    for oi in range(t_n):
        for label in range(n_classes):
            if has_gt[label] and has_pred[label]:
                k = oi * n_classes + label
                sel = order[bounds[k]:bounds[k + 1]]
                ap[label, oi] = _average_precision(true[sel], score[sel], hard[oi, label])
            else:
                ap[label, oi] = 0.0 if has_gt[label] else float("nan")
    o50 = np.where(np.isclose(OVERLAPS, 0.5))
    o25 = np.where(np.isclose(OVERLAPS, 0.25))
    rest = np.where(np.logical_not(np.isclose(OVERLAPS, 0.25)))
    with warnings.catch_warnings():  # a class without gt or prediction: nan
        warnings.simplefilter("ignore", RuntimeWarning)
        return {"all_ap": float(np.nanmean(ap[:, rest])),
                "all_ap_50%": float(np.nanmean(ap[:, o50])),
                "all_ap_25%": float(np.nanmean(ap[:, o25])),
                "classes": [(float(np.average(ap[i, rest])), float(np.average(ap[i, o50])),
                             float(np.average(ap[i, o25]))) for i in range(n_classes)]}


def semantic_iou(hist: np.ndarray) -> dict:
    """mmdet3d's seg_eval over a (20, 20) confusion (rows ground truth)."""
    hist = np.asarray(hist, np.int64)
    diag = np.diag(hist)
    with warnings.catch_warnings(), np.errstate(invalid="ignore", divide="ignore"):
        warnings.simplefilter("ignore", RuntimeWarning)
        iou = diag / (hist.sum(1) + hist.sum(0) - diag)
        out = {"mIoU": float(np.nanmean(iou)), "acc": float(diag.sum() / hist.sum()),
               "acc_cls": float(np.nanmean(diag / hist.sum(1)))}
    out.update({f"{name}_IoU": float(v) for name, v in zip(SEMANTIC_CLASSES, iou)})
    return out

