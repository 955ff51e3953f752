"""OneFormer3D's ScanNet instance segmentation in plain PyTorch, fp32: the
reference that the port (``unidet3d_tpu_torch/models/oneformer3d.py``,
``models/instance_postprocess.py``, ``train/instance_metric.py``) is held
against. No kernel, no batching: one scene at a time, over its own
superpoints only, written from the paper and the public code
(github.com/filapro/oneformer3d: ``ScanNetOneFormer3D.predict``,
``ScanNetQueryDecoder``, ``pred_inst``, ``pred_sem``, ``mask_matrix_nms``,
ScanNet's ``evaluate_semantic_instance``).

  * ``Reference``: the model. Its backbone and pooling are the plain U-Net
    and segment reductions of ``refnet``; its decoder follows the public
    code with the port's documented departures (GELU's tanh form, LayerNorm
    eps 1e-6, semantic queries first, no score or ``out_sem`` branch). Its
    parameters have the port's names, in the port's order, so that weights
    made from one seed are the same. ``scene(...)`` runs one scene free, or
    teacher-forced with the masks a run of the program used, and returns
    every prediction set's mask logits;
  * ``predict(...)``: ``pred_inst`` and ``pred_sem`` on one scene's outputs;
  * ``scannet_eval(...)``: instance AP per point (``assign_instances_for_
    scan``, ``evaluate_matches``, ``compute_averages``, as written), and
    ``semantic_eval`` mmdet3d's ``seg_eval``.

Where the port rounds to its compute dtype, the reference calls
``refnet.precision.cast`` / ``rnd``: the identity in fp32, three mantissa
bits in the correctness control. ``fp32_mode()`` turns TF32 off.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..refnet.models.decoder import FFN, LN_EPS, SelfAttentionLayer, linear
from ..refnet.models.unet import UNetBackbone
from ..refnet.ops.segment import segment_mean, segment_sum
from ..refnet.ops.sparse_conv import gather_rows
from ..refnet.precision import cast, rnd

SEG_VALID_CLASS_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)
N_SEM, N_STUFF, N_INST = 20, 2, 18
SEMANTIC_CLASSES = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door", "window", "bookshelf",
    "picture", "counter", "desk", "curtain", "refrigerator", "showercurtrain", "toilet", "sink",
    "bathtub", "otherfurniture")  # the 18 instance classes are the last 18


def fp32_mode() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class CrossAttention(nn.Module):
    """Post-norm masked multi-head cross-attention."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, src, mask):
        """x (Q, d), src (n, d), mask (Q, n) bool, True = may attend."""
        h = self.num_heads
        hd = x.shape[1] // h
        q = linear(x, self.query, None).view(-1, h, hd).transpose(0, 1)
        k = linear(src, self.key, None).view(-1, h, hd).transpose(0, 1)
        v = linear(src, self.value, None).view(-1, h, hd).transpose(0, 1)
        logits = (q @ k.transpose(1, 2)) * hd ** -0.5
        logits = logits.masked_fill(~mask[None], float("-inf"))
        p = torch.exp(logits - logits.amax(-1, keepdim=True))
        o = (rnd(p) @ v) / p.sum(-1, keepdim=True)
        z = linear(o.transpose(0, 1).reshape(x.shape), self.out, None)
        return self.norm(z + x)


class Decoder(nn.Module):
    def __init__(self, in_channels=32, num_layers=6, d_model=256, num_heads=8, hidden_dim=1024,
                 n_sem=N_SEM, n_classes=N_INST):
        super().__init__()
        self.num_layers, self.n_sem = num_layers, n_sem
        self.input_fc = nn.Linear(in_channels, d_model)
        self.input_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.query_fc1 = nn.Linear(in_channels, d_model)
        self.query_fc2 = nn.Linear(d_model, d_model)
        self.sem_query = nn.Parameter(torch.zeros(n_sem, d_model))
        self.x_mask_fc1 = nn.Linear(in_channels, d_model)
        self.x_mask_fc2 = nn.Linear(d_model, d_model)
        self.out_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cls_fc1 = nn.Linear(d_model, d_model)
        self.cls_fc2 = nn.Linear(d_model, n_classes + 1)
        for i in range(num_layers):
            self.add_module(f"cross{i}", CrossAttention(d_model, num_heads))
            self.add_module(f"attn{i}", SelfAttentionLayer(d_model, num_heads, torch.float32))
            self.add_module(f"ffn{i}", FFN(d_model, hidden_dim, "gelu", torch.float32))

    def head(self, x, mask_feats):
        """(class logits, mask logits, the product's scale: the norms of its
        operands, over which its rounding errors spread)."""
        h = self.out_norm(x)
        cls = linear(F.relu(linear(h, self.cls_fc1, None)), self.cls_fc2, None)
        a, b = cast(h), cast(mask_feats)
        return cls, a @ b.T, a.norm() * b.norm()

    def forward(self, sp, teacher=None):
        """sp (n, in) -> (class logits of the 7 sets (L, Q, C + 1), mask
        logits of every set [(Q, n)], the masks the layers used [(Q, n)],
        the last mask product's scale). teacher: the layers' masks to use
        instead of the reference's own."""
        src = F.relu(self.input_norm(linear(sp, self.input_fc, None)))
        mask_feats = linear(F.relu(linear(sp, self.x_mask_fc1, None)), self.x_mask_fc2, None)
        inst = linear(F.relu(linear(sp, self.query_fc1, None)), self.query_fc2, None)
        x = torch.cat([self.sem_query.float(), inst])
        seg = torch.ones((1, x.shape[0]), dtype=torch.int32, device=x.device)
        cls, masks, scale = self.head(x, mask_feats)
        all_cls, all_masks, used = [cls], [masks], []
        for i in range(self.num_layers):
            own = masks >= 0
            own[~own.any(1)] = True  # a row closed whole is opened whole
            mask = own if teacher is None else teacher[i]
            used.append(mask)
            x = getattr(self, f"cross{i}")(x, src, mask)
            x = getattr(self, f"attn{i}")(x[None], seg)[0]
            x = getattr(self, f"ffn{i}")(x)
            cls, masks, scale = self.head(x, mask_feats)
            all_cls.append(cls)
            all_masks.append(masks)
        return torch.stack(all_cls), all_masks, used, scale


class Reference(nn.Module):
    """Backbone + decoder with the port's parameter names and order."""

    def __init__(self, num_planes=(32, 64, 96, 128, 160), in_channels=6, **decoder):
        super().__init__()
        self.backbone = UNetBackbone(in_channels, num_planes, torch.float32)
        self.decoder = Decoder(in_channels=num_planes[0], **decoder)

    @torch.no_grad()
    def scene(self, batch, pack, num_superpoints: int, teacher=None) -> dict:
        """One scene (a collated group of one, on the device): {"valid"
        (S,) superpoint slots holding points, "counts" (S,) their points,
        "cls" (L, Q, C + 1), "masks" [(Q, n)] per set, "used" [(Q, n)],
        "mask_scale" the last mask product's ||norm(q)|| ||x_mask(sp)||}, over
        the scene's n valid slots in slot order, the semantic queries first.
        teacher: per layer the (Q, n) masks to attend with."""
        fp32_mode()
        s = num_superpoints
        flat_valid = batch.valid.reshape(-1)
        v0 = pack.capacity(0)
        pinv = torch.where(flat_valid, pack.point_inverse, v0)
        vox = segment_mean(batch.features.reshape(-1, batch.features.shape[-1]).float(), pinv, v0)
        feats = self.backbone(vox, pack, False)
        sp_ids = torch.where(flat_valid, batch.sp_ids.reshape(-1).long().clamp(0, s - 1), s)
        sp_feats = segment_mean(gather_rows(feats, pinv), sp_ids, s)
        counts = segment_sum(flat_valid.float(), sp_ids, s)
        valid = counts > 0
        cls, masks, used, scale = self.decoder(sp_feats[valid], teacher)
        return dict(valid=valid, counts=counts, cls=cls, masks=masks, used=used,
                    mask_scale=float(scale))


def mask_matrix_nms(masks, labels, scores):
    """mmdet's mask_matrix_nms, linear kernel, for (n, S) soft masks: the
    decayed scores, labels, masks and input indices, in descending order of
    the decayed scores."""
    scores, sort_inds = torch.sort(scores, descending=True, stable=True)
    masks, labels = masks[sort_inds], labels[sort_inds]
    n = len(labels)
    area = masks.sum(1)
    inter = masks @ masks.T
    area_e = area.expand(n, n)
    iou = (inter / (area_e + area_e.T - inter)).triu(diagonal=1)
    labels_e = labels.expand(n, n)
    label_matrix = (labels_e == labels_e.T).triu(diagonal=1)
    compensate, _ = (iou * label_matrix).max(0)
    compensate = compensate.expand(n, n).T
    decay = ((1 - iou * label_matrix) / (1 - compensate)).min(0)[0]
    # mmdet sorts again by the decayed scores: the order the metric matches in.
    scores, again = torch.sort(scores * decay, descending=True, stable=True)
    return scores, labels[again], masks[again], sort_inds[again]


def predict(cls, masks, counts, topk=600, sp_score_thr=0.4, npoint_thr=100, score_thr=0.0):
    """``pred_inst`` and ``pred_sem`` of one scene: cls (Q, C + 1) and masks
    (Q, n) of the last set (semantic queries first), counts (n,) points per
    superpoint. Returns (instances [(query, label, score, (n,) bool mask)]
    in score order, (n,) semantic class per superpoint)."""
    fp32_mode()
    inst_cls, inst_masks = cls[N_SEM:].float(), masks[N_SEM:].float()
    scores = F.softmax(inst_cls, dim=-1)[:, :-1]
    nc = scores.shape[1]
    scores, idx = scores.flatten().topk(min(topk, scores.numel()))
    labels, queries = idx % nc, idx // nc
    mask_pred = inst_masks[queries]
    sig = mask_pred.sigmoid()
    scores = scores * (sig * (mask_pred > 0)).sum(1) / ((mask_pred > 0).sum(1) + 1e-6)
    scores, labels, sig, order = mask_matrix_nms(sig, labels, scores)
    queries = queries[order]
    binary = sig > sp_score_thr
    npoint = (binary * counts.float()).sum(1)
    keep = (scores > score_thr) & (npoint > npoint_thr)
    inst = [(int(q), int(l), float(s), m.cpu().numpy())
            for q, l, s, m, k in zip(queries, labels, scores, binary, keep) if k]
    semantic = masks[:N_SEM].float().sigmoid().argmax(0)
    return inst, semantic.cpu().numpy()


def ground_truth(raw_semantic, raw_instance):
    """Per point: the 20-class semantic ids (20 ignore) and ScanNet's
    renamed instance ids (``rename_gt``): 1000 * label id + raw id for the
    instances of the 18 classes (label id = class + 1), 0 elsewhere."""
    lut = np.full(41, N_SEM, np.int64)
    lut[list(SEG_VALID_CLASS_IDS)] = np.arange(N_SEM)
    sem = lut[np.clip(np.asarray(raw_semantic, np.int64), 0, 40)]
    inst = np.asarray(raw_instance, np.int64)
    gt_ids = np.zeros(len(inst), np.int64)
    for i in np.unique(inst):
        if i < 0:
            continue
        sems = np.unique(sem[inst == i])
        assert len(sems) == 1, "an instance with several semantic classes"
        if N_STUFF <= sems[0] < N_SEM:
            gt_ids[inst == i] = 1000 * (sems[0] - N_STUFF + 1) + i
    return sem, gt_ids


OPTIONS = dict(overlaps=np.append(np.arange(0.5, 0.95, 0.05), 0.25), min_region_size=100)
LABEL_IDS = list(range(1, N_INST + 1))


def assign_instances_for_scan(preds, gt_ids):
    """preds: [(label id, confidence, (P,) bool mask)] of one scene."""
    gt2pred = {l: [] for l in LABEL_IDS}
    for i in np.unique(gt_ids):
        if i == 0 or i // 1000 not in LABEL_IDS:
            continue
        gt2pred[i // 1000].append(dict(instance_id=int(i), label_id=int(i // 1000),
                                       vert_count=int((gt_ids == i).sum()), matched_pred=[]))
    pred2gt = {l: [] for l in LABEL_IDS}
    bool_void = np.logical_not(np.isin(gt_ids // 1000, LABEL_IDS))
    for k, (label_id, conf, mask) in enumerate(preds):
        num = np.count_nonzero(mask)
        if num < OPTIONS["min_region_size"]:
            continue
        pred = dict(filename=k, label_id=label_id, vert_count=num, confidence=conf,
                    void_intersection=np.count_nonzero(np.logical_and(bool_void, mask)))
        matched_gt = []
        for gt in gt2pred[label_id]:
            intersection = np.count_nonzero(np.logical_and(gt_ids == gt["instance_id"], mask))
            if intersection > 0:
                gt_copy, pred_copy = dict(gt), dict(pred)
                gt_copy["intersection"] = pred_copy["intersection"] = intersection
                matched_gt.append(gt_copy)
                gt["matched_pred"].append(pred_copy)
        pred["matched_gt"] = matched_gt
        pred2gt[label_id].append(pred)
    return gt2pred, pred2gt


def evaluate_matches(matches):
    overlaps, min_size = OPTIONS["overlaps"], OPTIONS["min_region_size"]
    ap = np.zeros((len(LABEL_IDS), len(overlaps)), float)
    for oi, overlap_th in enumerate(overlaps):
        for li, label in enumerate(LABEL_IDS):
            y_true, y_score = np.empty(0), np.empty(0)
            hard_false_negatives, has_gt, has_pred = 0, False, False
            for m in matches:
                pred_visited = {p["filename"]: False for p in m["pred"][label]}
                pred_instances = m["pred"][label]
                gt_instances = [gt for gt in m["gt"][label] if gt["vert_count"] >= min_size]
                has_gt |= bool(gt_instances)
                has_pred |= bool(pred_instances)
                cur_true = np.ones(len(gt_instances))
                cur_score = np.ones(len(gt_instances)) * (-float("inf"))
                cur_match = np.zeros(len(gt_instances), dtype=bool)
                for gti, gt in enumerate(gt_instances):
                    found_match = False
                    for pred in gt["matched_pred"]:
                        if pred_visited[pred["filename"]]:
                            continue
                        overlap = float(pred["intersection"]) / (
                            gt["vert_count"] + pred["vert_count"] - pred["intersection"])
                        if overlap > overlap_th:
                            confidence = pred["confidence"]
                            if cur_match[gti]:
                                max_score = max(cur_score[gti], confidence)
                                min_score = min(cur_score[gti], confidence)
                                cur_score[gti] = max_score
                                cur_true = np.append(cur_true, 0)
                                cur_score = np.append(cur_score, min_score)
                                cur_match = np.append(cur_match, True)
                            else:
                                found_match = True
                                cur_match[gti] = True
                                cur_score[gti] = confidence
                                pred_visited[pred["filename"]] = True
                    if not found_match:
                        hard_false_negatives += 1
                cur_true, cur_score = cur_true[cur_match], cur_score[cur_match]
                for pred in pred_instances:
                    found_gt = False
                    for gt in pred["matched_gt"]:
                        overlap = float(gt["intersection"]) / (
                            gt["vert_count"] + pred["vert_count"] - gt["intersection"])
                        if overlap > overlap_th:
                            found_gt = True
                            break
                    if not found_gt:
                        num_ignore = pred["void_intersection"]
                        for gt in pred["matched_gt"]:
                            if gt["vert_count"] < min_size:
                                num_ignore += gt["intersection"]
                        if float(num_ignore) / pred["vert_count"] <= overlap_th:
                            cur_true = np.append(cur_true, 0)
                            cur_score = np.append(cur_score, pred["confidence"])
                y_true = np.append(y_true, cur_true)
                y_score = np.append(y_score, cur_score)
            if has_gt and has_pred:
                score_arg_sort = np.argsort(y_score)
                y_score_sorted = y_score[score_arg_sort]
                y_true_sorted = y_true[score_arg_sort]
                y_true_sorted_cumsum = np.cumsum(y_true_sorted)
                _, unique_indices = np.unique(y_score_sorted, return_index=True)
                num_prec_recall = len(unique_indices) + 1
                num_examples = len(y_score_sorted)
                num_true_examples = y_true_sorted_cumsum[-1] if len(y_true_sorted_cumsum) > 0 else 0
                precision = np.zeros(num_prec_recall)
                recall = np.zeros(num_prec_recall)
                y_true_sorted_cumsum = np.append(y_true_sorted_cumsum, 0)
                for idx_res, idx_scores in enumerate(unique_indices):
                    cumsum = y_true_sorted_cumsum[idx_scores - 1]
                    tp = num_true_examples - cumsum
                    fp = num_examples - idx_scores - tp
                    fn = cumsum + hard_false_negatives
                    precision[idx_res] = float(tp) / (tp + fp)
                    recall[idx_res] = float(tp) / (tp + fn)
                precision[-1], recall[-1] = 1.0, 0.0
                recall_for_conv = np.append(recall[0], recall)
                recall_for_conv = np.append(recall_for_conv, 0.0)
                step_widths = np.convolve(recall_for_conv, [-0.5, 0, 0.5], "valid")
                ap[li, oi] = np.dot(precision, step_widths)
            else:
                ap[li, oi] = 0.0 if has_gt else float("nan")
    return ap


def scannet_eval(scenes) -> dict:
    """scenes: [(preds [(label id, confidence, (P,) bool mask)], (P,) gt
    ids)]. Returns {"all_ap", "all_ap_50%", "all_ap_25%", "classes": [(ap,
    ap50, ap25)] by label}."""
    import warnings

    matches = []
    for preds, gt_ids in scenes:
        gt2pred, pred2gt = assign_instances_for_scan(preds, gt_ids)
        matches.append(dict(gt=gt2pred, pred=pred2gt))
    aps = evaluate_matches(matches)
    overlaps = OPTIONS["overlaps"]
    o50 = np.where(np.isclose(overlaps, 0.5))
    o25 = np.where(np.isclose(overlaps, 0.25))
    rest = np.where(np.logical_not(np.isclose(overlaps, 0.25)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return {"all_ap": float(np.nanmean(aps[:, rest])),
                "all_ap_50%": float(np.nanmean(aps[:, o50])),
                "all_ap_25%": float(np.nanmean(aps[:, o25])),
                "classes": [(float(np.average(aps[i, rest])), float(np.average(aps[i, o50])),
                             float(np.average(aps[i, o25]))) for i in range(len(LABEL_IDS))]}


def semantic_eval(scenes) -> dict:
    """scenes: [((P,) predicted class, (P,) ground-truth class, 20 ignore)]:
    mmdet3d's seg_eval -> {"miou", "acc", "acc_cls", "iou": [20]}."""
    import warnings

    hist = np.zeros((N_SEM, N_SEM), np.int64)
    for pred, gt in scenes:
        pred, gt = np.asarray(pred, np.int64).copy(), np.asarray(gt, np.int64).copy()
        pred[gt == N_SEM] = -1
        gt[gt == N_SEM] = -1
        k = (gt >= 0) & (gt < N_SEM)
        hist += np.bincount(N_SEM * gt[k] + pred[k], minlength=N_SEM ** 2)[:N_SEM ** 2].reshape(
            N_SEM, N_SEM)
    with warnings.catch_warnings(), np.errstate(invalid="ignore", divide="ignore"):
        warnings.simplefilter("ignore", RuntimeWarning)
        iou = np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist))
        return {"miou": float(np.nanmean(iou)), "acc": float(np.diag(hist).sum() / hist.sum()),
                "acc_cls": float(np.nanmean(np.diag(hist) / hist.sum(axis=1))),
                "iou": [float(x) for x in iou]}
