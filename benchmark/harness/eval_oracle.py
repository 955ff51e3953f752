"""The comparison that decides ``correct`` in an eval cell.

After the window, with the program's state freed, the reference (fp32,
plain PyTorch, ``benchmark/reference/refnet``) judges what the first window
pass produced:

  * input_mismatch: each sampled scene's points, as the program's batch
    held them, against the reference's own test pipeline over the raw scene
    file: rows that differ. Where the test pipeline samples points
    (``point_sample``, which draws from the dataset's RandomState in the
    order the loader's threads reach it), the reference takes the program's
    choice of raw rows, found by matching each point to its raw row; a
    point with no raw row counts as a mismatch. Then the scene is the
    reference's from the raw file on.
  * fwd_logits_gap, fwd_boxes_gap: per sampled scene, the reference's
    forward (one scene at a time, the configuration's capacities) against
    the program's last-layer class logits and boxes over the valid queries:
    |program - reference| / |reference| in norm (a yaw modulo pi), the
    worst scene.
  * post_mismatch: the reference's post-processing (``predict_scene``:
    top-k, NMS, rotated for ARKitScenes, superpoint trimming) of the
    program's forward outputs against the program's detections: detection
    slots that differ (keep flag, label, or score / box beyond 1e-5 of
    their scale), over the sampled scenes.
  * map_gap: the reference's metric over the program's detections of the
    whole pass and the reference's own ground truth, against the program's
    mAP: the largest difference of any reported number.

Printed, not compared (no limit has been read for them yet): per sampled
scene, the reference's whole chain (its own forward, then its
``predict_scene``) against the program's detections: the largest gap of
the kept scores, each side's sorted from the top (`chain_score_gap`), and
the largest difference in the number kept (`chain_kept_gap`).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import counts, scenes
from .gaps import forward_gaps

NUMBERS = ("input_mismatch", "fwd_logits_gap", "fwd_boxes_gap", "post_mismatch", "map_gap")
SCORE_TOL = BOX_TOL = 1e-5


@dataclasses.dataclass
class Checked:
    kept: dict  # forward index in the pass -> the sampled group's tensors
    sampled: list  # forward indices of the sampled groups
    detections: list  # per scene of the pass: (dataset index, boxes, labels, scores, valid)
    results: dict  # the program's mAP dict of the pass


def entries_of(workload: dict) -> dict:
    """{dataset: info-file entries as indices of its distinct scene files}:
    scenes[name] entries cycling over files[name] files."""
    return {name: [i % workload["files"][name] for i in range(n)]
            for name, n in workload["scenes"].items()}


def sample_groups(seed: int, order, groups: dict, per_dataset: int) -> list:
    """Forward indices (in the pass) of the checked groups: each dataset's
    first group (its largest scenes) and per_dataset - 1 more drawn from
    the seed."""
    out, offset = [], 0
    for k, name in enumerate(order):
        g = groups[name]
        rng = np.random.RandomState(scenes.scene_seed(seed, 77, k))
        rest = rng.choice(np.arange(1, g), min(per_dataset - 1, g - 1), replace=False) if g > 1 else []
        out += [offset] + [offset + int(x) for x in sorted(rest)]
        offset += g
    return out


def group_ends(drains: list, per_dataset: list, group: int) -> list:
    """Each group's drain time, its last scene's, datasets in order."""
    ends, at = [], 0
    for n in per_dataset:
        for lo in range(0, n, group):
            ends.append(drains[at + min(lo + group, n) - 1])
        at += n
    return ends


def traced_shapes(shapes: list) -> list:
    """The traced forwards' (BatchShape, slots), read back from the card."""
    out = []
    for s in shapes:
        levels = tuple(counts.LevelShape(c, int(n), int(p))
                       for c, n, p in zip(s["capacity"], s["n_valid"], s["pairs"]))
        out.append((counts.BatchShape(levels, tuple(int(q) for q in s["queries"].tolist())),
                    s["slots"]))
    return out


class Choices:
    """Stands in for the RandomState that ``point_sample`` draws from: it
    returns the program's choice of raw rows."""

    def __init__(self, choices):
        self.choices = choices

    def choice(self, n, k):
        assert k == len(self.choices), (k, len(self.choices))
        return self.choices


def match_rows(raw_xyz: np.ndarray, xyz: np.ndarray) -> np.ndarray:
    """Index of each row of xyz in raw_xyz (bit for bit), -1 where none."""
    where = {row.tobytes(): i for i, row in enumerate(np.ascontiguousarray(raw_xyz))}
    return np.asarray([where.get(row.tobytes(), -1) for row in np.ascontiguousarray(xyz)])


def scene_order(root: str, ann: str, n_entries: int, pkg) -> np.ndarray:
    """The eval loader's scene order: by raw size, largest first, stable."""
    ds = pkg.IndoorDataset(root, ann, 0, test_mode=True)
    sizes = np.asarray([os.path.getsize(ds._path(e["lidar_points"]["lidar_path"])) // 24
                        for e in ds.data_list[:n_entries]])
    return np.argsort(-sizes, kind="stable")


def reference_sample(pkg, name: str, root: str, ann: str, k: int, xyz: np.ndarray):
    """Scene k through the reference's test pipeline, taking the program's
    sampled rows where the pipeline samples. Returns (sample, mismatched
    rows)."""
    from ..reference.refnet.data import transforms as T
    from .data import dataset_index

    ds = pkg.IndoorDataset(root, ann, dataset_index(name), pipeline=pkg.test_pipeline(name),
                           test_mode=True, label_mapping=pkg.mappings.get(name))
    sample = ds.load_raw(k)
    bad = 0
    for t in ds.pipeline:
        if getattr(t, "func", None) is T.point_sample:
            idx = match_rows(sample["points"][:, :3], xyz)
            bad += int((idx < 0).sum())
            sample = t(sample, rng=Choices(np.maximum(idx, 0)))
        else:
            sample = t(sample, rng=None)
    if len(sample["points"]) != len(xyz):
        return sample, max(len(xyz), len(sample["points"]))
    bad += int((sample["points"][:, :3] != xyz).any(1).sum()) if not bad else 0
    return sample, bad


def pass_layout(exp, roots: dict, entries: dict, pkg):
    """([(dataset, group)] by forward index in a pass, {(dataset, position in
    the pass's order): info entry})."""
    from .data import VAL_ANN

    bs = exp.eval_batch_size
    order = [s.name for s in exp.datasets]
    groups = [(name, g) for name in order for g in range(-(-len(entries[name]) // bs))]
    scene_of = {}
    for name in order:
        for pos, k in enumerate(scene_order(roots[name], VAL_ANN, len(entries[name]), pkg)):
            scene_of[(name, pos)] = int(k)
    return groups, scene_of


def judge(ctx, cfg, exp, roots: dict, entries: dict, checked: Checked) -> dict:
    """{number: reading} (see the module's docstring)."""
    from ..reference.refnet.core.class_table import build_class_table
    from ..reference.refnet.core.config import DATASETS_CLASSES
    from ..reference.refnet.models.detector import UniDet3D
    from ..reference.refnet.models.postprocess import predict_scene
    from ..reference.refnet.train.metric import IndoorMetric
    from .data import VAL_ANN, dataset_index, reference_data
    from .training import ref_config
    from .weights import init_from_seed_

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pkg = reference_data()
    rcfg = ref_config(cfg, compute_dtype="float32")
    model = init_from_seed_(UniDet3D(rcfg, build_class_table(DATASETS_CLASSES), device=ctx.device),
                            ctx.seed)
    model.eval()
    order = [s.name for s in exp.datasets]
    bs = exp.eval_batch_size
    groups, scene_of = pass_layout(exp, roots, entries, pkg)
    first_det = {}  # index of each dataset's first scene in the pass's detections
    at = 0
    for name in order:
        first_det[name] = at
        at += len(entries[name])

    found = dict(input_mismatch=0, fwd_logits_gap=0.0, fwd_boxes_gap=0.0, post_mismatch=0,
                 chain_score_gap=0.0, chain_kept_gap=0)
    for f in checked.sampled:
        name, g = groups[f]
        didx = dataset_index(name)
        kept = checked.kept.get(f)
        if kept is None:  # the forward never ran: every reading fails
            return dict(found, input_mismatch=float("inf"), map_gap=float("inf"))
        n_real = min(bs, len(entries[name]) - g * bs)
        q_b = kept["logits"].shape[1]
        bcfg = ref_config(cfg, compute_dtype="float32", max_points=kept["points"].shape[1],
                          max_superpoints=q_b)
        for i in range(n_real):
            pos = g * bs + i
            valid = kept["valid"][i].cpu().numpy()
            xyz = kept["points"][i].cpu().numpy()[valid]
            sample, bad = reference_sample(pkg, name, roots[name], VAL_ANN,
                                           scene_of[(name, pos)], xyz)
            found["input_mismatch"] += bad
            batch, _, pack = pkg.collate([sample], rcfg)
            b, p = pkg.to_device(batch, pack, ctx.device)
            with torch.no_grad():
                out, aux = model(b, p)
            qv = kept["query_valid"][i]
            ref_qv = aux.query_valid[0, :q_b]
            if not torch.equal(qv, ref_qv) or bool(aux.query_valid[0, q_b:].any()):
                found["input_mismatch"] += 1
            lg, bg = forward_gaps(kept["logits"][i], kept["boxes"][i],
                                  out.cls_logits[-1][0, :q_b], out.boxes[-1][0, :q_b], qv)
            found["fwd_logits_gap"] = max(found["fwd_logits_gap"], lg)
            found["fwd_boxes_gap"] = max(found["fwd_boxes_gap"], bg)
            with torch.no_grad():
                det = predict_scene(bcfg, didx, kept["logits"][i].float(), kept["boxes"][i].float(),
                                    qv, kept["points"][i], kept["valid"][i], kept["sp_ids"][i])
            mine = checked.detections[first_det[name] + pos]
            found["post_mismatch"] += detections_differ(mine[1:], [x.cpu().numpy() for x in det])
            with torch.no_grad():
                chain = predict_scene(bcfg, didx, out.cls_logits[-1][0, :q_b], out.boxes[-1][0, :q_b],
                                      ref_qv, b.points[0], b.valid[0], b.sp_ids[0])
            score_gap, kept_gap = kept_score_gap(mine[3], mine[4], chain[2].cpu().numpy(),
                                                 chain[3].cpu().numpy())
            found["chain_score_gap"] = max(found["chain_score_gap"], score_gap)
            found["chain_kept_gap"] = max(found["chain_kept_gap"], kept_gap)
            del out, aux, b, p
    del model
    found["map_gap"] = map_gap(checked, order, entries, roots, pkg, rcfg, IndoorMetric,
                               DATASETS_CLASSES)
    return found


def detections_differ(mine, ref) -> int:
    """Detection slots that differ: keep flag, label, or (kept) score and box
    beyond SCORE_TOL / BOX_TOL of their scale."""
    boxes, labels, scores, valid = (np.asarray(x) for x in mine)
    rboxes, rlabels, rscores, rvalid = (np.asarray(x) for x in ref)
    valid, rvalid = valid.astype(bool), rvalid.astype(bool)
    differ = (valid != rvalid) | (labels != rlabels)
    differ |= np.abs(scores - rscores) > SCORE_TOL * np.maximum(1.0, np.abs(rscores))
    differ |= (np.abs(boxes - rboxes) > BOX_TOL * np.maximum(1.0, np.abs(rboxes))).any(-1)
    return int((differ & (valid | rvalid)).sum())


def kept_score_gap(scores, valid, ref_scores, ref_valid) -> tuple:
    """(largest gap of the kept scores, each side's sorted from the top, the
    shorter side padded with zeros; difference in the number kept)."""
    a = np.sort(np.asarray(scores)[np.asarray(valid, bool)])[::-1]
    b = np.sort(np.asarray(ref_scores)[np.asarray(ref_valid, bool)])[::-1]
    n = max(len(a), len(b))
    a, b = np.pad(a, (0, n - len(a))), np.pad(b, (0, n - len(b)))
    return float(np.abs(a - b).max()) if n else 0.0, abs(int(valid.sum()) - int(ref_valid.sum()))


def map_gap(checked, order, entries, roots, pkg, rcfg, metric_cls, classes) -> float:
    """The reference metric over the program's detections of the pass and the
    reference's ground truth, against the program's mAP dict."""
    from ..reference.refnet.data import transforms as T
    from .data import VAL_ANN, dataset_index

    metric = metric_cls(rcfg, classes)
    gt_cache = {}
    at = 0
    for name in order:
        didx = dataset_index(name)
        ds = pkg.IndoorDataset(roots[name], VAL_ANN, didx, pipeline=pkg.test_pipeline(name),
                               test_mode=True, label_mapping=pkg.mappings.get(name))
        # The ground truth through the test pipeline; point sampling moves no box.
        steps = [t for t in ds.pipeline if getattr(t, "func", None) is not T.point_sample]
        pos_to_k = scene_order(roots[name], VAL_ANN, len(entries[name]), pkg)
        for pos, k in enumerate(pos_to_k):
            file_i = entries[name][int(k)]
            if (name, file_i) not in gt_cache:
                raw = ds.load_raw(int(k))
                for t in steps:
                    raw = t(raw, rng=None)
                gt_boxes = raw["gt_bboxes_3d"]
                if gt_boxes.shape[1] == 6:
                    gt_boxes = np.concatenate([gt_boxes, np.zeros((len(gt_boxes), 1),
                                                                  np.float32)], 1)
                gt_cache[(name, file_i)] = (gt_boxes, raw["gt_labels_3d"])
            d = checked.detections[at + pos]
            if d[0] != didx:
                return float("inf")
            metric.process(didx, d[1], d[2], d[3], d[4], *gt_cache[(name, file_i)])
        at += len(entries[name])
    if at != len(checked.detections):
        return float("inf")
    ref = metric.compute(logger=None)
    gap = 0.0
    for name, res in ref.items():
        mine = checked.results.get(name, {})
        for key, val in res.items():
            if isinstance(val, (int, float, np.floating)):
                other = mine.get(key)
                if other is None:
                    return float("inf")
                gap = max(gap, abs(float(val) - float(other)))
    return gap


def control_gaps(ctx, cfg, exp, roots: dict, entries: dict, sampled: list, bits: int) -> dict:
    """The correctness control: the reference rounding to `bits` bits of
    mantissa where the program rounds to bf16, in the program's place, on
    the sampled groups' scenes (points sampled by the dataset's own
    RandomState), against the fp32 reference: fwd_logits_gap and
    fwd_boxes_gap as the program's are read."""
    from ..reference.refnet import precision
    from ..reference.refnet.core.class_table import build_class_table
    from ..reference.refnet.core.config import DATASETS_CLASSES
    from ..reference.refnet.models.detector import UniDet3D
    from .data import VAL_ANN, dataset_index, reference_data
    from .training import ref_config
    from .weights import init_from_seed_

    torch.backends.cuda.matmul.allow_tf32 = False
    pkg = reference_data()
    rcfg = ref_config(cfg, compute_dtype="float32")
    model = init_from_seed_(UniDet3D(rcfg, build_class_table(DATASETS_CLASSES), device=ctx.device),
                            ctx.seed).eval()
    groups, scene_of = pass_layout(exp, roots, entries, pkg)
    bs = exp.eval_batch_size
    found = dict(fwd_logits_gap=0.0, fwd_boxes_gap=0.0)
    for f in sampled:
        name, g = groups[f]
        ds = pkg.IndoorDataset(roots[name], VAL_ANN, dataset_index(name),
                               pipeline=pkg.test_pipeline(name), test_mode=True,
                               label_mapping=pkg.mappings.get(name))
        for i in range(min(bs, len(entries[name]) - g * bs)):
            batch, _, pack = pkg.collate([ds[scene_of[(name, g * bs + i)]]], rcfg)
            b, p = pkg.to_device(batch, pack, ctx.device)
            outs = []
            for m in (None, bits):
                precision.MANTISSA_BITS = m
                try:
                    with torch.no_grad():
                        outs.append(model(b, p))
                finally:
                    precision.MANTISSA_BITS = None
            (ref, aux), (low, _) = outs
            lg, bg = forward_gaps(low.cls_logits[-1][0], low.boxes[-1][0], ref.cls_logits[-1][0],
                                  ref.boxes[-1][0], aux.query_valid[0])
            found["fwd_logits_gap"] = max(found["fwd_logits_gap"], lg)
            found["fwd_boxes_gap"] = max(found["fwd_boxes_gap"], bg)
    return found
