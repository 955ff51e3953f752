"""Host-side (numpy/scipy) augmentation + GT-preparation pipeline.

The port's own copy of the JAX package's ``data/transforms.py``: every
transform draws from the RandomState it is given with the same calls in the
same order, so one seed gives bit-equal samples in both packages.

Mirror of the reference per-dataset pipelines (configs/*.py:115-560 and
unidet3d/transforms_3d.py, loading.py). Samples are plain dicts:

  points: (N, 6) float32 [x, y, z, r, g, b]  (colors raw until normalize)
  sp_pts_mask: (N,) int64 superpoint ids
  pts_instance_mask / pts_semantic_mask: (N,) int64
  gt_bboxes_3d: (G, 6|7) gravity-center boxes; gt_labels_3d: (G,)
  gt_sp_masks: (G, S_actual) bool  (added by the class-mapping transforms)
  elastic_coords: (N, 3) voxel-unit coords (added by ElasticTransform)
  axis_align_matrix: (4, 4) (ScanNet)

All randomness flows through an explicit np.random.RandomState.
"""
from __future__ import annotations

import numpy as np
import scipy.interpolate
import scipy.ndimage


def global_alignment(sample, rng=None):
    """Apply the axis-align matrix (ScanNet; ref GlobalAlignment)."""
    mat = sample.get("axis_align_matrix")
    if mat is None:
        return sample
    pts = sample["points"]
    xyz1 = np.concatenate([pts[:, :3], np.ones((len(pts), 1), pts.dtype)], 1)
    sample["points"] = np.concatenate(
        [(xyz1 @ mat.T)[:, :3], pts[:, 3:]], axis=1
    ).astype(np.float32)
    return sample


def point_sample(sample, num_points: int, rng: np.random.RandomState):
    """Random sampling WITH replacement + superpoint re-compaction
    (ref transforms_3d.py:231-295 PointSample_)."""
    pts = sample["points"]
    n = len(pts)
    choices = rng.choice(n, min(num_points, n))
    sample["points"] = pts[choices]
    for key in ("pts_semantic_mask",):
        if key in sample:
            sample[key] = sample[key][choices]
    if "pts_instance_mask" in sample:
        m = sample["pts_instance_mask"][choices]
        idxs = np.unique(m)
        mapping = np.zeros(idxs.max() + 2, np.int64)
        new_idxs = np.arange(len(idxs))
        if idxs[0] == -1:
            mapping[idxs] = new_idxs - 1
        else:
            mapping[idxs] = new_idxs
        sample["pts_instance_mask"] = mapping[m]
    if "sp_pts_mask" in sample:
        sp = sample["sp_pts_mask"][choices]
        sample["sp_pts_mask"] = np.unique(sp, return_inverse=True)[1]
    return sample


def random_flip(sample, rng, p_horizontal=0.5, p_vertical=0.5):
    """BEV flips (ref RandomFlip3D; Depth convention: horizontal -> x,
    vertical -> y). Boxes (if present) flip identically."""
    pts = sample["points"]
    boxes = sample.get("gt_bboxes_3d")
    if rng.rand() < p_horizontal:
        pts[:, 0] = -pts[:, 0]
        if boxes is not None and len(boxes):
            boxes[:, 0] = -boxes[:, 0]
            if boxes.shape[1] == 7:
                boxes[:, 6] = np.pi - boxes[:, 6]
    if rng.rand() < p_vertical:
        pts[:, 1] = -pts[:, 1]
        if boxes is not None and len(boxes):
            boxes[:, 1] = -boxes[:, 1]
            if boxes.shape[1] == 7:
                boxes[:, 6] = -boxes[:, 6]
    sample["points"] = pts
    if boxes is not None:
        sample["gt_bboxes_3d"] = boxes
    return sample


def global_rot_scale_trans(
    sample,
    rng,
    rot_range=(-3.14, 3.14),
    scale_range=(0.8, 1.2),
    trans_std=(0.1, 0.1, 0.1),
):
    """Rotate around z, isotropic scale, translate (ref GlobalRotScaleTrans)."""
    pts = sample["points"]
    boxes = sample.get("gt_bboxes_3d")

    angle = rng.uniform(rot_range[0], rot_range[1])
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
    scale = rng.uniform(scale_range[0], scale_range[1])
    trans = rng.normal(scale=trans_std, size=3).astype(np.float32)

    pts[:, :3] = pts[:, :3] @ rot * scale + trans
    sample["points"] = pts
    if boxes is not None and len(boxes):
        boxes[:, :3] = boxes[:, :3] @ rot * scale + trans
        boxes[:, 3:6] *= scale
        if boxes.shape[1] == 7:
            boxes[:, 6] += angle
        sample["gt_bboxes_3d"] = boxes
    return sample


def normalize_color(sample, color_mean=(127.5, 127.5, 127.5), rng=None):
    """color = (color - mean) / 127.5 (ref loading.py:70-106)."""
    pts = sample["points"]
    pts[:, 3:6] = (pts[:, 3:6] - np.asarray(color_mean, np.float32)) / 127.5
    sample["points"] = pts
    return sample


def denormalize_color(sample, rng=None):
    """ARKitScenes colors stored in [0, 1] -> [0, 255]
    (ref loading.py:109-146)."""
    pts = sample["points"]
    pts[:, 3:6] = pts[:, 3:6] * 255.0
    sample["points"] = pts
    return sample


def elastic_transform(
    sample, rng, gran=(6, 20), mag=(40, 160), voxel_size=0.02, p=0.5
):
    """Elastic distortion in voxel units (ref transforms_3d.py:12-83).
    Always emits elastic_coords (identity when the coin flip fails)."""
    coords = sample["points"][:, :3].astype(np.float64) / voxel_size
    if rng.rand() < p:
        coords = _elastic(coords, gran[0], mag[0], rng)
        coords = _elastic(coords, gran[1], mag[1], rng)
    sample["elastic_coords"] = coords.astype(np.float32)
    return sample


def _elastic(x, gran, mag, rng):
    blurs = [
        np.ones((3, 1, 1), np.float32) / 3,
        np.ones((1, 3, 1), np.float32) / 3,
        np.ones((1, 1, 3), np.float32) / 3,
    ]
    noise_dim = np.abs(x).max(0).astype(np.int32) // gran + 3
    noise = [rng.randn(*noise_dim).astype(np.float32) for _ in range(3)]
    for blur in blurs * 2:
        noise = [
            scipy.ndimage.convolve(n, blur, mode="constant", cval=0)
            for n in noise
        ]
    ax = [np.linspace(-(b - 1) * gran, (b - 1) * gran, b) for b in noise_dim]
    interp = [
        scipy.interpolate.RegularGridInterpolator(
            ax, n, bounds_error=False, fill_value=0
        )
        for n in noise
    ]
    return x + np.stack([i(x) for i in interp], 1) * mag


def _sp_vote_masks(inst_onehot_t, sp_ids):
    """(G, N) one-hot x superpoint ids -> (G, S) vote masks (> 0.5 mean)."""
    n_sp = int(sp_ids.max()) + 1 if len(sp_ids) else 0
    g = inst_onehot_t.shape[0]
    sums = np.zeros((g, n_sp), np.float32)
    cnts = np.bincount(sp_ids, minlength=n_sp).astype(np.float32)
    for gi in range(g):
        sums[gi] = np.bincount(
            sp_ids, weights=inst_onehot_t[gi].astype(np.float32),
            minlength=n_sp,
        )
    return sums / np.maximum(cnts[None, :], 1.0) > 0.5


def point_seg_class_mapping(sample, valid_cat_ids, max_cat_id=40, rng=None):
    """mmdet3d `PointSegClassMapping` (used by the reference ScanNet train
    pipeline, config:130): raw nyu40 semantic ids -> contiguous train ids
    [0, len(valid_cat_ids)); any id not listed (incl. 0 = unannotated) maps
    to len(valid_cat_ids), the ignore index consumed by
    `point_det_class_mapping_scannet` as `num_classes`."""
    sem = sample["pts_semantic_mask"].astype(np.int64)
    n = len(valid_cat_ids)
    lut = np.full(max_cat_id + 1, n, np.int64)
    for i, c in enumerate(valid_cat_ids):
        lut[c] = i
    sample["pts_semantic_mask"] = lut[np.clip(sem, 0, max_cat_id)]
    return sample


def point_det_class_mapping_scannet(sample, num_classes, stuff_classes, rng=None):
    """ScanNet GT markup (ref transforms_3d.py:148-228): drop stuff/ignore
    instances, compact ids, build per-superpoint instance vote masks and
    labels (semantic - n_stuff)."""
    inst = sample["pts_instance_mask"].copy()
    sem = sample["pts_semantic_mask"]
    inst[sem == num_classes] = -1
    for sc in stuff_classes:
        inst[sem == sc] = -1

    idxs = np.unique(inst)
    mapping = np.zeros(idxs.max() + 2, np.int64)
    new_idxs = np.arange(len(idxs))
    if idxs[0] == -1:
        mapping[idxs] = new_idxs - 1
        n_inst = len(idxs) - 1
    else:
        mapping[idxs] = new_idxs
        n_inst = len(idxs)
    inst = mapping[inst]
    sample["pts_instance_mask"] = inst

    sp = sample["sp_pts_mask"].astype(np.int64)
    if n_inst > 0:
        onehot = np.zeros((n_inst, len(inst)), bool)
        sel = inst >= 0
        onehot[inst[sel], np.nonzero(sel)[0]] = True
        sp_masks = _sp_vote_masks(onehot, sp)
        labels = np.zeros(n_inst, np.int64)
        for gi in range(n_inst):
            labels[gi] = sem[inst == gi][0] - len(stuff_classes)
    else:
        sp_masks = np.zeros((0, int(sp.max()) + 1 if len(sp) else 0), bool)
        labels = np.zeros(0, np.int64)

    sample["gt_labels_3d"] = labels
    sample["gt_sp_masks"] = sp_masks
    return sample


def point_det_class_mapping_s3dis(sample, classes, rng=None):
    """S3DIS GT markup (ref transforms_3d.py:86-145): keep instances whose
    semantic class is in `classes`, remap labels to [0, len(classes))."""
    inst = sample["pts_instance_mask"].astype(np.int64).copy()
    sem = sample["pts_semantic_mask"].astype(np.int64)
    if len(np.unique(inst)) and np.unique(inst)[0] == 1:
        inst -= 1

    idxs = np.unique(inst)
    labels = np.array([sem[inst == i][0] for i in idxs], np.int64)
    keep = np.isin(labels, np.asarray(classes))
    kept_ids = idxs[keep]
    kept_labels = labels[keep]

    n_kept = len(kept_ids)
    onehot = np.zeros((n_kept, len(inst)), bool)
    for gi, iid in enumerate(kept_ids):
        onehot[gi] = inst == iid
    sp = sample["sp_pts_mask"].astype(np.int64)
    sp_masks = (
        _sp_vote_masks(onehot, sp)
        if n_kept
        else np.zeros((0, int(sp.max()) + 1 if len(sp) else 0), bool)
    )

    mapping = np.zeros(max(classes) + 1, np.int64)
    for j, cid in enumerate(classes):
        mapping[cid] = j
    new_labels = mapping[kept_labels]

    # Point instance ids re-pointed at kept instances (ref :139-140).
    new_inst = np.full(len(inst), -1, np.int64)
    for gi, iid in enumerate(kept_ids):
        new_inst[inst == iid] = gi

    sample["gt_labels_3d"] = new_labels
    sample["gt_sp_masks"] = sp_masks
    sample["pts_instance_mask"] = new_inst
    return sample
