"""Per-dataset augmentation pipelines, mirroring the reference config
(configs/unidet3d_1xb8_...arkitscenes.py:115-560). The port's own copy of
the JAX package's ``data/pipelines.py``.

Each pipeline is a list of `f(sample, rng=...)` callables. Differences per
dataset (num_points caps, rot/scale ranges, elastic probability, class
mapping flavour) follow the reference config exactly.
"""
from __future__ import annotations

from functools import partial

from . import transforms as T

VOXEL_SIZE = 0.02

# S3DIS instance classes among the 13 semantic ids (config:234).
S3DIS_CLASSES = [7, 8, 9, 10, 11]
SCANNET_NUM_CLASSES = 20
SCANNET_STUFF = [0, 1]


def train_pipeline(dataset: str, augment: bool = True):
    pipe = _train_pipeline(dataset)
    if augment:
        return pipe
    # Overfit/convergence mode: strip the random geometric transforms,
    # keep deterministic prep (alignment, class mapping, color norm) and
    # the point cap. See DatasetSpec.augment.
    random_fns = {T.random_flip, T.global_rot_scale_trans,
                  T.elastic_transform}
    return [
        f for f in pipe
        if (f.func if isinstance(f, partial) else f) not in random_fns
    ]


def _train_pipeline(dataset: str):
    if dataset == "scannet":
        from .dataset_specs import SCANNET_SEG_VALID_CLASS_IDS

        return [
            T.global_alignment,
            partial(
                T.point_seg_class_mapping,
                valid_cat_ids=SCANNET_SEG_VALID_CLASS_IDS,
            ),
            partial(T.random_flip),
            partial(
                T.global_rot_scale_trans,
                rot_range=(-3.14, 3.14),
                scale_range=(0.8, 1.2),
                trans_std=(0.1, 0.1, 0.1),
            ),
            T.normalize_color,
            partial(
                T.point_det_class_mapping_scannet,
                num_classes=SCANNET_NUM_CLASSES,
                stuff_classes=SCANNET_STUFF,
            ),
            partial(T.elastic_transform, p=0.5, voxel_size=VOXEL_SIZE),
        ]
    if dataset == "s3dis":
        return [
            partial(T.point_sample, num_points=180000),
            partial(T.random_flip),
            partial(
                T.global_rot_scale_trans,
                rot_range=(0.0, 0.0),
                scale_range=(0.9, 1.1),
                trans_std=(0.1, 0.1, 0.1),
            ),
            partial(T.point_det_class_mapping_s3dis, classes=S3DIS_CLASSES),
            T.normalize_color,
            partial(T.elastic_transform, p=-1, voxel_size=VOXEL_SIZE),
        ]
    if dataset in ("multiscan", "3rscan", "scannetpp"):
        # These datasets ship precomputed (axis-aligned) GT boxes; the
        # reference therefore disables rotation and narrows scaling
        # (config:312-314, 386-388, 461-463).
        cap = {"multiscan": 100000, "3rscan": 100000, "scannetpp": 200000}[
            dataset
        ]
        return [
            partial(T.point_sample, num_points=cap),
            partial(T.random_flip),
            partial(
                T.global_rot_scale_trans,
                rot_range=(0.0, 0.0),
                scale_range=(0.9, 1.1),
                trans_std=(0.1, 0.1, 0.1),
            ),
            T.normalize_color,
            partial(T.elastic_transform, p=-1, voxel_size=VOXEL_SIZE),
        ]
    if dataset == "arkitscenes":
        # 7-DoF yawed boxes: small rotation allowed (config:539-541).
        return [
            T.denormalize_color,
            partial(T.point_sample, num_points=100000),
            partial(T.random_flip),
            partial(
                T.global_rot_scale_trans,
                rot_range=(-0.5, 0.5),
                scale_range=(0.9, 1.1),
                trans_std=(0.1, 0.1, 0.1),
            ),
            T.normalize_color,
            partial(T.elastic_transform, p=-1, voxel_size=VOXEL_SIZE),
        ]
    raise ValueError(dataset)


# Reference test-time point caps (config:275, 348, 422, 497, 572).
# ScanNet has no test-time sampling in the reference.
TEST_NUM_POINTS = {
    "s3dis": 180000,
    "multiscan": 100000,
    "3rscan": 100000,
    "scannetpp": 200000,
    "arkitscenes": 100000,
}


def test_pipeline(dataset: str):
    pipe = []
    if dataset == "scannet":
        pipe.append(T.global_alignment)
    if dataset == "arkitscenes":
        pipe.append(T.denormalize_color)
    if dataset in TEST_NUM_POINTS:
        pipe.append(
            partial(T.point_sample, num_points=TEST_NUM_POINTS[dataset])
        )
    pipe.append(T.normalize_color)
    return pipe
