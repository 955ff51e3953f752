"""The port's transforms and pipelines (``unidet3d_tpu_torch/data/transforms.py``,
``data/pipelines.py``) against the JAX package's copies: every transform, and
the train and test pipelines of all six datasets, give bit-equal samples from
one RandomState seed, and leave the RandomState in the same state (the same
draws in the same order)."""
import copy
import functools

import numpy as np
import pytest

from unidet3d_tpu.data import pipelines as jax_pipelines
from unidet3d_tpu.data import transforms as JT
from unidet3d_tpu_torch.data import pipelines
from unidet3d_tpu_torch.data import transforms as T

DATASETS = ("scannet", "s3dis", "multiscan", "3rscan", "scannetpp", "arkitscenes")


def make_sample(dataset="scannet", n=3000, seed=0):
    """A raw sample as IndoorDataset.load_raw gives it: colors in [0, 255]
    (ARKitScenes in [0, 1]), compact superpoints, instance ids with -1
    background, semantic ids as the dataset's files store them (ScanNet raw
    nyu40 ids, S3DIS its 13 classes), boxes (with a yaw for ARKitScenes) and
    an axis-align matrix for ScanNet."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((n, 6), np.float32)
    pts[:, :3] = rng.rand(n, 3) * [6.0, 5.0, 2.5]
    pts[:, 3:] = rng.randint(0, 256, (n, 3))
    if dataset == "arkitscenes":
        pts[:, 3:] /= 255.0
    inst = rng.randint(-1, 6, n).astype(np.int64)
    if dataset == "s3dis":
        sem = np.asarray([7, 8, 9, 3, 10, 11])[np.maximum(inst, 0)]
        sem = np.where(inst >= 0, sem, rng.randint(0, 3, n))
    else:
        sem = np.where(inst >= 0, inst + 3, rng.randint(1, 3, n))
    sp = rng.randint(0, 40, n)
    sample = {
        "points": pts,
        "dataset_idx": DATASETS.index(dataset),
        "scene_idx": 0,
        "pts_instance_mask": inst,
        "pts_semantic_mask": sem.astype(np.int64),
        "sp_pts_mask": np.unique(sp, return_inverse=True)[1],
        "gt_bboxes_3d": np.concatenate(
            [rng.rand(6, 3) * 4, rng.rand(6, 3) + 0.2]
            + ([rng.uniform(-np.pi, np.pi, (6, 1))] if dataset == "arkitscenes" else []),
            1).astype(np.float32),
        "gt_labels_3d": rng.randint(0, 10, 6).astype(np.int64),
    }
    if dataset == "scannet":
        c, s = np.cos(0.3), np.sin(0.3)
        sample["axis_align_matrix"] = np.array(
            [[c, -s, 0, 0.5], [s, c, 0, -0.2], [0, 0, 1, 0.1], [0, 0, 0, 1]], np.float32)
    return sample


def assert_samples_equal(mine, ref):
    assert mine.keys() == ref.keys()
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert mine[key].dtype == value.dtype, key
            np.testing.assert_array_equal(mine[key], value, err_msg=key)
        else:
            assert mine[key] == value, key


def run_both(mine_fn, ref_fn, sample, seed=7):
    """Both transforms on copies of `sample` from RandomState(seed): the
    samples and the RandomStates' states afterwards."""
    rng_mine, rng_ref = np.random.RandomState(seed), np.random.RandomState(seed)
    mine = mine_fn(copy.deepcopy(sample), rng=rng_mine)
    ref = ref_fn(copy.deepcopy(sample), rng=rng_ref)
    assert_samples_equal(mine, ref)
    state_mine, state_ref = rng_mine.get_state(), rng_ref.get_state()
    np.testing.assert_array_equal(state_mine[1], state_ref[1])
    assert state_mine[2:] == state_ref[2:]
    return mine


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name, kwargs, dataset", [
    ("global_alignment", {}, "scannet"),
    ("point_sample", {"num_points": 2000}, "multiscan"),
    ("point_sample", {"num_points": 5000}, "arkitscenes"),
    ("random_flip", {}, "multiscan"),
    ("random_flip", {}, "arkitscenes"),
    ("global_rot_scale_trans", {}, "scannet"),
    ("global_rot_scale_trans", {"rot_range": (-0.5, 0.5), "scale_range": (0.9, 1.1)},
     "arkitscenes"),
    ("normalize_color", {}, "scannet"),
    ("denormalize_color", {}, "arkitscenes"),
    ("elastic_transform", {"p": 1.0}, "scannet"),
    ("elastic_transform", {"p": 0.5}, "scannet"),
    ("elastic_transform", {"p": -1}, "s3dis"),
    ("point_seg_class_mapping", {"valid_cat_ids": (1, 2, 3, 4, 5, 6, 7, 8)}, "scannet"),
    ("point_det_class_mapping_scannet", {"num_classes": 20, "stuff_classes": [0, 1]},
     "scannet"),
    ("point_det_class_mapping_s3dis", {"classes": [7, 8, 9, 10, 11]}, "s3dis"),
])
def test_transform_matches_jax(name, kwargs, dataset, seed):
    sample = make_sample(dataset, seed=seed)
    run_both(functools.partial(getattr(T, name), **kwargs),
             functools.partial(getattr(JT, name), **kwargs), sample, seed=seed + 10)


def test_det_class_mapping_scannet_without_instances_matches_jax():
    sample = make_sample("scannet")
    sample["pts_semantic_mask"][:] = 1  # wall only: every instance is stuff
    out = run_both(functools.partial(T.point_det_class_mapping_scannet, num_classes=20,
                                     stuff_classes=[0, 1]),
                   functools.partial(JT.point_det_class_mapping_scannet, num_classes=20,
                                     stuff_classes=[0, 1]), sample)
    assert out["gt_sp_masks"].shape[0] == 0


def _stages(pipe):
    """(function name, keywords) of each stage."""
    return [(getattr(f, "func", f).__name__, dict(getattr(f, "keywords", None) or {}))
            for f in pipe]


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("dataset", DATASETS)
def test_train_pipeline_matches_jax(dataset, augment):
    pipe = pipelines.train_pipeline(dataset, augment=augment)
    ref = jax_pipelines.train_pipeline(dataset, augment=augment)
    assert _stages(pipe) == _stages(ref)
    sample = make_sample(dataset, seed=DATASETS.index(dataset))
    for seed in range(3):

        def apply(stages, s, rng):
            for t in stages:
                s = t(s, rng=rng)
            return s

        run_both(functools.partial(apply, pipe), functools.partial(apply, ref), sample,
                 seed=seed)


@pytest.mark.parametrize("dataset", DATASETS)
def test_test_pipeline_matches_jax(dataset):
    pipe = pipelines.test_pipeline(dataset)
    ref = jax_pipelines.test_pipeline(dataset)
    assert _stages(pipe) == _stages(ref)
    assert pipelines.TEST_NUM_POINTS == jax_pipelines.TEST_NUM_POINTS

    def apply(stages, s, rng):
        for t in stages:
            s = t(s, rng=rng)
        return s

    run_both(functools.partial(apply, pipe), functools.partial(apply, ref),
             make_sample(dataset, seed=5), seed=5)
