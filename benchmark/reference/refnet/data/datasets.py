"""Dataset readers for the six indoor benchmarks (the port's own copy of the
JAX package's ``data/datasets.py``).

Mirror of the reference dataset classes (unidet3d/{scannet,s3dis,multiscan,
rscan,scannetpp,arkitscenes}_dataset.py + concat_dataset.py) on top of the
v2-style info format (tools/update_infos_to_v2.py):

  info = {'metainfo': {...}, 'data_list': [entry, ...]}
  entry = {
    'lidar_points': {'lidar_path': str},        # (N, 6) float32 .bin
    'pts_instance_mask_path': str,              # (N,) int64 .bin
    'pts_semantic_mask_path': str,              # (N,) int64 .bin
    'super_pts_path': str,                      # (N,) int64 .bin
    'axis_align_matrix': (4, 4) list | None,
    'instances': [{'bbox_3d': [6 or 7 floats],  # gravity-center convention
                   'bbox_label_3d': int}, ...],
  }

Reference train-sampling semantics preserved exactly: the sampler index is
IGNORED in training — every __getitem__ draws a uniformly random scene, and
`partition` scales the nominal epoch length (s3dis_dataset.py:63-68,93-108).
"""
from __future__ import annotations

import os
import pickle
from typing import Callable, List, Sequence

import numpy as np


def load_info(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def _read_bin(path: str, dtype, cols: int | None = None):
    arr = np.fromfile(path, dtype=dtype)
    if cols is not None:
        arr = arr.reshape(-1, cols)
    return arr


class IndoorDataset:
    """One dataset split; produces pipeline-ready sample dicts."""

    def __init__(
        self,
        data_root: str,
        ann_file: str,
        dataset_idx: int,
        pipeline: Sequence[Callable] = (),
        test_mode: bool = False,
        partition: float = 1.0,
        label_mapping: dict | None = None,
        seed: int = 0,
    ):
        self.data_root = data_root
        self.dataset_idx = dataset_idx
        self.pipeline = list(pipeline)
        self.test_mode = test_mode
        self.partition = partition
        self.label_mapping = label_mapping
        self.rng = np.random.RandomState(seed)
        info = load_info(
            ann_file
            if os.path.isabs(ann_file)
            else os.path.join(data_root, ann_file)
        )
        self.metainfo = info.get("metainfo", {})
        self.data_list = info["data_list"]

    def __len__(self):
        n = len(self.data_list)
        if self.test_mode:
            return n
        return max(1, int(n * self.partition))

    def _path(self, p):
        return p if os.path.isabs(p) else os.path.join(self.data_root, p)

    def scene_size(self, idx: int) -> int:
        """Raw point count of scene `idx` WITHOUT loading it: the (N, 6)
        float32 .bin is 24 bytes/point. Upper bound on the pipeline output
        (test pipelines may subsample) — used by EvalLoader to sort scenes
        by size so groups land in the smallest capacity bucket that covers
        them (mixing one large scene into a group of small ones pads the
        whole group up)."""
        path = self._path(self.data_list[idx]["lidar_points"]["lidar_path"])
        return os.path.getsize(path) // 24

    def load_raw(self, idx: int) -> dict:
        entry = self.data_list[idx]
        pts = _read_bin(
            self._path(entry["lidar_points"]["lidar_path"]), np.float32, 6
        )
        sample = {
            "points": pts.copy(),
            "dataset_idx": self.dataset_idx,
            "scene_idx": idx,
        }
        if entry.get("pts_instance_mask_path"):
            sample["pts_instance_mask"] = _read_bin(
                self._path(entry["pts_instance_mask_path"]), np.int64
            )
        if entry.get("pts_semantic_mask_path"):
            sample["pts_semantic_mask"] = _read_bin(
                self._path(entry["pts_semantic_mask_path"]), np.int64
            )
        if entry.get("super_pts_path"):
            sp = _read_bin(self._path(entry["super_pts_path"]), np.int64)
            sample["sp_pts_mask"] = np.unique(sp, return_inverse=True)[1]
        if entry.get("axis_align_matrix") is not None:
            sample["axis_align_matrix"] = np.asarray(
                entry["axis_align_matrix"], np.float32
            )
        insts = entry.get("instances", [])
        if insts:
            boxes = np.stack(
                [np.asarray(i["bbox_3d"], np.float32) for i in insts]
            )
            labels = np.asarray(
                [i["bbox_label_3d"] for i in insts], np.int64
            )
        else:
            boxes = np.zeros((0, 6), np.float32)
            labels = np.zeros((0,), np.int64)
        if self.label_mapping is not None and len(labels):
            keep = np.asarray(
                [int(l) in self.label_mapping for l in labels], bool
            )
            boxes = boxes[keep]
            labels = np.asarray(
                [self.label_mapping[int(l)] for l in labels[keep]], np.int64
            )
        sample["gt_bboxes_3d"] = boxes
        sample["gt_labels_3d"] = labels
        return sample

    def get(self, idx: int, rng: np.random.RandomState | None = None) -> dict:
        """__getitem__ with an EXPLICIT RNG. TrainLoader threads each pass a
        per-batch RandomState derived from (seed, batch index) so the sample
        stream is reproducible regardless of the thread schedule — the
        shared `self.rng` fallback is only safe single-threaded."""
        r = self.rng if rng is None else rng
        if not self.test_mode:
            idx = r.randint(len(self.data_list))  # ref random draw
        sample = self.load_raw(idx)
        for t in self.pipeline:
            sample = t(sample, rng=r)
        return sample

    def __getitem__(self, idx: int) -> dict:
        return self.get(idx)


class ConcatDataset:
    """Heterogeneous concat (reference concat_dataset.py: skips metainfo
    equality checks)."""

    def __init__(self, datasets: List[IndoorDataset]):
        self.datasets = datasets
        self._cum = np.cumsum([len(d) for d in datasets])

    def __len__(self):
        return int(self._cum[-1]) if len(self.datasets) else 0

    def get(self, idx: int, rng: np.random.RandomState | None = None):
        d = int(np.searchsorted(self._cum, idx, side="right"))
        prev = 0 if d == 0 else int(self._cum[d - 1])
        return self.datasets[d].get(idx - prev, rng)

    def __getitem__(self, idx: int):
        return self.get(idx)
