"""Offline data preparation: raw scenes -> .bin files + info pkls.

The port's own copy of the JAX package's ``tools/create_data.py``, the
counterpart of the reference's tools/create_data.py + indoor_converter.py +
per-dataset prep scripts under data/: per-scene export of points / semantic /
instance masks / superpoints, axis-align matrices and GT boxes, written in
the info format that ``data/datasets.py::IndoorDataset`` reads, on a thread
pool like the reference's (tools/scannet_data_utils.py).

Two entry modes:
  * `scannet`: full raw-ScanNet export (mesh + aggregation/segs jsons),
    superpoints via the native segmentator.
  * `generic`: scenes already exported as .npy arrays
    (<scene>_point.npy (N,6), _sem_label.npy, _ins_label.npy, [_sp.npy],
     [_bbox.npy (G,7|8: box + label)]) — the format the reference's
    multiscan/3rscan/scannetpp preprocess scripts emit.

Usage:
  python -m unidet3d_tpu_torch.tools.create_data {scannet,generic} \
      --raw-dir DIR --out-root DIR --scenes-file names.txt \
      [--out-name infos_train.pkl] [--label-map-file labels.tsv] [--workers 8]
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def write_scene(
    out_root: str,
    name: str,
    points: np.ndarray,
    sem: np.ndarray | None,
    inst: np.ndarray | None,
    superpoints: np.ndarray | None,
    boxes: np.ndarray | None = None,
    labels: np.ndarray | None = None,
    axis_align: np.ndarray | None = None,
) -> dict:
    """Write one scene's bins; return its info entry."""
    for sub in ("points", "semantic_mask", "instance_mask", "super_points"):
        os.makedirs(os.path.join(out_root, sub), exist_ok=True)
    points.astype(np.float32).tofile(
        os.path.join(out_root, "points", f"{name}.bin")
    )
    entry = {
        "lidar_points": {
            "lidar_path": f"points/{name}.bin",
            "num_pts_feats": points.shape[1],
        },
        "instances": [],
    }
    if sem is not None:
        sem.astype(np.int64).tofile(
            os.path.join(out_root, "semantic_mask", f"{name}.bin")
        )
        entry["pts_semantic_mask_path"] = f"semantic_mask/{name}.bin"
    if inst is not None:
        inst.astype(np.int64).tofile(
            os.path.join(out_root, "instance_mask", f"{name}.bin")
        )
        entry["pts_instance_mask_path"] = f"instance_mask/{name}.bin"
    if superpoints is not None:
        superpoints.astype(np.int64).tofile(
            os.path.join(out_root, "super_points", f"{name}.bin")
        )
        entry["super_pts_path"] = f"super_points/{name}.bin"
    if axis_align is not None:
        entry["axis_align_matrix"] = np.asarray(axis_align).tolist()
    if boxes is not None and len(boxes):
        labels = labels if labels is not None else np.zeros(len(boxes), int)
        entry["instances"] = [
            {"bbox_3d": list(map(float, b)), "bbox_label_3d": int(l)}
            for b, l in zip(boxes, labels)
        ]
    return entry


def write_infos(entries, out_root, filename, metainfo=None):
    info = {"metainfo": metainfo or {}, "data_list": entries}
    path = os.path.join(out_root, filename)
    with open(path, "wb") as f:
        pickle.dump(info, f)
    return path


# ---------------------------------------------------------------------------
# ScanNet raw export (ref data/scannet/load_scannet_data.py,
# scannet_utils.py, batch_load_scannet_data.py, tools/scannet_data_utils.py).
# ---------------------------------------------------------------------------


def read_label_mapping(tsv_path, label_from="raw_category",
                       label_to="nyu40id"):
    """Parse scannetv2-labels.combined.tsv: raw category string -> nyu40 id
    (ref scannet_utils.py:33-44). The tsv ships with every ScanNet download."""
    import csv

    mapping = {}
    with open(tsv_path) as f:
        for row in csv.DictReader(f, delimiter="\t"):
            mapping[row[label_from]] = int(row[label_to])
    if not mapping:
        raise ValueError(f"empty label mapping from {tsv_path}")
    return mapping


def instance_boxes(xyz, inst, inst_to_nyu40, keep_cat_ids):
    """Per-instance axis-aligned boxes (ref load_scannet_data.py:56-71 +
    batch_load_scannet_data.py OBJ_CLASS_IDS filter): geometric-center
    (cx cy cz dx dy dz) plus the nyu40 label mapped to its position in
    `keep_cat_ids`; instances with other labels are dropped."""
    cat2label = {int(c): i for i, c in enumerate(keep_cat_ids)}
    boxes, labels = [], []
    for obj_id, nyu in sorted(inst_to_nyu40.items()):
        if int(nyu) not in cat2label:
            continue
        pc = xyz[inst == obj_id]
        if len(pc) == 0:
            continue
        mn, mx = pc.min(0), pc.max(0)
        boxes.append(np.concatenate([(mn + mx) / 2.0, mx - mn]))
        labels.append(cat2label[int(nyu)])
    if not boxes:
        return np.zeros((0, 6), np.float32), np.zeros((0,), np.int64)
    return (np.stack(boxes).astype(np.float32),
            np.asarray(labels, np.int64))


def export_scannet_scene(scans_dir: str, scene: str, label_map: dict):
    """Read one raw ScanNet scene -> (points, sem, inst, superpoints, boxes,
    labels, axis_align).

    Reference semantics (load_scannet_data.py:74-171): semantic mask carries
    RAW nyu40 ids (0 = unannotated) — the train pipeline's
    point_seg_class_mapping converts them; instance ids are 1-indexed with
    0 = unannotated; GT boxes are computed from axis-ALIGNED vertices and
    filtered + remapped to the 18 detection classes
    (batch_load_scannet_data.py:25-26, scannet_data_utils.py:101-110).
    """
    from .ply import mesh_points_colors, read_ply
    from ..data.dataset_specs import SCANNET_DET_CAT_IDS
    from ..native import segmentator

    d = os.path.join(scans_dir, scene)
    vdata, faces = read_ply(os.path.join(d, f"{scene}_vh_clean_2.ply"))
    points = mesh_points_colors(vdata)

    # Axis-align matrix from the meta txt.
    axis_align = np.eye(4, dtype=np.float32)
    meta = os.path.join(d, f"{scene}.txt")
    if os.path.exists(meta):
        for line in open(meta):
            if line.startswith("axisAlignment"):
                vals = [float(v) for v in line.split("=")[1].split()]
                axis_align = np.asarray(vals, np.float32).reshape(4, 4)

    # Superpoints via native segmentator (ref batch_load_scannet_data.py:18).
    sp = segmentator.segment_mesh(points[:, :3], faces)

    # Instance/semantic from aggregation + segs jsons.
    n = len(points)
    sem = np.zeros(n, np.int64)  # 0 = unannotated (raw nyu40 space)
    inst = np.zeros(n, np.int64)  # 0 = unannotated, objects 1-indexed
    inst_to_nyu40 = {}
    agg_path = os.path.join(d, f"{scene}.aggregation.json")
    segs_path = os.path.join(d, f"{scene}_vh_clean_2.0.010000.segs.json")
    if os.path.exists(agg_path) and os.path.exists(segs_path):
        seg_ids = np.asarray(
            json.load(open(segs_path))["segIndices"], np.int64
        )
        agg = json.load(open(agg_path))
        seg_to_verts = {}
        for i, s in enumerate(seg_ids):
            seg_to_verts.setdefault(int(s), []).append(i)
        for obj in agg["segGroups"]:
            verts = [
                v for s in obj["segments"] for v in seg_to_verts.get(s, [])
            ]
            obj_id = obj["objectId"] + 1  # 1-indexed like the reference
            nyu = label_map[obj["label"]]
            inst[verts] = obj_id
            sem[verts] = nyu
            inst_to_nyu40.setdefault(obj_id, nyu)

    # GT boxes in the axis-aligned frame (eval applies global_alignment to
    # points, so boxes must live in the aligned frame too).
    ones = np.concatenate([points[:, :3], np.ones((n, 1), np.float32)], 1)
    aligned_xyz = (ones @ axis_align.T)[:, :3]
    boxes, labels = instance_boxes(
        aligned_xyz, inst, inst_to_nyu40, SCANNET_DET_CAT_IDS
    )
    return points, sem, inst, sp, boxes, labels, axis_align


# ---------------------------------------------------------------------------
# Generic npy-based export (multiscan / 3rscan / scannetpp / arkitscenes
# preprocessed scenes).
# ---------------------------------------------------------------------------


def export_generic_scene(scene_dir: str, name: str):
    def load(suffix, required=False):
        p = os.path.join(scene_dir, f"{name}{suffix}.npy")
        if os.path.exists(p):
            return np.load(p)
        if required:
            raise FileNotFoundError(f"missing {p}")
        return None

    points = load("_point", required=True)
    sem = load("_sem_label")
    inst = load("_ins_label")
    sp = load("_sp")
    bbox = load("_bbox")
    boxes = labels = None
    if bbox is not None and len(bbox):
        boxes = bbox[:, :-1]
        labels = bbox[:, -1].astype(np.int64)
    return points, sem, inst, sp, boxes, labels


def prepare_generic(raw_dir, out_root, scene_names, filename, workers=8):
    def one(name):
        points, sem, inst, sp, boxes, labels = export_generic_scene(
            raw_dir, name
        )
        return write_scene(out_root, name, points, sem, inst, sp, boxes, labels)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        entries = list(ex.map(one, scene_names))
    return write_infos(entries, out_root, filename)


def prepare_scannet(scans_dir, out_root, scene_names, filename,
                    label_map_file, workers=8):
    if not label_map_file:
        raise ValueError(
            "ScanNet export requires --label-map-file "
            "(scannetv2-labels.combined.tsv from the ScanNet download); refusing "
            "to write placeholder semantics")
    label_map = read_label_mapping(label_map_file)

    def one(name):
        points, sem, inst, sp, boxes, labels, aa = export_scannet_scene(
            scans_dir, name, label_map
        )
        return write_scene(
            out_root, name, points, sem, inst, sp,
            boxes=boxes, labels=labels, axis_align=aa,
        )

    with ThreadPoolExecutor(max_workers=workers) as ex:
        entries = list(ex.map(one, scene_names))
    return write_infos(entries, out_root, filename)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Export raw scenes to bins and infos")
    ap.add_argument("dataset", choices=["scannet", "generic"])
    ap.add_argument("--raw-dir", required=True)
    ap.add_argument("--out-root", required=True)
    ap.add_argument("--scenes-file", required=True,
                    help="text file with one scene name per line")
    ap.add_argument("--out-name", default="infos_train.pkl")
    ap.add_argument("--label-map-file", default=None,
                    help="scannetv2-labels.combined.tsv (required for "
                         "scannet)")
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)

    scenes = [
        line.strip() for line in open(args.scenes_file) if line.strip()
    ]
    if args.dataset == "scannet":
        path = prepare_scannet(args.raw_dir, args.out_root, scenes,
                               args.out_name, args.label_map_file,
                               args.workers)
    else:
        path = prepare_generic(args.raw_dir, args.out_root, scenes,
                               args.out_name, args.workers)
    print(f"wrote {path} ({len(scenes)} scenes)")
    return path


if __name__ == "__main__":
    main()
