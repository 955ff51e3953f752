"""Bespoke raw-data converters: MultiScan / 3RScan / ScanNet++ -> bins + infos.

The port's own copy of the JAX package's ``tools/prep_datasets.py``: the
reference's per-dataset preprocessing scripts
(data/multiscan/prepare_bins_pkls.py, data/3rscan/{preprocess_raw_data.py,
prepare_bins_pkls.py,utils.py}, data/scannetpp/{preprocess_raw_data.py,
prepare_bins_pkls.py}) as host tools writing the info format that
``data/datasets.py::IndoorDataset`` reads.
Label-id conventions match the reference exactly so the dataset readers'
`valid_class_ids` remaps (data/dataset_specs.py) apply unchanged:

  * multiscan:  0..19 per the merged taxonomy below (floor/ceiling/wall are
                stuff; detection ids 3..19)
  * 3rscan:     nyu40-style global ids from the 3RScan semantic-classes csv;
                detection keeps the 18 ScanNet ids
  * scannetpp:  top-100 benchmark ids (detection keeps 84 of them)

Everything runs from plain files (ply/obj/json/csv/pth) with numpy; torch is
only imported for MultiScan's .pth scene archives.

Usage:
  python -m unidet3d_tpu_torch.tools.prep_datasets multiscan --pth-dir DIR --out-root DIR
  python -m unidet3d_tpu_torch.tools.prep_datasets 3rscan --dataset-root DIR \
      --out-root DIR --scenes-file names.txt --meta-json 3RScan.json \
      --label-map-csv labels.csv [--ref-align-pkl align.pkl]
  python -m unidet3d_tpu_torch.tools.prep_datasets scannetpp --data-root DIR \
      --out-root DIR --scenes-file names.txt
"""
from __future__ import annotations

import csv
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .create_data import write_infos, write_scene
from .ply import mesh_points_colors, read_ply

# ---------------------------------------------------------------------------
# Shared helpers.
# ---------------------------------------------------------------------------


def boxes_from_instance_ids(xyz, inst, inst_labels, skip=(-1,)):
    """Axis-aligned geometric-center boxes per instance id.

    Mirrors the min/max box fit used by every reference converter
    (e.g. data/multiscan/prepare_bins_pkls.py:159-181). `inst_labels` maps
    instance id -> semantic label id written as bbox_label_3d.
    """
    boxes, labels = [], []
    for inst_id in np.unique(inst):
        if int(inst_id) in skip or int(inst_id) not in inst_labels:
            continue
        pc = xyz[inst == inst_id]
        if len(pc) == 0:
            continue
        mn, mx = pc.min(0), pc.max(0)
        boxes.append(np.concatenate([(mn + mx) / 2.0, mx - mn]))
        labels.append(int(inst_labels[int(inst_id)]))
    if not boxes:
        return np.zeros((0, 6), np.float32), np.zeros((0,), np.int64)
    return np.stack(boxes).astype(np.float32), np.asarray(labels, np.int64)


def _mtl_texture_path(obj_path: str, mtllib: str | None):
    """Resolve the .mtl's map_Kd texture image next to the OBJ, or None."""
    d = os.path.dirname(os.path.abspath(obj_path))
    cands = [mtllib] if mtllib else []
    base = os.path.splitext(os.path.basename(obj_path))[0]
    cands.append(base + ".mtl")
    for name in cands:
        mtl = os.path.join(d, name)
        if not os.path.exists(mtl):
            continue
        with open(mtl) as f:
            for line in f:
                t = line.split()
                if t and t[0] == "map_Kd" and len(t) > 1:
                    tex = os.path.join(d, t[-1])
                    if os.path.exists(tex):
                        return tex
    return None


def read_obj_mesh(path: str):
    """OBJ reader: `v x y z [r g b]` + `vt u v` + triangulated `f` lines ->
    ((N, 6) points [xyz rgb 0-255], (F, 3) int faces).

    Per-vertex color comes from (in priority order) explicit vertex colors,
    else the .mtl texture atlas sampled at each vertex's UV — the reference's
    read_objmesh semantics (data/3rscan/utils.py:47-85: parse mtllib ->
    map_Kd image, take each vertex's texcoord from the faces, sample the
    atlas at (u, 1-v)). Vertices never referenced with a texcoord keep 0."""
    verts, vcolors, texco, faces = [], [], [], []
    uv_of_vert = {}  # vertex index -> vt index (last face reference wins)
    mtllib = None
    has_vcolor = False
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(v) for v in t[1:4]])
                if len(t) >= 7:
                    has_vcolor = True
                    vcolors.append([float(v) for v in t[4:7]])
                else:
                    vcolors.append([0.0, 0.0, 0.0])
            elif t[0] == "vt":
                texco.append([float(t[1]), float(t[2])])
            elif t[0] == "mtllib" and len(t) > 1:
                mtllib = t[1]
            elif t[0] == "f":
                idx = []
                for v in t[1:]:
                    parts = v.split("/")
                    vi = int(parts[0]) - 1
                    idx.append(vi)
                    if len(parts) > 1 and parts[1]:
                        uv_of_vert[vi] = int(parts[1]) - 1
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    colors = np.asarray(vcolors, np.float32)
    if not has_vcolor and texco and uv_of_vert:
        tex = _mtl_texture_path(path, mtllib)
        if tex is not None:
            from PIL import Image

            img = np.asarray(Image.open(tex).convert("RGB"), np.float32)
            h, w = img.shape[:2]
            vi = np.fromiter(uv_of_vert.keys(), np.int64)
            ti = np.fromiter(uv_of_vert.values(), np.int64)
            uv = np.asarray(texco, np.float32)[ti]
            # Atlas convention: v runs bottom-up; wrap out-of-range UVs.
            px = np.clip((uv[:, 0] % 1.0) * (w - 1), 0, w - 1).astype(int)
            py = np.clip((1.0 - uv[:, 1] % 1.0) * (h - 1), 0, h - 1).astype(
                int
            )
            colors[vi] = img[py, px]
    pts = np.concatenate([np.asarray(verts, np.float32), colors], 1)
    return pts, np.asarray(faces, np.int32).reshape(-1, 3)


def _segments_to_points(seg_indices, segments):
    return np.where(np.isin(seg_indices, np.asarray(segments)))[0]


def _superpoints_from_mesh(xyz, faces):
    from ..native import segmentator

    return segmentator.segment_mesh(
        np.ascontiguousarray(xyz, np.float32),
        np.ascontiguousarray(faces, np.int64),
    )


# ---------------------------------------------------------------------------
# MultiScan (ref data/multiscan/prepare_bins_pkls.py).
# ---------------------------------------------------------------------------

# Merged taxonomy: raw annotation names -> canonical class names (ref :13-59).
MULTISCAN_NAME_MERGE = {
    "door": "door", "sliding_door": "door", "glass_door": "door",
    "bifold_door": "door",
    "adjustable_desk": "table", "computer_table": "table", "table": "table",
    "desk": "table", "computer_desk": "table", "bar_table": "table",
    "chair": "chair", "stacked_chairs": "chair",
    "wine_cabinet": "cabinet", "sink_cabinet": "cabinet",
    "cabinet": "cabinet", "wardrobe": "cabinet", "nightstand": "cabinet",
    "shoe_cabinet": "cabinet", "wall_cabinet": "cabinet",
    "tv_cabinet": "cabinet", "drawer_unit": "cabinet",
    "cabinet_otherroom": "cabinet",
    "window": "window", "sofa": "sofa", "microwave": "microwave",
    "sofa_cushion": "pillow", "thow_pillow": "pillow",
    "chair_cushion": "pillow", "back_cushion": "pillow",
    "cushion": "pillow", "pillow": "pillow",
    "tv": "tv_monitor", "monitor": "tv_monitor",
    "curtain": "curtain", "door_curtain": "curtain",
    "shower_curtain": "curtain",
    "trashbin": "trash_can", "trash_bin": "trash_can",
    "waste_container": "trash_can",
    "suitcase": "suitcase", "sink": "sink", "backpack": "backpack",
    "bed": "bed", "refrigerator": "refrigerator", "fridge": "refrigerator",
    "toilet": "toilet", "pit_toilet": "toilet",
}

# Canonical class name -> semantic id (ref :63-83); 0..2 are stuff.
MULTISCAN_CLASS2SEM = {
    "floor": 0, "ceiling": 1, "wall": 2, "door": 3, "table": 4, "chair": 5,
    "cabinet": 6, "window": 7, "sofa": 8, "microwave": 9, "pillow": 10,
    "tv_monitor": 11, "curtain": 12, "trash_can": 13, "suitcase": 14,
    "sink": 15, "backpack": 16, "bed": 17, "refrigerator": 18, "toilet": 19,
}


def export_multiscan_scene(pth_path: str):
    """One MultiScan .pth scene archive (keys xyz/rgb/faces/instance_ids/
    sem_labels/inst2obj) -> (points, sem, inst, superpoints, boxes, labels).
    Instances with sem == -1 are unannotated; box label = majority semantic
    vote over the instance's points (ref prepare_bins_pkls.py:118-181)."""
    import torch

    scene = torch.load(pth_path, map_location="cpu", weights_only=False)
    xyz = np.asarray(scene["xyz"], np.float32)
    rgb = np.asarray(scene["rgb"], np.float32)
    faces = np.asarray(scene["faces"], np.int64)
    inst = np.asarray(scene["instance_ids"], np.int64).copy()
    sem = np.asarray(scene["sem_labels"], np.int64)
    inst[sem == -1] = -1

    sp = _superpoints_from_mesh(xyz, faces)

    inst_labels = {}
    for inst_id in np.unique(inst):
        if inst_id == -1:
            continue
        vals, cnt = np.unique(sem[inst == inst_id], return_counts=True)
        lab = int(vals[cnt.argmax()])
        if lab >= 3:  # stuff (floor/ceiling/wall) never becomes a box
            inst_labels[int(inst_id)] = lab
    boxes, labels = boxes_from_instance_ids(xyz, inst, inst_labels)
    points = np.concatenate([xyz, rgb], 1).astype(np.float32)
    return points, sem, inst, sp, boxes, labels


def prepare_multiscan(pth_dir, out_root, filename="multiscan_infos_train.pkl",
                      workers=8):
    files = sorted(f for f in os.listdir(pth_dir) if f.endswith(".pth"))

    def one(fname):
        name = fname.split(".")[0]
        points, sem, inst, sp, boxes, labels = export_multiscan_scene(
            os.path.join(pth_dir, fname)
        )
        return write_scene(out_root, name, points, sem, inst, sp,
                           boxes=boxes, labels=labels)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        entries = list(ex.map(one, files))
    meta = {"categories": MULTISCAN_CLASS2SEM, "dataset": "MultiScan"}
    return write_infos(entries, out_root, filename, metainfo=meta)


# ---------------------------------------------------------------------------
# 3RScan (ref data/3rscan/preprocess_raw_data.py + prepare_bins_pkls.py).
# ---------------------------------------------------------------------------


def read_3rscan_transforms(meta_json_path: str):
    """3RScan.json -> (rescan_id -> 4x4 rescan-to-reference transform,
    scan_id -> reference scan id) (ref preprocess_raw_data.py:27-48)."""
    with open(meta_json_path) as f:
        data = json.load(f)
    rescan2ref, scan2reference = {}, {}
    for scene in data:
        ref = scene["reference"]
        scan2reference[ref] = ref
        for scan in scene.get("scans", []):
            scan2reference[scan["reference"]] = ref
            if "transform" in scan:
                rescan2ref[scan["reference"]] = (
                    np.asarray(scan["transform"], np.float64).reshape(4, 4).T
                )
    return rescan2ref, scan2reference


def read_3rscan_label_map(csv_path: str):
    """3RScan.v2 Semantic-Classes-Mapping.csv: label string -> global
    (nyu40-compatible) id. The reference reads pandas column 'Unnamed: 2'
    with header=1 (preprocess_raw_data.py:185, utils.py:155-156) — i.e. the
    csv's UNNAMED column at position 2; we find the 'Label' column and the
    first unnamed column after it in the same file."""
    mapping = {}
    with open(csv_path) as f:
        rows = list(csv.reader(f))
    # Row 1 is the real header in the shipped csv (row 0 is a title line).
    header_idx = 1 if len(rows) > 1 and "Label" in rows[1] else 0
    header = rows[header_idx]
    if "Label" not in header:
        raise ValueError(
            f"3RScan label csv {csv_path!r}: no 'Label' column in header "
            f"{header!r} — wrong file or malformed header"
        )
    label_col = header.index("Label")
    unnamed = [i for i, h in enumerate(header)
               if not h.strip() and i > label_col]
    id_col = unnamed[0] if unnamed else label_col + 1
    for row in rows[header_idx + 1:]:
        if len(row) > id_col and row[label_col]:
            try:
                mapping[row[label_col]] = int(row[id_col])
            except ValueError:
                continue
    if not mapping:
        raise ValueError(
            f"3RScan label csv {csv_path!r}: no label->id rows parsed "
            f"(id column guess {id_col})"
        )
    # Spot-check nyu40 anchors: a mis-guessed id column would silently
    # remap the whole dataset; fail loudly instead.
    _NYU40_ANCHORS = {"wall": 1, "floor": 2, "cabinet": 3, "bed": 4,
                      "chair": 5, "sofa": 6, "table": 7}
    for name, want in _NYU40_ANCHORS.items():
        got = mapping.get(name)
        if got is not None and got != want:
            raise ValueError(
                f"3RScan label csv {csv_path!r}: {name!r} -> {got}, "
                f"expected nyu40 id {want} — id column mis-detected "
                f"(guessed column {id_col})"
            )
    return mapping


def export_3rscan_scene(scene_dir: str, label_map: dict,
                        align: np.ndarray | None = None):
    """One 3RScan scene dir (mesh.refined.v2.obj|.ply + semseg.v2.json +
    mesh.refined.0.010000.segs.v2.json) -> (aligned points, sem, inst,
    superpoints, boxes, labels). Superpoints are the mesh's own segment ids
    (ref preprocess_raw_data.py:166); boxes are fit on aligned points."""
    obj = os.path.join(scene_dir, "mesh.refined.v2.obj")
    ply = os.path.join(scene_dir, "mesh.refined.v2.color.ply")
    if os.path.exists(obj):
        points, _faces = read_obj_mesh(obj)
    else:
        vdata, _faces = read_ply(ply)
        points = mesh_points_colors(vdata)

    with open(os.path.join(
            scene_dir, "mesh.refined.0.010000.segs.v2.json")) as f:
        seg_indices = np.asarray(json.load(f)["segIndices"], np.int64)
    with open(os.path.join(scene_dir, "semseg.v2.json")) as f:
        seg_groups = json.load(f)["segGroups"]

    n = len(points)
    xyz = points[:, :3]
    if align is not None:
        ones = np.concatenate([xyz, np.ones((n, 1), np.float32)], 1)
        xyz = (ones @ np.asarray(align, np.float64).T)[:, :3].astype(
            np.float32
        )
        points = np.concatenate([xyz, points[:, 3:]], 1)

    sem = np.full(n, -1, np.int64)
    inst = np.full(n, -1, np.int64)
    inst_labels = {}
    for obj_idx, group in enumerate(seg_groups):
        label_id = int(label_map.get(group["label"], 0))
        p_inds = _segments_to_points(seg_indices, group["segments"])
        if len(p_inds) == 0:
            continue
        sem[p_inds] = label_id
        inst[p_inds] = obj_idx
        inst_labels[obj_idx] = label_id
    boxes, labels = boxes_from_instance_ids(xyz, inst, inst_labels)
    return points.astype(np.float32), sem, inst, seg_indices, boxes, labels


def prepare_3rscan(dataset_root, out_root, scenes, meta_json, label_map_csv,
                   ref_align_pkl=None, filename="3rscan_infos_train.pkl",
                   workers=8):
    """Full 3RScan conversion: rescans are first moved into their reference
    scan's frame (rescan2ref), then axis-aligned with the reference scan's
    alignment matrix when provided (ref preprocess_raw_data.py:56-89)."""
    import pickle

    label_map = read_3rscan_label_map(label_map_csv)
    rescan2ref, scan2reference = read_3rscan_transforms(meta_json)
    ref_align = {}
    if ref_align_pkl:
        with open(ref_align_pkl, "rb") as f:
            ref_align = pickle.load(f)

    def one(scene):
        align = rescan2ref.get(scene, np.eye(4))
        ref_id = scan2reference.get(scene, scene)
        if ref_id in ref_align:
            align = np.asarray(ref_align[ref_id], np.float64) @ align
        points, sem, inst, sp, boxes, labels = export_3rscan_scene(
            os.path.join(dataset_root, scene), label_map, align
        )
        return write_scene(out_root, scene, points, sem, inst, sp,
                           boxes=boxes, labels=labels)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        entries = list(ex.map(one, scenes))
    return write_infos(entries, out_root, filename,
                       metainfo={"dataset": "3RScan"})


# ---------------------------------------------------------------------------
# ScanNet++ (ref data/scannetpp/preprocess_raw_data.py).
# ---------------------------------------------------------------------------


def read_scannetpp_label_maps(metadata_dir: str):
    """semantic_benchmark/{top100.txt, map_benchmark.csv} -> (name -> top100
    id, raw name -> canonical name) (ref preprocess_raw_data.py:167-193)."""
    top100 = {}
    with open(os.path.join(metadata_dir, "top100.txt")) as f:
        for idx, line in enumerate(f):
            if line.strip():
                top100[line.strip()] = idx
    if not top100:
        raise ValueError(f"empty top100.txt under {metadata_dir!r}")
    sem_map = {}
    map_csv = os.path.join(metadata_dir, "map_benchmark.csv")
    if os.path.exists(map_csv):
        with open(map_csv) as f:
            for row in csv.DictReader(f):
                if row.get("semantic_map_to"):
                    sem_map[row["class"]] = row["semantic_map_to"]
        # Malformed columns would remap every label to garbage: require
        # that remap TARGETS overwhelmingly resolve inside the top100
        # taxonomy (a handful legitimately fall outside and are dropped).
        if sem_map:
            hit = sum(1 for v in sem_map.values() if v in top100)
            if hit == 0:
                raise ValueError(
                    f"map_benchmark.csv under {metadata_dir!r}: no "
                    "'semantic_map_to' target is a top100 name — wrong "
                    "columns or mismatched metadata"
                )
    return top100, sem_map


def export_scannetpp_scene(scene_dir: str, top100: dict, sem_map: dict):
    """One ScanNet++ scene (scans/mesh_aligned_0.05.ply +
    scans/segments_anno.json) -> (points, sem, inst, superpoints, boxes,
    labels). Group segments index vertices directly; labels outside the
    top-100 taxonomy (after map_benchmark remap) are dropped
    (ref preprocess_raw_data.py:42-90)."""
    scans = os.path.join(scene_dir, "scans")
    vdata, faces = read_ply(os.path.join(scans, "mesh_aligned_0.05.ply"))
    points = mesh_points_colors(vdata)
    sp = _superpoints_from_mesh(points[:, :3], faces)

    n = len(points)
    sem = np.full(n, -1, np.int64)
    inst = np.full(n, -1, np.int64)
    inst_labels = {}
    anno_path = os.path.join(scans, "segments_anno.json")
    if os.path.exists(anno_path):
        with open(anno_path) as f:
            seg_groups = json.load(f)["segGroups"]
        obj_idx = 0
        for group in seg_groups:
            label = group["label"]
            if label not in top100:
                label = sem_map.get(label)
                if label not in top100:
                    continue
            label_id = top100[label]
            segs = np.asarray(group["segments"], np.int64)
            segs = segs[segs < n]
            sem[segs] = label_id
            inst[segs] = obj_idx
            inst_labels[obj_idx] = label_id
            obj_idx += 1
    boxes, labels = boxes_from_instance_ids(points[:, :3], inst, inst_labels)
    return points, sem, inst, sp, boxes, labels


def prepare_scannetpp(data_root, out_root, scenes,
                      filename="scannetpp_infos_train.pkl", workers=8):
    metadata = os.path.join(data_root, "metadata", "semantic_benchmark")
    top100, sem_map = read_scannetpp_label_maps(metadata)

    def one(scene):
        points, sem, inst, sp, boxes, labels = export_scannetpp_scene(
            os.path.join(data_root, "data", scene), top100, sem_map
        )
        return write_scene(out_root, scene, points, sem, inst, sp,
                           boxes=boxes, labels=labels)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        entries = list(ex.map(one, scenes))
    return write_infos(entries, out_root, filename,
                       metainfo={"categories": top100,
                                 "dataset": "ScanNet++"})


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Export MultiScan / 3RScan / ScanNet++ scenes")
    sub = ap.add_subparsers(dest="dataset", required=True)

    p = sub.add_parser("multiscan")
    p.add_argument("--pth-dir", required=True)
    p.add_argument("--out-root", required=True)
    p.add_argument("--out-name", default="multiscan_infos_train.pkl")

    p = sub.add_parser("3rscan")
    p.add_argument("--dataset-root", required=True)
    p.add_argument("--out-root", required=True)
    p.add_argument("--scenes-file", required=True)
    p.add_argument("--meta-json", required=True, help="3RScan.json")
    p.add_argument("--label-map-csv", required=True)
    p.add_argument("--ref-align-pkl", default=None)
    p.add_argument("--out-name", default="3rscan_infos_train.pkl")

    p = sub.add_parser("scannetpp")
    p.add_argument("--data-root", required=True)
    p.add_argument("--out-root", required=True)
    p.add_argument("--scenes-file", required=True)
    p.add_argument("--out-name", default="scannetpp_infos_train.pkl")

    args = ap.parse_args(argv)
    if args.dataset == "multiscan":
        path = prepare_multiscan(args.pth_dir, args.out_root, args.out_name)
    elif args.dataset == "3rscan":
        scenes = [s.strip() for s in open(args.scenes_file) if s.strip()]
        path = prepare_3rscan(args.dataset_root, args.out_root, scenes,
                              args.meta_json, args.label_map_csv,
                              args.ref_align_pkl, args.out_name)
    else:
        scenes = [s.strip() for s in open(args.scenes_file) if s.strip()]
        path = prepare_scannetpp(args.data_root, args.out_root, scenes,
                                 args.out_name)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
