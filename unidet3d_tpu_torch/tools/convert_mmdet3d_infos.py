"""Convert mmdet3d-v2 info pkls to the info format the port's datasets read.

The port's own copy of the JAX package's ``tools/convert_mmdet3d_infos.py``.
The reference trains and evaluates from OpenMMLab v2 infos
(``tools/update_infos_to_v2.py``), whose ``lidar_path`` and mask paths are
bare file names that mmdet3d joins with per-dataset ``data_prefix``
directories (points/, semantic_mask/, instance_mask/, super_points/).
``data/datasets.py::IndoorDataset`` reads paths relative to data_root, so
this converter re-anchors every path under those prefixes, drops ignored
instances (bbox_label_3d == -1), and passes boxes through unchanged
(geometric-center convention on both sides).

Usage:
  python -m unidet3d_tpu_torch.tools.convert_mmdet3d_infos in.pkl out.pkl
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

_PREFIXES = {
    "pts_semantic_mask_path": "semantic_mask",
    "pts_instance_mask_path": "instance_mask",
}


def convert_entry(entry: dict) -> dict:
    """One v2 data_list entry -> the port's entry."""
    out = {}
    lp = entry["lidar_points"]
    fname = os.path.basename(lp["lidar_path"])
    out["lidar_points"] = {
        "lidar_path": f"points/{fname}",
        "num_pts_feats": lp.get("num_pts_feats", 6),
    }
    for key, prefix in _PREFIXES.items():
        if entry.get(key):
            out[key] = f"{prefix}/{os.path.basename(entry[key])}"
    # ARKitScenes v2 infos carry no super_pts_path: the reference dataset
    # reads super_points/<lidar file name>.
    sp = entry.get("super_pts_path") or fname
    out["super_pts_path"] = f"super_points/{os.path.basename(sp)}"
    if entry.get("axis_align_matrix") is not None:
        out["axis_align_matrix"] = np.asarray(entry["axis_align_matrix"]).tolist()
    out["instances"] = [
        {
            "bbox_3d": [float(v) for v in inst["bbox_3d"]],
            "bbox_label_3d": int(inst["bbox_label_3d"]),
        }
        for inst in entry.get("instances", [])
        if int(inst.get("bbox_label_3d", -1)) >= 0
    ]
    return out


def convert_infos(in_path: str, out_path: str) -> dict:
    """Convert the v2 pkl at `in_path`, write it to `out_path` and return
    it. Raises ValueError for a pkl without data_list (v1 infos go through
    mmdet3d's update_infos_to_v2 first)."""
    with open(in_path, "rb") as f:
        info = pickle.load(f)
    if "data_list" not in info:
        raise ValueError(
            f"{in_path} is not a v2 info pkl (no data_list); v1 infos must first "
            "go through mmdet3d's update_infos_to_v2")
    converted = {
        "metainfo": info.get("metainfo", {}),
        "data_list": [convert_entry(e) for e in info["data_list"]],
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(converted, f)
    return converted


def main(argv=None):
    ap = argparse.ArgumentParser(description="Re-anchor mmdet3d-v2 info pkls")
    ap.add_argument("in_pkl")
    ap.add_argument("out_pkl")
    args = ap.parse_args(argv)
    info = convert_infos(args.in_pkl, args.out_pkl)
    print(f"wrote {args.out_pkl} ({len(info['data_list'])} scenes)")


if __name__ == "__main__":
    main()
