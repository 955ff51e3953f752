"""ARKitScenes RGB-D video loader + offline scene preparation.

The port's own copy of the JAX package's ``tools/arkitscenes_loader.py``, the
counterpart of the reference's frame pipeline (data/arkitscenes/
{data_prepare_offline.py, utils/tenFpsDataLoader.py, utils/rotation.py,
utils/taxonomy.py}): per-frame depth/color/pose/intrinsics loading,
back-projection + incremental 5 cm-grid accumulation, 3DOD annotation
parsing with the merged 17-class taxonomy, and info pkls in the format that
``data/datasets.py::IndoorDataset`` reads. PIL replaces cv2 for image IO;
the geometry lives in arkitscenes_utils.py. Superpoints come from the
scene's 3DOD mesh through ``native/segmentator.py``.

Usage:
  python -m unidet3d_tpu_torch.tools.arkitscenes_loader --data-root 3dod \
      --out-root DIR [--split Training|Validation] [--out-name NAME] [--workers 4]
"""
from __future__ import annotations

import glob
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .arkitscenes_utils import annotation_to_box7, unproject_depth, \
    voxel_downsample
from .create_data import write_infos

# Merged detection taxonomy (ref utils/taxonomy.py:9-15).
ARKITSCENES_CLASS_NAMES = (
    "cabinet", "refrigerator", "shelf", "stove", "bed",
    "sink", "washer", "toilet", "bathtub", "oven",
    "dishwasher", "fireplace", "stool", "chair", "table",
    "tv_monitor", "sofa",
)


def angle_axis_to_matrix(v: np.ndarray) -> np.ndarray:
    """Rodrigues: (3,) axis-angle -> (3, 3) rotation
    (ref utils/rotation.py via TrajStringToMatrix)."""
    v = np.asarray(v, np.float64)
    theta = np.linalg.norm(v)
    if theta < 1e-12:
        return np.eye(3)
    k = v / theta
    kx = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
    )
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


def parse_traj_line(line: str):
    """One lowres_wide.traj line -> (timestamp str, 4x4 camera-to-world).
    The traj stores world-to-camera as axis-angle + translation; we invert
    (ref tenFpsDataLoader.py:13-43)."""
    tok = line.split()
    if len(tok) != 7:
        raise ValueError(f"bad traj line: {line!r}")
    ts = f"{round(float(tok[0]), 3):.3f}"
    w2c = np.eye(4)
    w2c[:3, :3] = angle_axis_to_matrix([float(t) for t in tok[1:4]])
    w2c[:3, 3] = [float(t) for t in tok[4:7]]
    return ts, np.linalg.inv(w2c)


def read_pincam(path: str) -> np.ndarray:
    """.pincam intrinsics: `w h fx fy cx cy` -> 3x3
    (ref tenFpsDataLoader.py:46-48)."""
    _w, _h, fx, fy, hw, hh = np.loadtxt(path)
    return np.asarray([[fx, 0, hw], [0, fy, hh], [0, 0, 1]])


class FrameLoader:
    """Iterates an ARKitScenes `<scene>_frames` directory: for each lowres
    depth frame, finds the matching color image, .pincam intrinsics (exact
    or +-0.001 s), and trajectory pose (+-0.005 s tolerance) — the same
    frame-matching rules as the reference loader
    (tenFpsDataLoader.py:191-265)."""

    def __init__(self, frames_dir: str, subsample: int = 2):
        self.root = frames_dir
        self.subsample = subsample
        depths = sorted(
            glob.glob(os.path.join(frames_dir, "lowres_depth", "*.png"))
        )
        self.video_id = os.path.basename(
            os.path.dirname(frames_dir.rstrip("/"))
        ) if depths else ""
        self.frame_ids = sorted(
            os.path.basename(p)[:-4].split("_", 1)[1] for p in depths
        )
        if depths:
            self.video_id = os.path.basename(depths[0]).split("_", 1)[0]

        self.poses = {}
        traj = os.path.join(frames_dir, "lowres_wide.traj")
        if os.path.exists(traj):
            for line in open(traj):
                if line.strip():
                    ts, pose = parse_traj_line(line)
                    self.poses[ts] = pose

    def __len__(self):
        return len(self.frame_ids)

    def _intrinsics(self, frame_id: str) -> np.ndarray:
        base = os.path.join(self.root, "lowres_wide_intrinsics")
        for fid in (
            frame_id,
            f"{float(frame_id) - 0.001:.3f}",
            f"{float(frame_id) + 0.001:.3f}",
        ):
            p = os.path.join(base, f"{self.video_id}_{fid}.pincam")
            if os.path.exists(p):
                return read_pincam(p)
        raise FileNotFoundError(f"no intrinsics for frame {frame_id}")

    def _pose(self, frame_id: str) -> np.ndarray:
        if frame_id in self.poses:
            return self.poses[frame_id]
        t = float(frame_id)
        for ts, pose in self.poses.items():
            if abs(t - float(ts)) < 0.005:
                return pose
        raise KeyError(f"no pose for frame {frame_id}")

    def __getitem__(self, idx: int):
        """-> dict(depth (H,W) metres, rgb (H,W,3) in [0,1], intrinsics,
        pose). Color is rescaled to the depth resolution like the
        reference (tenFpsDataLoader.py:316-330)."""
        from PIL import Image

        fid = self.frame_ids[idx]
        fname = f"{self.video_id}_{fid}.png"
        depth = np.asarray(
            Image.open(os.path.join(self.root, "lowres_depth", fname))
        ).astype(np.float64) / 1000.0
        rgb_path = os.path.join(self.root, "lowres_wide", fname)
        h, w = depth.shape
        if os.path.exists(rgb_path):
            img = Image.open(rgb_path)
            if img.size != (w, h):
                img = img.resize((w, h))
            rgb = np.asarray(img, np.float64)[..., :3] / 255.0
        else:
            rgb = np.zeros((h, w, 3))
        s = self.subsample
        return {
            "frame_id": fid,
            "depth": depth[::s, ::s],
            "rgb": rgb[::s, ::s],
            "intrinsics": self._intrinsics(fid) / s
            * np.array([[1.0], [1.0], [s]]),
            "pose": self._pose(fid),
        }


def accumulate_scene(loader: FrameLoader, grid: float = 0.05) -> np.ndarray:
    """Back-project every frame and keep one (averaged) point per 5 cm cell,
    downsampling incrementally per frame to bound memory
    (ref data_prepare_offline.py:16-44). Colors stay in [0, 1] — the
    dataset's DenormalizePointsColor handles this at load time."""
    cloud = np.zeros((0, 6), np.float32)
    for i in range(len(loader)):
        frame = loader[i]
        pts = unproject_depth(
            frame["depth"], frame["intrinsics"], frame["pose"], frame["rgb"]
        )
        cloud = voxel_downsample(np.concatenate([cloud, pts], 0), grid)
    return cloud


def extract_gt_boxes(annotation_json_path: str):
    """<scene>_3dod_annotation.json -> ((G, 7) yawed gravity-center boxes,
    (G,) class ids, skipped flag). Labels are delimiter-normalized and
    filtered to the 17-class taxonomy; yaw is negated to the
    DepthInstance3DBoxes heading convention
    (ref tenFpsDataLoader.py:105-188, arkitscenes_data_utils.py:75-80)."""
    with open(annotation_json_path) as f:
        gt = json.load(f)
    boxes, labels = [], []
    for data in gt.get("data", []):
        name = data["label"]
        for d in (" ", "-", "/"):
            name = name.replace(d, "_")
        if name not in ARKITSCENES_CLASS_NAMES:
            continue
        seg = data["segments"]["obbAligned"]
        box = annotation_to_box7(
            seg["centroid"], seg["axesLengths"], seg["normalizedAxes"]
        )
        box[-1] = -box[-1]
        boxes.append(box)
        labels.append(ARKITSCENES_CLASS_NAMES.index(name))
    if boxes:
        return (np.stack(boxes).astype(np.float32),
                np.asarray(labels, np.int64), bool(gt.get("skipped", False)))
    return (np.zeros((0, 7), np.float32), np.zeros((0,), np.int64),
            bool(gt.get("skipped", False)))


def superpoints_for_cloud(points: np.ndarray, mesh_ply: str) -> np.ndarray:
    """Superpoints for the accumulated cloud: segment the scene's 3DOD mesh
    with the native segmentator and transfer ids by nearest mesh vertex.

    The reference expects `super_points/<scene>.bin` for ARKitScenes
    (unidet3d/arkitscenes_dataset.py:75-78) but ships no generator; the
    detector only pools features over them, so mesh-segment transfer is a
    faithful stand-in."""
    from .ply import mesh_points_colors, read_ply
    from ..native import segmentator

    vdata, faces = read_ply(mesh_ply)
    verts = mesh_points_colors(vdata)[:, :3]
    sp = segmentator.segment_mesh(verts, faces)
    # Nearest-vertex transfer on a coarse voxel hash (scenes are ~5 cm grid).
    from scipy.spatial import cKDTree

    _, idx = cKDTree(verts).query(points[:, :3], k=1)
    return sp[idx].astype(np.int64)


def prepare_arkitscenes(data_root, out_root, split="Training",
                        filename="arkitscenes_infos_train.pkl", workers=4,
                        grid=0.05):
    """Full offline prep: 3dod/<split>/<scene>/{<scene>_frames,
    <scene>_3dod_annotation.json[, <scene>_3dod_mesh.ply]} -> points bins,
    superpoints, infos with 7-DoF boxes."""
    split_dir = os.path.join(data_root, split)
    scenes = sorted(
        s for s in os.listdir(split_dir)
        if os.path.isdir(os.path.join(split_dir, s))
    )

    def one(scene):
        d = os.path.join(split_dir, scene)
        ann = os.path.join(d, f"{scene}_3dod_annotation.json")
        boxes, labels, skipped = extract_gt_boxes(ann)
        if skipped or len(boxes) == 0:
            return None
        loader = FrameLoader(os.path.join(d, f"{scene}_frames"))
        points = accumulate_scene(loader, grid)
        mesh = os.path.join(d, f"{scene}_3dod_mesh.ply")
        sp = (superpoints_for_cloud(points, mesh)
              if os.path.exists(mesh) else None)
        from .create_data import write_scene

        return write_scene(out_root, scene, points, None, None, sp,
                           boxes=boxes, labels=labels)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        entries = [e for e in ex.map(one, scenes) if e is not None]
    meta = {
        "categories": {n: i for i, n in enumerate(ARKITSCENES_CLASS_NAMES)},
        "dataset": "arkitscenes_offline",
    }
    return write_infos(entries, out_root, filename, metainfo=meta)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Prepare ARKitScenes 3DOD scenes")
    ap.add_argument("--data-root", required=True,
                    help="3dod root with Training/ and Validation/")
    ap.add_argument("--out-root", required=True)
    ap.add_argument("--split", default="Training",
                    choices=["Training", "Validation"])
    ap.add_argument("--out-name", default=None)
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    name = args.out_name or (
        "arkitscenes_infos_train.pkl"
        if args.split == "Training" else "arkitscenes_infos_val.pkl"
    )
    path = prepare_arkitscenes(args.data_root, args.out_root, args.split,
                               name, args.workers)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
