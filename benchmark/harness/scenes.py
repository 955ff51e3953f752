"""Scenes from the seed, written in the reference's info format.

The scene generator is a copy of ``unidet3d_tpu_torch/data/synthetic.py``
(``synthetic_scene`` and its helpers, ``stripe_superpoints``,
``write_info_dataset``), and ``info_scene`` / ``write_datasets`` follow
``chip_smoke.py``'s of the same names, with superpoints of 64 points (as
``reference_scale_scenes``) so that a 190k-point scene keeps under
S = 3072. They are the yardstick's own: a later change to the program's
generator does not change what the benchmark feeds it.

Surface-like scans: a room shell plus furniture boxes at the surface density
of ScanNet's decimated meshes (~2,500 points per m^2), so that voxel and
neighbour-pair counts per U-Net level match real scans.
"""
from __future__ import annotations

import concurrent.futures
import os
import pickle

import numpy as np

from ..reference.refnet.core.config import DATASETS_CLASSES, default_config
from ..reference.refnet.data.dataset_specs import DEFAULT_LABEL_MAPPINGS, SCANNET_DET_CAT_IDS

# Real-scan surface point density (see module docstring): ScanNet
# vh_clean_2 decimated meshes ~ 2 cm vertex spacing ~= 2500 pts / m^2.
SURFACE_DENSITY = 2500.0


def _sample_on_box(rng, n, center, size, faces="all"):
    """Uniform area-weighted samples on the surface of an axis-aligned box."""
    half = np.asarray(size, np.float64) / 2
    # Face areas: +-x, +-y, +-z.
    areas = np.array(
        [
            size[1] * size[2], size[1] * size[2],
            size[0] * size[2], size[0] * size[2],
            size[0] * size[1], size[0] * size[1],
        ],
        np.float64,
    )
    if faces == "sides_top":  # furniture: skip the hidden bottom face
        areas[5] = 0.0
    probs = areas / areas.sum()
    face = rng.choice(6, size=n, p=probs)
    u = rng.rand(n) * 2 - 1
    v = rng.rand(n) * 2 - 1
    pts = np.empty((n, 3))
    axis = face // 2  # 0=x, 1=y, 2=z
    sign = np.where(face % 2 == 0, 1.0, -1.0)
    for a in range(3):
        m = axis == a
        o1, o2 = (a + 1) % 3, (a + 2) % 3
        pts[m, a] = sign[m] * half[a]
        pts[m, o1] = u[m] * half[o1]
        pts[m, o2] = v[m] * half[o2]
    return pts + np.asarray(center, np.float64), axis


def _room_extent(n_points: int, rng, wall_h: float = 2.6):
    """Floor extent (ex, ey) such that the scene's total sampled surface
    (floor + 4 walls + ~25% furniture overhead) hits SURFACE_DENSITY for
    `n_points`. Aspect ratio drawn in [1, 1.5] like real rooms."""
    target = n_points / SURFACE_DENSITY  # m^2 of surface to cover
    r = 1.0 + rng.rand() * 0.5
    # Solve a*(1.25) + walls for ex with ey = r*ex:
    #   1.25*r*ex^2 + 2*(1+r)*wall_h*ex - target = 0
    a = 1.25 * r
    b = 2.0 * (1.0 + r) * wall_h
    ex = (-b + np.sqrt(b * b + 4 * a * target)) / (2 * a)
    ex = max(ex, 2.0)
    return ex, r * ex, wall_h


def synthetic_scene(
    n_points: int,
    extent=None,
    n_objects: int | None = None,
    noise: float = 0.005,
    seed: int = 0,
):
    """(n_points, 6) float32 [xyz, rgb in [-1, 1]-ish] surface-like scene.

    ~55% of points land on the room shell (floor + 4 walls, ceiling-less
    like most scans), the rest on furniture boxes. `extent=None` (the
    default) sizes the room to the point count at real-scan surface
    density (see module docstring); pass an explicit (ex, ey, ez) to pin
    the geometry instead.
    """
    rng = np.random.RandomState(seed)
    if extent is None:
        extent = _room_extent(n_points, rng)
    ex, ey, ez = extent
    if n_objects is None:
        # Furniture count scales with floor area (~1 object / 2.5 m^2).
        n_objects = max(4, int(ex * ey / 2.5))

    n_room = int(n_points * 0.55)
    # Room shell: floor + 4 walls, area-weighted.
    areas = np.array([ex * ey, ey * ez, ey * ez, ex * ez, ex * ez])
    probs = areas / areas.sum()
    which = rng.choice(5, size=n_room, p=probs)
    pts_room = np.empty((n_room, 3))
    nrm_room = np.empty(n_room, np.int64)  # surface-normal axis per point
    u, v = rng.rand(n_room), rng.rand(n_room)
    m = which == 0  # floor
    pts_room[m] = np.stack([u[m] * ex, v[m] * ey, np.zeros(m.sum())], 1)
    nrm_room[m] = 2
    for i, (fx, fy) in enumerate([(0.0, None), (ex, None),
                                  (None, 0.0), (None, ey)], start=1):
        m = which == i
        if fx is not None:
            pts_room[m] = np.stack([np.full(m.sum(), fx), u[m] * ey,
                                    v[m] * ez], 1)
            nrm_room[m] = 0
        else:
            pts_room[m] = np.stack([u[m] * ex, np.full(m.sum(), fy),
                                    v[m] * ez], 1)
            nrm_room[m] = 1

    n_obj = n_points - n_room
    sizes = 0.3 + rng.rand(n_objects, 3) * np.array([1.5, 1.5, 1.2])
    span_x, span_y = max(ex - 2, 0.1), max(ey - 2, 0.1)
    centers = np.stack(
        [
            rng.rand(n_objects) * span_x + min(1.0, ex / 2),
            rng.rand(n_objects) * span_y + min(1.0, ey / 2),
            sizes[:, 2] / 2,  # resting on the floor
        ],
        1,
    )
    obj_areas = 2 * (
        sizes[:, 0] * sizes[:, 1]
        + sizes[:, 1] * sizes[:, 2]
        + sizes[:, 0] * sizes[:, 2]
    )
    counts = rng.multinomial(n_obj, obj_areas / obj_areas.sum())
    obj_out = [
        _sample_on_box(rng, c, centers[k], sizes[k], faces="sides_top")
        for k, c in enumerate(counts)
        if c
    ]
    pts_obj = np.concatenate([o[0] for o in obj_out], 0)
    nrm_obj = np.concatenate([o[1] for o in obj_out], 0)

    xyz = np.concatenate([pts_room, pts_obj], 0)
    nrm = np.concatenate([nrm_room, nrm_obj], 0)
    # Sensor jitter, TANGENTIAL to the local surface: real input points are
    # reconstructed-mesh vertices that sit ON the surface (normal-direction
    # error is removed by the reconstruction), so normal jitter — which
    # inflates 2 cm occupancy well past real scans' — stays at 10%.
    jit = rng.randn(*xyz.shape) * noise
    jit[np.arange(len(xyz)), nrm] *= 0.1
    xyz += jit
    rgb = rng.rand(len(xyz), 3) * 2 - 1
    pts = np.concatenate([xyz, rgb], 1).astype(np.float32)
    return pts[rng.permutation(len(pts))][:n_points]


def stripe_superpoints(points: np.ndarray, size: int) -> np.ndarray:
    """(N,) int64 superpoint ids: spatial stripes of `size` points along x,
    a deterministic stand-in for a mesh segmentation."""
    order = np.argsort(points[:, 0], kind="stable")
    sp = np.empty(len(points), np.int64)
    sp[order] = np.arange(len(points)) // size
    return sp



def write_info_dataset(root: str, scenes, ann_file: str = "infos.pkl") -> str:
    """Writes `scenes` under `root` in the reference's info format (the one
    ``data/datasets.py::IndoorDataset`` reads) and returns the info file's
    path. Each scene is a dict with "name" and "points" (N, 6) float32
    [xyz, colors as the dataset stores them], and optionally
    "instance_mask", "semantic_mask", "super_points" (N,) int64,
    "boxes" (n, 6 or 7) gravity-center boxes with their raw "labels" (n,),
    and "axis_align_matrix" (4, 4)."""
    files = {"instance_mask": "pts_instance_mask_path",
             "semantic_mask": "pts_semantic_mask_path",
             "super_points": "super_pts_path"}
    data_list = []
    for scene in scenes:
        name = scene["name"]
        entry = {"lidar_points": {"lidar_path": f"points/{name}.bin"}}
        os.makedirs(os.path.join(root, "points"), exist_ok=True)
        np.asarray(scene["points"], np.float32).tofile(
            os.path.join(root, "points", f"{name}.bin"))
        for sub, key in files.items():
            if scene.get(sub) is not None:
                os.makedirs(os.path.join(root, sub), exist_ok=True)
                np.asarray(scene[sub], np.int64).tofile(
                    os.path.join(root, sub, f"{name}.bin"))
                entry[key] = f"{sub}/{name}.bin"
        if scene.get("axis_align_matrix") is not None:
            entry["axis_align_matrix"] = np.asarray(scene["axis_align_matrix"]).tolist()
        entry["instances"] = [
            {"bbox_3d": [float(v) for v in box], "bbox_label_3d": int(label)}
            for box, label in zip(scene.get("boxes", ()), scene.get("labels", ()))
        ]
        data_list.append(entry)
    path = os.path.join(root, ann_file)
    with open(path, "wb") as f:
        pickle.dump({"metainfo": {}, "data_list": data_list}, f)
    return path

SP_SIZE = 64  # points per superpoint stripe
SP_PER_GT = 20  # stripes per ground-truth instance
N_GTS = 64  # instances per scene, fewer in a small one
SCANNET, MULTISCAN, RSCAN, ARKIT = 0, 2, 3, 5


def dataset_name(ds: int) -> str:
    return default_config().datasets[ds]


def info_scene(ds: int, name: str, n_points: int, seed: int) -> dict:
    """One synthetic scene of dataset `ds` as its infos store it: colors raw
    (ARKitScenes in [0, 1], the rest in [0, 255]), stripe superpoints,
    instances of SP_PER_GT stripes with their point bounds as boxes and raw
    labels: ScanNet's nyu40 ids in the semantic mask (so that its class
    mappings keep every instance), MultiScan's and 3RScan's raw ids (their
    label mappings keep them), ARKitScenes' boxes with a yaw each."""
    rng = np.random.RandomState(seed)
    pts = synthetic_scene(n_points, seed=seed)
    sp = stripe_superpoints(pts, SP_SIZE)
    n_sp = int(sp.max()) + 1
    n_gts = min(N_GTS, n_sp // SP_PER_GT - 1)
    inst_of_sp = np.full(n_sp, -1)
    inst_of_sp[: n_gts * SP_PER_GT] = np.arange(n_gts * SP_PER_GT) // SP_PER_GT
    inst = inst_of_sp[sp]
    order = np.argsort(inst, kind="stable")
    starts = np.searchsorted(inst[order], np.arange(n_gts + 1))
    xyz = pts[order, :3]
    lo = np.stack([xyz[starts[k]:starts[k + 1]].min(0) for k in range(n_gts)])
    hi = np.stack([xyz[starts[k]:starts[k + 1]].max(0) for k in range(n_gts)])
    boxes = np.concatenate([(lo + hi) / 2, hi - lo], 1).astype(np.float32)
    labels = rng.randint(0, len(DATASETS_CLASSES[ds]), n_gts)
    raw = pts.copy()
    raw[:, 3:] = (pts[:, 3:] + 1) * (0.5 if ds == ARKIT else 127.5)
    scene = dict(name=name, points=raw, super_points=sp, boxes=boxes, labels=labels)
    if ds == SCANNET:
        det_ids = np.asarray(SCANNET_DET_CAT_IDS)
        sem = np.where(inst >= 0, det_ids[labels[np.maximum(inst, 0)]],
                       rng.randint(1, 3, len(pts)))  # wall / floor
        scene.update(instance_mask=inst, semantic_mask=sem, axis_align_matrix=np.eye(4))
    elif ds in (MULTISCAN, RSCAN):
        raw_id = {i: c for c, i in DEFAULT_LABEL_MAPPINGS[dataset_name(ds)].items()}
        scene.update(instance_mask=inst, labels=np.asarray([raw_id[i] for i in labels]))
    elif ds == ARKIT:
        yaw = rng.uniform(-np.pi, np.pi, (n_gts, 1)).astype(np.float32)
        scene.update(boxes=np.concatenate([boxes, yaw], 1))
    else:
        raise ValueError(f"no scene writer for dataset {ds}")
    return scene


def write_dataset(root: str, ds: int, sizes, seed: int, ann_file: str,
                  entries=None) -> str:
    """Writes one scene per size of `sizes` for dataset `ds` under
    root/<dataset name> (scene i from the seed (seed, ds, i)) with the info
    file `ann_file`, whose data list is the scenes in the order `entries`
    gives (indices into `sizes`, repeats allowed; default each once).
    Returns the data root."""
    data_root = os.path.join(root, dataset_name(ds))
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
        scenes = list(pool.map(lambda a: info_scene(ds, f"s{a[0]:03d}", int(a[1]),
                                                    scene_seed(seed, ds, a[0])),
                               enumerate(sizes)))
    if entries is not None:
        scenes = [scenes[i] for i in entries]
    write_info_dataset(data_root, scenes, ann_file=ann_file)
    return data_root


def scene_seed(seed: int, ds: int, i: int) -> int:
    """A 32-bit seed for scene i of dataset ds from the run's seed."""
    return int(np.random.SeedSequence([seed, ds, i]).generate_state(1)[0])
