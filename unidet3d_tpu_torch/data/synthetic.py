"""Synthetic indoor scenes (the port's copy of the JAX package's
``data/synthetic.py``, same generator, same numbers for a seed).

Real indoor scans are 2.5-D SURFACES (floors, walls, furniture shells), not
uniform volumes. This generator samples points from a room shell (floor +
walls) plus box-shaped "furniture" surfaces, area-weighted, with sensor-like
jitter, and scales the room to the requested point count at the surface
density of ScanNet's decimated meshes (~2 cm vertex spacing, about 2500
points per m^2), so that voxel counts per U-Net level and neighbor-pair
counts match real scans: level-0 voxels ~= 0.63 * points, level merges
~2.5x / ~3.5x / ~4x after.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

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


REFERENCE_SCALE_POINTS = (52_000, 96_000, 147_000, 180_000, 190_000)


def reference_scale_scenes() -> list:
    """A validation-size mix of ScanNet scans (52k-190k points; S3DIS caps
    its scenes at 180k) as collate's samples: synthetic_scene(n, seed=100 +
    i), superpoints from the x-rank // 64, dataset 0 (the JAX package's
    ``tests/test_reference_scale_budgets.py`` mix)."""
    samples = []
    for i, n in enumerate(REFERENCE_SCALE_POINTS):
        pts = synthetic_scene(n, seed=100 + i)
        sp = (np.argsort(np.argsort(pts[:, 0], kind="stable")) // 64).astype(np.int64)
        samples.append({"points": pts, "dataset_idx": 0, "sp_pts_mask": sp})
    return samples


# Superpoint trimming's group at the eval path's shapes: valid points of its
# 4 scenes, point slots (the bucket's max_points), boxes (topk_insts) and
# superpoints (max_superpoints).
TRIM_VALID = (52_000, 96_000, 147_000, 190_000)
TRIM_SLOTS, TRIM_BOXES, TRIM_SUPERPOINTS = 196_608, 1000, 3072


def trim_group(seed: int = 0, yawed: bool = False):
    """Superpoint trimming's inputs at the eval path's shapes: a group of 4
    scenes of TRIM_SLOTS point slots with TRIM_VALID valid (synthetic scans,
    superpoints of 64 points by x-rank), TRIM_BOXES boxes around valid
    points, and s = TRIM_SUPERPOINTS. Each scene also holds two line
    superpoints (ids s - 2, s - 1) of 100 and 50 points with boxes 0-3 over
    exactly 81 and 82 of the 100 and 9 and 8 of the 50 (the vote's fractions
    at its thresholds 0.81 and 0.18), boxes 4-19 far from every point, and
    invalid slots at random places with random ids up to s + 7. Yaw 0
    unless `yawed`. Returns numpy (points (4, P, 3) float32, valid (4, P)
    bool, sp_ids (4, P) int32, boxes (4, K, 7) float32)."""
    rng = np.random.RandomState(seed)
    b, slots, k, s = len(TRIM_VALID), TRIM_SLOTS, TRIM_BOXES, TRIM_SUPERPOINTS
    points = (rng.rand(b, slots, 3) * 8).astype(np.float32)
    valid = np.zeros((b, slots), bool)
    sp_ids = rng.randint(0, s + 8, (b, slots)).astype(np.int32)
    boxes = np.zeros((b, k, 7), np.float32)
    x = np.arange(150.0) - np.r_[np.zeros(100), np.full(50, 100.0)]
    yz = np.r_[np.full(100, 50.0), np.full(50, 60.0)]
    line = np.stack([x, yz, yz], 1)
    for i, n in enumerate(TRIM_VALID):
        pts = synthetic_scene(n - len(line), seed=seed + i)[:, :3]
        points[i, :n] = np.concatenate([pts, line])
        valid[i, :n] = True
        sp_ids[i, :n] = np.r_[stripe_superpoints(pts, 64), np.full(100, s - 2),
                              np.full(50, s - 1)]
        boxes[i, :, :3] = pts[rng.randint(0, len(pts), k)] + rng.randn(k, 3) * 0.1
        boxes[i, :, 3:6] = 0.1 + rng.rand(k, 3) * 2
        for j, (hi, at) in enumerate(((80.5, 50.0), (81.5, 50.0), (8.5, 60.0), (7.5, 60.0))):
            boxes[i, j, :6] = [(hi - 0.5) / 2, at, at, hi + 0.5, 0.5, 0.5]
        boxes[i, 4:20, :3] += 100.0
        if yawed:
            boxes[i, :, 6] = rng.uniform(-np.pi, np.pi, k)
    return points, valid, sp_ids, boxes


# Superpoint pooling's batch at the staged training cell's shapes: 8 scenes
# of POOL_SLOTS point slots, ScanNet's 52k-190k valid points and four scenes
# of 100k (the other datasets' cap), ~44 % of the slots padding.
POOL_VALID = TRIM_VALID + (100_000,) * 4
POOL_SLOTS, POOL_VOXELS = 196_608, 163_840


def pool_batch(seed: int = 0):
    """``pool_superpoints``' inputs at the staged cell's shapes: scene i
    holds POOL_VALID[i] points of synthetic_scene(seed + i) in a random
    order at the front of its POOL_SLOTS (padding after), their 2 cm voxels
    numbered over the batch in the order of their keys, superpoints of 64
    points by x-rank (S = TRIM_SUPERPOINTS), and post-ReLU random features
    of 32 channels in the voxel rows (zeros past them). Returns numpy
    (feats (B * POOL_VOXELS, 32) float32, pinv (B * POOL_SLOTS,) int32 with
    the sentinel B * POOL_VOXELS, sp_flat (B * POOL_SLOTS,) int64 with the
    sentinel B * S, B * S)."""
    rng = np.random.RandomState(seed)
    b, s = len(POOL_VALID), TRIM_SUPERPOINTS
    v0 = b * POOL_VOXELS
    pinv = np.full(b * POOL_SLOTS, v0, np.int32)
    sp_flat = np.full(b * POOL_SLOTS, b * s, np.int64)
    n_vox = 0
    for i, n in enumerate(POOL_VALID):
        pts = synthetic_scene(n, seed=seed + i)[rng.permutation(n), :3]
        _, inv = np.unique(np.floor(pts / 0.02).astype(np.int64), axis=0, return_inverse=True)
        at = i * POOL_SLOTS
        pinv[at:at + n] = n_vox + inv.reshape(-1)
        n_vox += int(inv.max()) + 1
        sp_flat[at:at + n] = i * s + np.minimum(stripe_superpoints(pts, 64), s - 1)
    feats = np.zeros((v0, 32), np.float32)
    feats[:n_vox] = np.maximum(rng.randn(n_vox, 32), 0.0)
    return feats, pinv, sp_flat, b * s


def coherent_scene(name: str, seed: int = 0, sp_per_inst: int = 4, n_bg_sp: int = 18,
                   inst_points: int = 300, bg_points: int = 1100) -> dict:
    """A geometrically coherent ScanNet scene for `write_info_dataset`: 3
    compact, well-separated box-volume instances of `inst_points` points
    each (raw nyu40 ids 3 + i, labels i), each split by x-rank into
    `sp_per_inst` superpoints that lie inside it, and `bg_points` of floor
    and one wall (nyu40 ids 1-2) in `n_bg_sp` x-bands of superpoints, in a
    5 m room; colors in [0, 255]. Every superpoint belongs to one instance or
    to the background, so a model can learn which superpoints form each
    instance: the data that an overfitting check needs. With the default
    sizes it is the JAX package's ``tests/test_data_pipeline.py::
    make_coherent_scene`` for the same seed (the same draws, the same
    files)."""
    n_inst = 3
    rng = np.random.RandomState(seed)
    centers = np.array([[1.2, 1.2, 0.8], [3.6, 1.4, 0.7], [2.3, 3.7, 0.9]], np.float32
                       ) + rng.uniform(-0.2, 0.2, (n_inst, 3)).astype(np.float32)
    sizes = np.array([[1.2, 1.0, 1.4], [1.0, 1.3, 1.1], [1.4, 1.1, 0.9]], np.float32)
    pts, inst, sem, sp = [], [], [], []
    for i in range(n_inst):
        p = (rng.rand(inst_points, 3).astype(np.float32) - 0.5) * sizes[i]
        p += centers[i]
        pts.append(p)
        inst.append(np.full(inst_points, i, np.int64))
        sem.append(np.full(inst_points, 3 + i, np.int64))
        ids = np.empty(inst_points, np.int64)
        ids[np.argsort(p[:, 0])] = np.arange(inst_points) * sp_per_inst // inst_points
        sp.append(i * sp_per_inst + ids)
    bg = rng.rand(bg_points, 3).astype(np.float32) * 5.0
    bg[: bg_points // 2, 2] = rng.rand(bg_points // 2).astype(np.float32) * 0.05
    bg[bg_points // 2:, 1] = rng.rand(bg_points - bg_points // 2).astype(np.float32) * 0.05
    pts.append(bg)
    inst.append(np.full(bg_points, -1, np.int64))
    sem.append(rng.randint(1, 3, bg_points).astype(np.int64))
    cell = np.clip((bg[:, 0] * 0.999 // (5.0 / n_bg_sp)), 0, n_bg_sp - 1)
    sp.append(n_inst * sp_per_inst + cell.astype(np.int64))

    xyz = np.concatenate(pts)
    points = np.zeros((len(xyz), 6), np.float32)
    points[:, :3] = xyz
    points[:, 3:] = rng.randint(0, 255, (len(xyz), 3))
    inst = np.concatenate(inst)
    boxes = []
    for i in range(n_inst):
        lo, hi = xyz[inst == i].min(0), xyz[inst == i].max(0)
        boxes.append(np.concatenate([(lo + hi) / 2, hi - lo]))
    return dict(name=name, points=points, instance_mask=inst,
                semantic_mask=np.concatenate(sem), super_points=np.concatenate(sp),
                axis_align_matrix=np.eye(4), boxes=np.asarray(boxes, np.float32).reshape(-1, 6),
                labels=np.arange(n_inst))


def write_coherent_dataset(root: str, n_scenes: int = 4, **sizes) -> str:
    """`n_scenes` coherent scenes (``coherent_scene``, seeds 0..n_scenes-1,
    named scene<i>) written under `root` with the info file infos.pkl;
    returns its path."""
    return write_info_dataset(
        root, [coherent_scene(f"scene{i}", seed=i, **sizes) for i in range(n_scenes)])


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


def reference_state_dict(planes, d_model: int, layers: int, n_cls: int, cin: int = 6,
                         seed: int = 0) -> dict:
    """A state dict with the reference model's exact key set and shapes
    (``unidet3d.pth``: spconv (Cout, k, k, k, Cin) kernels, BN with running
    statistics, ``nn.MultiheadAttention`` in_proj / out_proj, FFN and heads),
    filled with normal draws from one torch.Generator(seed) in key order, for
    the checkpoint converter's tests and the chip smoke."""
    sd = {}
    g = torch.Generator().manual_seed(seed)

    def w(*shape):
        return torch.randn(*shape, generator=g)

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = w(c)
        sd[f"{prefix}.bias"] = w(c)
        sd[f"{prefix}.running_mean"] = w(c)
        sd[f"{prefix}.running_var"] = w(c).abs() + 0.5

    def block(prefix, ci, co):
        bn(f"{prefix}.conv_branch.0", ci)
        sd[f"{prefix}.conv_branch.2.weight"] = w(co, 3, 3, 3, ci)
        bn(f"{prefix}.conv_branch.3", co)
        sd[f"{prefix}.conv_branch.5.weight"] = w(co, 3, 3, 3, co)
        if ci != co:
            sd[f"{prefix}.i_branch.0.weight"] = w(co, 1, 1, 1, ci)

    sd["input_conv.0.weight"] = w(planes[0], 3, 3, 3, cin)
    bn("output_layer.0", planes[0])
    for lvl in range(len(planes)):
        u = "unet." + "u." * lvl
        for i in range(2):
            block(f"{u}blocks.block{i}", planes[lvl], planes[lvl])
        if lvl < len(planes) - 1:
            bn(f"{u}conv.0", planes[lvl])
            sd[f"{u}conv.2.weight"] = w(planes[lvl + 1], 2, 2, 2, planes[lvl])
            bn(f"{u}deconv.0", planes[lvl + 1])
            sd[f"{u}deconv.2.weight"] = w(planes[lvl], 2, 2, 2, planes[lvl + 1])
            block(f"{u}blocks_tail.block0", planes[lvl] * 2, planes[lvl])
            block(f"{u}blocks_tail.block1", planes[lvl], planes[lvl])

    sd["decoder.input_proj.0.weight"] = w(d_model, planes[0])
    sd["decoder.input_proj.0.bias"] = w(d_model)
    sd["decoder.input_proj.2.weight"] = w(d_model, d_model)
    sd["decoder.input_proj.2.bias"] = w(d_model)
    for i in range(layers):
        attn = f"decoder.self_attn_layers.{i}"
        sd[f"{attn}.attn.in_proj_weight"] = w(3 * d_model, d_model)
        sd[f"{attn}.attn.in_proj_bias"] = w(3 * d_model)
        sd[f"{attn}.attn.out_proj.weight"] = w(d_model, d_model)
        sd[f"{attn}.attn.out_proj.bias"] = w(d_model)
        sd[f"{attn}.norm.weight"] = w(d_model)
        sd[f"{attn}.norm.bias"] = w(d_model)
        ffn = f"decoder.ffn_layers.{i}"
        sd[f"{ffn}.net.0.weight"] = w(4 * d_model, d_model)
        sd[f"{ffn}.net.0.bias"] = w(4 * d_model)
        sd[f"{ffn}.net.3.weight"] = w(d_model, 4 * d_model)
        sd[f"{ffn}.net.3.bias"] = w(d_model)
        sd[f"{ffn}.norm.weight"] = w(d_model)
        sd[f"{ffn}.norm.bias"] = w(d_model)
    sd["decoder.out_norm.weight"] = w(d_model)
    sd["decoder.out_norm.bias"] = w(d_model)
    sd["decoder.outs_cls.0.weight"] = w(d_model, d_model)
    sd["decoder.outs_cls.0.bias"] = w(d_model)
    sd["decoder.outs_cls.2.weight"] = w(n_cls, d_model)
    sd["decoder.outs_cls.2.bias"] = w(n_cls)
    sd["decoder.out_bboxes.linear.weight"] = w(8, d_model)
    sd["decoder.out_bboxes.linear.bias"] = w(8)
    return sd
