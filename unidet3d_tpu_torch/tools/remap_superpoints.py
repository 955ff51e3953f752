"""Reorder superpoint ids to match a point ordering (S3DIS prep).

The port's own copy of the JAX package's ``tools/remap_superpoints.py``, the
counterpart of the reference's data/s3dis/remap_superpoints.py: given superpoints
computed on a differently-ordered copy of the points, align them to the
canonical point order by exact-coordinate matching, then compact ids.

Usage:
  python -m unidet3d_tpu_torch.tools.remap_superpoints points.bin sp_points.bin \
      superpoints.bin out.bin
"""
from __future__ import annotations

import argparse

import numpy as np


def remap_superpoints(
    points: np.ndarray, sp_points: np.ndarray, superpoints: np.ndarray
) -> np.ndarray:
    """For each row of `points`, take the superpoint of the identical row in
    `sp_points` (exact coordinate match via lexicographic sort)."""
    a = np.ascontiguousarray(points[:, :3]).view(
        [("x", np.float32), ("y", np.float32), ("z", np.float32)]
    ).reshape(-1)
    b = np.ascontiguousarray(sp_points[:, :3]).view(
        [("x", np.float32), ("y", np.float32), ("z", np.float32)]
    ).reshape(-1)
    order_b = np.argsort(b)
    pos = np.searchsorted(b[order_b], a)
    pos = np.clip(pos, 0, len(b) - 1)
    matched = b[order_b[pos]] == a
    out = superpoints[order_b[pos]]
    out = np.where(matched, out, -1)
    # Unmatched points get fresh singleton ids, then compact.
    n_miss = int((~matched).sum())
    if n_miss:
        out[~matched] = superpoints.max() + 1 + np.arange(n_miss)
    return np.unique(out, return_inverse=True)[1].astype(np.int64)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Carry superpoints across point orders")
    ap.add_argument("points_bin")
    ap.add_argument("sp_points_bin")
    ap.add_argument("superpoints_bin")
    ap.add_argument("out_bin")
    args = ap.parse_args(argv)
    pts = np.fromfile(args.points_bin, np.float32).reshape(-1, 6)
    sp_pts = np.fromfile(args.sp_points_bin, np.float32).reshape(-1, 6)
    sp = np.fromfile(args.superpoints_bin, np.int64)
    out = remap_superpoints(pts, sp_pts, sp)
    out.tofile(args.out_bin)
    print(f"remapped {len(out)} superpoint labels -> {args.out_bin}")
    return out


if __name__ == "__main__":
    main()
