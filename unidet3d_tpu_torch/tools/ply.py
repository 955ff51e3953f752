"""Minimal PLY mesh reader (ascii + binary_little_endian), numpy only.

The port's own copy of the JAX package's ``tools/ply.py``. Replaces the
reference data-prep dependency on plyfile/open3d for reading
`*_vh_clean_2.ply`-style meshes (data/scannet/scannet_utils.py,
data/3rscan/utils.py). Supports the vertex properties used by the indoor
datasets (x y z [nx ny nz] [red green blue alpha] [label]) and triangular
face lists.
"""
from __future__ import annotations

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str):
    """Returns (vertex_data: dict[str, np.ndarray], faces: (F, 3) int32)."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype) | ('list', ...)])
        cur = None
        while True:
            line = f.readline().strip().decode("ascii")
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur = (name, int(cnt), [])
                elements.append(cur)
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append(("list", _TYPES[parts[2]], _TYPES[parts[3]], parts[4]))
                else:
                    cur[2].append((parts[2], _TYPES[parts[1]]))
            elif line == "end_header":
                break

        vertex_data = {}
        faces = np.zeros((0, 3), np.int32)
        for name, count, props in elements:
            has_list = any(p[0] == "list" for p in props)
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if not has_list:
                    arr = np.asarray(rows, np.float64)
                    for i, (pname, dt) in enumerate(props):
                        vertex_data_set(vertex_data, name, pname, arr[:, i].astype(dt))
                else:
                    fc = np.asarray(
                        [[int(v) for v in r[1:4]] for r in rows], np.int32
                    )
                    if name == "face":
                        faces = fc
            else:
                if not has_list:
                    dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                    arr = np.frombuffer(f.read(dt.itemsize * count), dt)
                    for pname, _ in props:
                        vertex_data_set(vertex_data, name, pname, arr[pname].copy())
                else:
                    # Assume a single list property (face indices).
                    _, cnt_t, idx_t, _ = props[0]
                    cnt_dt = np.dtype("<" + cnt_t)
                    idx_dt = np.dtype("<" + idx_t)
                    fc = np.empty((count, 3), np.int32)
                    for i in range(count):
                        n = int(
                            np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0]
                        )
                        idx = np.frombuffer(
                            f.read(idx_dt.itemsize * n), idx_dt
                        )
                        fc[i] = idx[:3]
                    if name == "face":
                        faces = fc
        return vertex_data, faces


def vertex_data_set(store, element, prop, arr):
    if element == "vertex":
        store[prop] = arr


def mesh_points_colors(vertex_data) -> np.ndarray:
    """(N, 6) [xyz rgb] from parsed vertex properties."""
    xyz = np.stack(
        [vertex_data["x"], vertex_data["y"], vertex_data["z"]], 1
    ).astype(np.float32)
    if "red" in vertex_data:
        rgb = np.stack(
            [vertex_data["red"], vertex_data["green"], vertex_data["blue"]], 1
        ).astype(np.float32)
    else:
        rgb = np.zeros_like(xyz)
    return np.concatenate([xyz, rgb], 1)
