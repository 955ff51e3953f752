"""ctypes binding of the native mesh segmentator (superpoints for data
preparation, ``native/segmentator.cc``).

The counterpart of the reference's ``segmentator.segment_mesh(vertices,
faces)``, used offline by ``tools/create_data.py``,
``tools/prep_datasets.py`` and ``tools/arkitscenes_loader.py``; the defaults
are the standard ScanNet parameters (kThresh 0.01, minVerts 20). The library
is compiled with g++ the first time it is needed, into
``build/libunidet3d_segmentator-<hash>.so`` at the repository root
(``native/build.py``), with the JAX package's flags (no ``-march=native``),
so that its float arithmetic, and with it the segments, is the same. A
failed build raises with the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from . import build as native_build

SRC = Path(__file__).resolve().with_name("segmentator.cc")
BUILD_DIR = native_build.BUILD_DIR
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
STEM = "libunidet3d_segmentator"

_P = ctypes.c_void_p


def library_path(src: Path = SRC) -> Path:
    """Where the library of `src` is built."""
    return native_build.library_path(src, STEM, CXX_FLAGS, BUILD_DIR)


def build(src: Path = SRC) -> Path:
    """Compiles `src` unless its library exists; returns the library's path.
    Raises RuntimeError with the compiler's output if g++ is missing or
    fails."""
    return native_build.build_library(src, STEM, CXX_FLAGS, BUILD_DIR)


@functools.cache
def load(src: Path = SRC) -> ctypes.CDLL:
    """The segmentator's library, built first if needed."""
    lib = ctypes.CDLL(str(build(src)))
    lib.unidet3d_segment_mesh.argtypes = (_P, ctypes.c_int64, _P, ctypes.c_int64,
                                          ctypes.c_float, ctypes.c_int32, _P)
    lib.unidet3d_segment_mesh.restype = ctypes.c_int32
    return lib


def segment_mesh(vertices: np.ndarray, faces: np.ndarray, kthr: float = 0.01,
                 seg_min_verts: int = 20) -> np.ndarray:
    """(V, 3) vertices + (F, 3) triangle vertex indices -> (V,) int32
    segment ids, compacted in vertex order."""
    vertices = np.ascontiguousarray(vertices, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise ValueError(f"vertices {vertices.shape} must be (V, 3)")
    if faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"faces {faces.shape} must be (F, 3)")
    if faces.size and (faces.min() < 0 or faces.max() >= len(vertices)):
        raise ValueError(f"face indices outside [0, {len(vertices)})")
    out = np.empty(len(vertices), np.int32)
    load().unidet3d_segment_mesh(
        vertices.ctypes.data, len(vertices), faces.ctypes.data, len(faces),
        float(kthr), int(seg_min_verts), out.ctypes.data)
    return out
