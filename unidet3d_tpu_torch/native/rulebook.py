"""ctypes binding of the native GridPack builder (``native/rulebook.cc``).

The library is compiled with g++ the first time it is needed, into
``build/libunidet3d_rulebook-<hash>.so`` at the repository root; the hash
covers the source and the flags, so an edited source is rebuilt and a stale
library (``-march=native`` binds it to the host) never loads. Nothing builds
at import. A failed build raises with the compiler's output: there is no
fallback to the numpy builder, whose 5-10x slower tables would only show as
a slow loader.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

import numpy as np

from ..ops.gridpack import GridPack

SRC = Path(__file__).resolve().with_name("rulebook.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_P = ctypes.c_void_p
_ARGTYPES = (_P, _P, ctypes.c_int64, _P, ctypes.c_int32, ctypes.c_int32,
             _P, _P, ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_P),
             ctypes.POINTER(_P))


def library_path(src: Path = SRC) -> Path:
    """Where the library of `src` is built: its name hashes the source and
    the flags."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libunidet3d_rulebook-{digest.hexdigest()[:12]}.so"


def build(src: Path = SRC) -> Path:
    """Compiles `src` unless its library exists; returns the library's path.
    Raises RuntimeError with the compiler's output if g++ is missing or
    fails. The library is written under a temporary name and renamed, so
    processes building at once never load a partial file."""
    lib = library_path(src)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(
            f"g++ not found: the native rulebook builder ({src.name}) cannot be "
            "compiled") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load(src: Path = SRC) -> ctypes.CDLL:
    """The builder's library, built first if needed."""
    lib = ctypes.CDLL(str(build(src)))
    lib.unidet3d_build_gridpack.argtypes = _ARGTYPES
    lib.unidet3d_build_gridpack.restype = None
    return lib


def _ptrs(arrays):
    return (_P * len(arrays))(*(a.ctypes.data for a in arrays))


def build_gridpack(bxyz: np.ndarray, valid: np.ndarray, caps: Sequence[int],
                   n_threads: int | None = None):
    """The native GridPack build, with the contract of
    ``ops/gridpack.py::build_gridpack_numpy``: (N, 4) int (batch, x, y, z)
    points, their (N,) validity and the voxel capacity of each level ->
    (GridPack of numpy arrays with host-int n_valid, counts0 (V_0,) float32
    point counts). Every row of every table equals the numpy builder's.
    `n_threads` (default: the host's cores, at most 16) spreads the build's
    loops; the call releases the GIL."""
    bxyz = np.ascontiguousarray(bxyz, np.int32)
    valid = np.ascontiguousarray(valid, np.uint8)
    n = bxyz.shape[0]
    if bxyz.shape != (n, 4) or valid.shape != (n,):
        raise ValueError(f"bxyz {bxyz.shape} must be (N, 4), valid {valid.shape} (N,)")
    caps = [int(c) for c in caps]
    if not caps or min(caps) <= 0:
        raise ValueError(f"capacities {caps} must be positive")
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)

    point_inverse = np.empty(n, np.int32)
    counts0 = np.empty(caps[0], np.float32)
    valids = [np.empty(c, np.uint8) for c in caps]
    neighbors = [np.empty((c, 27), np.int32) for c in caps]
    parents = [np.empty(c, np.int32) for c in caps[:-1]]
    offsets = [np.empty(c, np.int32) for c in caps[:-1]]
    cap_arr = np.asarray(caps, np.int64)
    load().unidet3d_build_gridpack(
        bxyz.ctypes.data, valid.ctypes.data, n, cap_arr.ctypes.data, len(caps),
        int(n_threads), point_inverse.ctypes.data, counts0.ctypes.data,
        _ptrs(valids), _ptrs(neighbors), _ptrs(parents) if parents else None,
        _ptrs(offsets) if offsets else None,
    )
    valid_levels = tuple(v.view(bool) for v in valids)
    pack = GridPack(
        valid=valid_levels,
        neighbors=tuple(neighbors),
        parent=tuple(parents),
        offset_code=tuple(offsets),
        point_inverse=point_inverse,
        n_valid=tuple(int(v.sum()) for v in valid_levels),
    )
    return pack, counts0
