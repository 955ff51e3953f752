"""Superpoint box trimming on the card: the wrapper of ``csrc/sp_trim.cu``.

``sp_trim_cuda`` refits a group's detection boxes to the points that the
superpoint vote leaves inside them, as
``models/postprocess.py::trim_boxes_by_superpoints`` (the plain version, the
CPU's path and the tests' oracle) does one scene at a time, with no (point,
box) tensor in device memory. It takes CUDA tensors only and raises on
anything the kernel does not take; ``launches`` counts its calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build


@functools.cache
def _kernel():
    lib = cuda_build.load("sp_trim")
    fn = lib.sp_trim
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    size = lib.sp_trim_workspace_bytes
    size.argtypes = [ctypes.c_int] * 4
    size.restype = ctypes.c_longlong
    return fn, size


def _check(points, point_valid, sp_ids, boxes, num_superpoints):
    """Shapes, dtypes, one CUDA device, contiguity; raises ValueError."""
    if points.dim() != 3 or points.shape[2] != 3 or points.dtype != torch.float32:
        raise ValueError(f"points {tuple(points.shape)} {points.dtype} != (B, P, 3) float32")
    b, p = points.shape[:2]
    if tuple(point_valid.shape) != (b, p) or point_valid.dtype != torch.bool:
        raise ValueError(f"point_valid {tuple(point_valid.shape)} {point_valid.dtype} != "
                         f"({b}, {p}) bool")
    if tuple(sp_ids.shape) != (b, p) or sp_ids.dtype != torch.int32:
        raise ValueError(f"sp_ids {tuple(sp_ids.shape)} {sp_ids.dtype} != ({b}, {p}) int32")
    if (boxes.dim() != 3 or boxes.shape[0] != b or boxes.shape[2] != 7
            or boxes.dtype != torch.float32):
        raise ValueError(f"boxes {tuple(boxes.shape)} {boxes.dtype} != ({b}, K, 7) float32")
    if b == 0 or int(num_superpoints) < 1:
        raise ValueError(f"{b} scenes, {num_superpoints} superpoints: need at least one each")
    named = dict(points=points, point_valid=point_valid, sp_ids=sp_ids, boxes=boxes)
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != points.device:
            raise ValueError(f"{name} on {t.device}: all on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def sp_trim_cuda(
    points: torch.Tensor,
    point_valid: torch.Tensor,
    sp_ids: torch.Tensor,
    boxes: torch.Tensor,
    num_superpoints: int,
    low_thr: float,
    up_thr: float,
):
    """Trims each scene's boxes by the superpoint vote, on the card.

    Args:
        points: (B, P, 3) float32, the scenes' raw point coordinates.
        point_valid: (B, P) bool.
        sp_ids: (B, P) int32 superpoint ids, clamped to [0, S) as the plain
            version clamps them; invalid points belong to none.
        boxes: (B, K, 7) float32 (centre, size, yaw).
        num_superpoints: S, the group's ``max_superpoints``.
        low_thr, up_thr: the vote's thresholds (``low_sp_thr``,
            ``up_sp_thr``), compared in float32.

    Returns:
        (B, K, 7) float32 refitted boxes (yaw 0; zeros where no point is
        inside) and (B, K) bool, whether any point ends inside: what
        ``trim_boxes_by_superpoints`` returns before ``keep & has``.
    """
    _check(points, point_valid, sp_ids, boxes, num_superpoints)
    b, p = points.shape[:2]
    k, s = boxes.shape[1], int(num_superpoints)
    dev = points.device
    out = torch.empty((b, k, 7), dtype=torch.float32, device=dev)
    has = torch.empty((b, k), dtype=torch.bool, device=dev)
    fn, size = _kernel()
    workspace = torch.empty(size(b, p, k, s), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = fn(points.data_ptr(), point_valid.data_ptr(), sp_ids.data_ptr(),
                 boxes.data_ptr(), b, p, k, s, float(low_thr), float(up_thr),
                 out.data_ptr(), has.data_ptr(), workspace.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sp_trim kernel launch failed: CUDA error {err}")
    sp_trim_cuda.launches += 1
    return out, has


sp_trim_cuda.launches = 0
