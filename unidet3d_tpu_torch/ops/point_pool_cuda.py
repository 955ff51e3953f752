"""Point-to-superpoint pooling: the wrapper of ``csrc/point_pool.cu`` (G1).

``point_pool(feats, pinv, sp_flat, num_segments)`` is the mean, per
superpoint slot, of the voxel rows its points fall in, and the slot's point
count: what ``models/detector.py::pool_superpoints`` needs.

  * For CPU tensors it runs the plain version, ``point_pool_plain``: a gather
    of every point slot's voxel row (the sentinel voxel reads a zero row)
    and ``segment_mean``'s arithmetic, under autograd.
  * For CUDA tensors it runs ``PointPoolFunction``: ``pool_forward`` and
    ``pool_backward`` with the kernel's segmented row sum
    (``segment_rows_cuda``). Each direction sorts the point slots stably by
    its key (superpoint, then voxel), so each segment's rows are summed in
    slot order and padding slots, whose keys are the sentinels, are never
    read. Results equal the plain version's on the CPU bit for bit and
    repeat bit for bit. ``point_pool_cuda`` and ``point_pool_bwd_cuda``
    count their calls in ``launches``. With ``segment_rows_plain`` the same
    two functions are the kernel's arithmetic in PyTorch, its oracle.

Slots whose superpoint is outside [0, num_segments) are dropped, as
``segment_sum`` drops them; a slot whose voxel is the sentinel len(feats)
counts but adds nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .segment import segment_count, segment_sum
from .sparse_conv import gather_rows


def point_pool_plain(feats, pinv, sp_flat, num_segments: int):
    """(mean (num_segments, C), counts (num_segments,) fp32): the plain
    gather and segment mean, differentiable in `feats`."""
    total = segment_sum(gather_rows(feats, pinv), sp_flat, num_segments)
    counts = segment_count(sp_flat, num_segments)
    return total / counts[:, None].clamp(min=1.0), counts


def segments(keys, num_segments: int):
    """(order, off): the slots stably sorted by `keys`, and for each key k in
    [0, num_segments) its run order[off[k]:off[k + 1]], in slot order; other
    keys lie outside order[off[0]:off[-1]]."""
    sorted_keys, order = torch.sort(keys, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=keys.dtype, device=keys.device)
    return order, torch.searchsorted(sorted_keys, bounds)


def segment_rows_plain(rows, idx, off, mean: bool):
    """The kernel's arithmetic: (out (len(off) - 1, C), counts or None), out[s]
    the sum of rows[idx[j]] over j in [off[s], off[s + 1]) in j order (idx
    outside [0, len(rows)) adds nothing); with `mean`, divided by
    max(count, 1), and the counts."""
    size = off.diff()
    seg = torch.repeat_interleave(torch.arange(len(size), device=rows.device), size)
    member = idx[int(off[0]):int(off[-1])].long()
    keep = (member >= 0) & (member < len(rows))
    out = rows.new_zeros((len(size), rows.shape[1])).index_add_(0, seg[keep], rows[member[keep]])
    if not mean:
        return out, None
    counts = size.to(rows.dtype)
    return out / counts[:, None].clamp(min=1.0), counts


def pool_forward(feats, pinv, sp_flat, num_segments: int, rows_op=segment_rows_plain):
    """(mean, counts): each superpoint's voxel rows summed in slot order."""
    order, off = segments(sp_flat.to(torch.int32), num_segments)
    return rows_op(feats, pinv[order], off, True)


def pool_backward(g_mean, counts, pinv, sp_flat, n_vox: int, rows_op=segment_rows_plain):
    """The (n_vox, C) gradient of `feats`: each voxel's points' rows of
    g_mean / max(count, 1), in slot order."""
    g_sum = g_mean / counts[:, None].clamp(min=1.0)
    order, off = segments(pinv, n_vox)
    return rows_op(g_sum, sp_flat[order].to(torch.int32), off, False)[0]


@functools.cache
def _kernel():
    lib = cuda_build.load("point_pool")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.segment_rows
    fn.argtypes = [ptr, ptr, ptr, i64, i32, i64, ptr, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn


def segment_rows_cuda(rows, idx, off, mean: bool):
    """``segment_rows_plain`` as one launch on the current stream."""
    if rows.dim() != 2 or rows.dtype != torch.float32 or idx.dtype != torch.int32 \
            or off.dtype != torch.int64:
        raise ValueError(f"rows {tuple(rows.shape)} {rows.dtype}, idx {idx.dtype}, off "
                         f"{off.dtype} != (R, C) float32, int32, int64")
    for name, t in dict(rows=rows, idx=idx, off=off).items():
        if t.device.type != "cuda" or t.device != rows.device or not t.is_contiguous():
            raise ValueError(f"{name} on {t.device}: all contiguous on one CUDA device")
    n_seg, (n_rows, c) = len(off) - 1, rows.shape
    out = torch.empty((n_seg, c), dtype=torch.float32, device=rows.device)
    counts = torch.empty(n_seg, dtype=torch.float32, device=rows.device) if mean else None
    with torch.cuda.device(rows.device):
        err = _kernel()(rows.data_ptr(), idx.data_ptr(), off.data_ptr(), n_seg, c, n_rows,
                        out.data_ptr(), counts.data_ptr() if mean else None,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"point pool kernel launch failed: CUDA error {err}")
    return out, counts


def _check(feats, pinv, sp_flat):
    """Shapes, dtypes, one CUDA device, contiguity; raises ValueError."""
    if feats.dim() != 2 or feats.dtype != torch.float32 or feats.shape[1] < 1:
        raise ValueError(f"feats {tuple(feats.shape)} {feats.dtype} != (V, C) float32")
    if pinv.dim() != 1 or pinv.dtype != torch.int32:
        raise ValueError(f"pinv {tuple(pinv.shape)} {pinv.dtype} != (N,) int32")
    if tuple(sp_flat.shape) != tuple(pinv.shape) or sp_flat.dtype != torch.int64:
        raise ValueError(f"sp_flat {tuple(sp_flat.shape)} {sp_flat.dtype} != "
                         f"({len(pinv)},) int64")
    for name, t in dict(feats=feats, pinv=pinv, sp_flat=sp_flat).items():
        if t.device.type != "cuda" or t.device != feats.device:
            raise ValueError(f"{name} on {t.device}: all on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def point_pool_cuda(feats, pinv, sp_flat, num_segments: int):
    """G1's forward: (mean (num_segments, C), counts (num_segments,)) fp32.

    Args:
        feats: (V, C) float32 voxel rows.
        pinv: (N,) int32 voxel of each point slot (V: none).
        sp_flat: (N,) int64 superpoint slot of each point slot
            (num_segments and beyond: padding, skipped).
        num_segments: the superpoint slots, B * S.
    """
    _check(feats, pinv, sp_flat)
    out = pool_forward(feats, pinv, sp_flat, num_segments, segment_rows_cuda)
    point_pool_cuda.launches += 1
    return out


def point_pool_bwd_cuda(g_mean, counts, pinv, sp_flat, n_vox: int):
    """G1's backward: the (n_vox, C) float32 gradient of `feats` for the
    cotangent `g_mean` (num_segments, C) of the mean; `counts` as the
    forward returned them."""
    _check(g_mean, pinv, sp_flat)
    m = g_mean.shape[0]
    if tuple(counts.shape) != (m,) or counts.dtype != torch.float32 or not counts.is_contiguous():
        raise ValueError(f"counts {tuple(counts.shape)} {counts.dtype} != ({m},) "
                         "contiguous float32")
    grad = pool_backward(g_mean, counts, pinv, sp_flat, n_vox, segment_rows_cuda)
    point_pool_bwd_cuda.launches += 1
    return grad


point_pool_cuda.launches = 0
point_pool_bwd_cuda.launches = 0


class PointPoolFunction(torch.autograd.Function):
    """G1 under autograd: the forward and backward kernel calls; the counts
    carry no gradient."""

    @staticmethod
    def forward(ctx, feats, pinv, sp_flat, num_segments: int):
        mean, counts = point_pool_cuda(feats, pinv, sp_flat, num_segments)
        ctx.save_for_backward(counts, pinv, sp_flat)
        ctx.n_vox = feats.shape[0]
        ctx.mark_non_differentiable(counts)
        return mean, counts

    @staticmethod
    def backward(ctx, g_mean, _g_counts):
        counts, pinv, sp_flat = ctx.saved_tensors
        grad = point_pool_bwd_cuda(g_mean.contiguous(), counts, pinv, sp_flat, ctx.n_vox)
        return grad, None, None, None


def point_pool(feats, pinv, sp_flat, num_segments: int):
    """(mean (num_segments, C), counts (num_segments,)): the kernel for CUDA
    tensors, the plain version for CPU ones."""
    if feats.device.type == "cpu":
        return point_pool_plain(feats, pinv, sp_flat, num_segments)
    return PointPoolFunction.apply(feats, pinv, sp_flat, num_segments)
