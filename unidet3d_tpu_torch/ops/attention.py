"""Segment-masked attention: the wrapper of the Hopper flash-attention
kernel ``csrc/attention.cu`` and its plain version.

The port of the TPU flash attention that the JAX decoder calls
(``models/decoder.py::Attention``, ``SegmentIds(q=seg, kv=seg)``): query i
attends to key j only where ``seg[i] == seg[j]``. The decoder gives valid
queries segment 1 and padded ones segment 2.

For a CUDA tensor ``flash_attention_cuda`` launches the kernel or raises;
for a CPU tensor it runs ``attention_plain``. ``flash_attention_cuda.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

HEAD_DIM = 32  # the kernel's compile-time head dim
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_plain(q, k, v, seg, sm_scale: float) -> torch.Tensor:
    """softmax(q k^T * sm_scale, masked where seg_q != seg_k) v in fp32.

    q, k, v: (B, H, L, D); seg: (B, L) int. Returns (B, H, L, D) in q's
    dtype."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    same = seg[:, None, :, None] == seg[:, None, None, :]
    weights = torch.softmax(logits.masked_fill(~same, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v.float()).to(q.dtype)


@functools.cache
def _kernel():
    fn = cuda_build.load("attention").flash_attention_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, seg, sm_scale: float) -> torch.Tensor:
    """Segment-masked attention, (B, H, L, 32) q/k/v -> (B, H, L, 32).

    Args:
        q, k, v: (B, H, L, 32) fp32 or bf16 (one dtype), contiguous.
        seg: (B, L) int32 segment ids, contiguous.
        sm_scale: logit scale (1/sqrt(32) in the decoder).

    Returns:
        (B, H, L, 32) in the input dtype.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, seg, sm_scale)
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"q {tuple(q.shape)}: expected (B, H, L, {HEAD_DIM})")
    b, h, length, _ = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype} {k.dtype} {v.dtype}")
    if tuple(seg.shape) != (b, length) or seg.dtype != torch.int32:
        raise ValueError(f"seg {tuple(seg.shape)} {seg.dtype} != ({b}, {length}) int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("seg", seg)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            out.data_ptr(), b, h, length, float(sm_scale), _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
