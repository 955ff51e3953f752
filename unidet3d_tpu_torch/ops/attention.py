"""Segment-masked attention: the wrappers of the Hopper flash-attention
kernels, their plain versions, and the differentiable attention built from
them.

The port of the TPU flash attention that the JAX decoder calls
(``models/decoder.py::Attention``, ``SegmentIds(q=seg, kv=seg)``): query i
attends to key j only where ``seg[i] == seg[j]``. The decoder gives valid
queries segment 1 and padded ones segment 2.

  * ``flash_attention_cuda``: K3, the forward (``csrc/attention.cu``; in
    bf16 on the tensor cores, in fp32 an FMA kernel); it also returns the
    per-row logsumexp when asked, for the backward.
  * ``flash_attention_dkv_cuda`` / ``flash_attention_dq_cuda``: K3's backward
    (``csrc/attention_bwd.cu``), the ports of ``_flash_attention_bwd_dkv``
    and ``_flash_attention_bwd_dq`` of the TPU flash attention.
  * ``FlashAttentionFunction`` / ``flash_attention``: the autograd Function
    around the three, and the decoder's entry point.

For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it runs the plain version (``attention_plain``,
``attention_bwd_plain``). Each wrapper's ``launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

HEAD_DIM = 32  # the kernels' compile-time head dim
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _masked_logits(q, k, seg, sm_scale):
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    same = seg[:, None, :, None] == seg[:, None, None, :]
    return logits.masked_fill(~same, float("-inf"))


def attention_plain(q, k, v, seg, sm_scale: float, return_lse: bool = False):
    """softmax(q k^T * sm_scale, masked where seg_q != seg_k) v, fp32 sums:
    o = (round(p) v) / l with p = exp(s - m_row), l = rowsum(p).

    It rounds where the TPU forward does (``flash_attention.py:470-471``,
    ``p.astype(v.dtype)`` before the p v product, while the row sum l takes
    the unrounded fp32 p, :453): p to the input dtype before the product,
    the identity in fp32. A query always meets its own key, so m_row is
    finite.

    q, k, v: (B, H, L, D); seg: (B, L) int. Returns (B, H, L, D) in q's
    dtype, and with `return_lse` also the (B, H, L) fp32 row logsumexp of
    the masked scaled scores."""
    logits = _masked_logits(q, k, seg, sm_scale)
    m_row = logits.amax(-1, keepdim=True).detach()
    p = torch.exp(logits - m_row)
    l_row = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float()) / l_row
    if return_lse:
        return out.to(q.dtype), torch.logsumexp(logits, dim=-1)
    return out.to(q.dtype)


def attention_bwd_plain(q, k, v, seg, do, lse, di, sm_scale: float):
    """The flash-attention backward in plain PyTorch, from the forward's lse:
    p = exp(s - lse) (0 across segments), ds = p * (do v^T - di) * scale,
    dv = p^T do, dq = ds k, dk = ds^T q; fp32 sums.

    It rounds where the TPU kernels do (``flash_attention.py:900``,
    ``:913-918``, ``:1247-1261``): p to the input dtype before dv, and
    ds * scale before dq and dk. For fp32 inputs the rounding is the
    identity.

    q, k, v, do: (B, H, L, D); seg: (B, L); lse, di: (B, H, L) fp32 with
    di = rowsum(o * do). Returns (dq, dk, dv) in q's dtype."""
    p = torch.exp(_masked_logits(q, k, seg, sm_scale) - lse[..., None])
    do32 = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v.float())
    ds = (p * (dp - di[..., None]) * sm_scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def attention_tol(ref) -> dict:
    """rtol and atol for a card kernel's output against its plain version
    `ref` (in the inputs' dtype), as ``torch.testing.assert_close`` takes
    them. fp32: 1e-4, the same fp32 sums in another order. bf16: one bf16
    ulp of each value (2^-7: 8 bits of mantissa) for the output's own
    rounding, plus 2^-8 of the largest value: the backward rounds p and
    ds * scale to bf16 before its products on both sides, and where the two
    fp32 values straddle a rounding point (sums in another order, the
    kernel's ex2.approx) one term moves by one bf16 ulp of itself. On an
    H100 at the decoder's training shape, 1 to 11 of the 6.3M values of
    each of dq, dk, dv exceed 1e-4 of the largest value and none 2^-8 of
    it; a dropped mask or scale misses by ~100 %. The forward rounds p to
    bf16 too, relative to a running max (the kernel's per 64-key tile, the
    TPU's per 128-key block) where the plain version takes the row max, so
    the two round some p apart and o moves by ~2^-10 of its scale: on an
    NVIDIA H100 80GB HBM3 (700 W) at the decoder's shapes the largest
    difference, 3.9e-3 (2^-8, a bf16 ulp of a value in [0.5, 1)), is inside
    the same bound, which needs no restating."""
    if ref.dtype == torch.float32:
        return dict(rtol=1e-4, atol=1e-4)
    return dict(rtol=2.0 ** -7, atol=2.0 ** -8 * ref.float().abs().max().item())


@functools.cache
def _kernel():
    fn = cuda_build.load("attention").flash_attention_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernels():
    lib = cuda_build.load("attention_bwd")
    dkv, dq = lib.flash_attention_bwd_dkv, lib.flash_attention_bwd_dq
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    tail = [i32, i32, i32, ctypes.c_float, i32, ptr]
    dkv.argtypes = [ptr] * 9 + tail
    dq.argtypes = [ptr] * 8 + tail
    dkv.restype = dq.restype = ctypes.c_int
    return dkv, dq


def _check(q, k, v, seg, **extra):
    """Shared checks of the card wrappers; returns (B, H, L)."""
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"q {tuple(q.shape)}: expected (B, H, L, {HEAD_DIM})")
    b, h, length, _ = q.shape
    same = {"k": k, "v": v, **{n: t for n, t in extra.items() if t.dim() == 4}}
    for name, t in same.items():
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(
                f"{name} {tuple(t.shape)} {t.dtype} != q {tuple(q.shape)} {q.dtype}"
            )
    if q.dtype not in _DTYPES:
        raise ValueError(f"q dtype {q.dtype}: fp32 or bf16")
    if tuple(seg.shape) != (b, length) or seg.dtype != torch.int32:
        raise ValueError(f"seg {tuple(seg.shape)} {seg.dtype} != ({b}, {length}) int32")
    for name, t in extra.items():
        if t.dim() == 3 and (tuple(t.shape) != (b, h, length)
                             or t.dtype != torch.float32):
            raise ValueError(
                f"{name} {tuple(t.shape)} {t.dtype} != ({b}, {h}, {length}) fp32"
            )
    for name, t in dict(q=q, k=k, v=v, seg=seg, **extra).items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return b, h, length


def flash_attention_cuda(q, k, v, seg, sm_scale: float, return_lse: bool = False):
    """K3: segment-masked attention, (B, H, L, 32) q/k/v -> (B, H, L, 32).

    Args:
        q, k, v: (B, H, L, 32) fp32 or bf16 (one dtype), contiguous.
        seg: (B, L) int32 segment ids, contiguous.
        sm_scale: logit scale (1/sqrt(32) in the decoder).
        return_lse: also return the (B, H, L) fp32 row logsumexp.

    Returns:
        (B, H, L, 32) in the input dtype [, lse].
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, seg, sm_scale, return_lse)
    b, h, length = _check(q, k, v, seg)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, length), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), b, h,
            length, float(sm_scale), _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def flash_attention_dkv_cuda(q, k, v, seg, do, lse, di, sm_scale: float):
    """K3-dkv: (dk, dv) of the segment-masked attention.

    Args:
        q, k, v, do: (B, H, L, 32), one dtype (fp32 or bf16), contiguous;
            do is the cotangent of the output.
        seg: (B, L) int32.
        lse: (B, H, L) fp32 from the forward; di: (B, H, L) fp32,
            rowsum(o * do).

    Returns:
        (dk, dv), (B, H, L, 32) in the input dtype.
    """
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, seg, do, lse, di, sm_scale)[1:]
    b, h, length = _check(q, k, v, seg, do=do, lse=lse, di=di)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _bwd_kernels()[0](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            do.data_ptr(), lse.data_ptr(), di.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, length, float(sm_scale), _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention dkv kernel launch failed: CUDA error {err}")
    flash_attention_dkv_cuda.launches += 1
    return dk, dv


flash_attention_dkv_cuda.launches = 0


def flash_attention_dq_cuda(q, k, v, seg, do, lse, di, sm_scale: float):
    """K3-dq: dq of the segment-masked attention; arguments as for
    ``flash_attention_dkv_cuda``. Returns (B, H, L, 32) in the input dtype."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, seg, do, lse, di, sm_scale)[0]
    b, h, length = _check(q, k, v, seg, do=do, lse=lse, di=di)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _bwd_kernels()[1](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(), b, h,
            length, float(sm_scale), _DTYPES[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention dq kernel launch failed: CUDA error {err}")
    flash_attention_dq_cuda.launches += 1
    return dq


flash_attention_dq_cuda.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """K3 with its backward: the forward keeps q, k, v, seg, o and the row
    logsumexp; the backward computes di = rowsum(o * do) in fp32 (a torch op,
    as the TPU version leaves it to XLA), then K3-dkv and K3-dq."""

    @staticmethod
    def forward(ctx, q, k, v, seg, sm_scale: float):
        o, lse = flash_attention_cuda(q, k, v, seg, sm_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        di = (o.float() * do.float()).sum(-1)
        args = (q, k, v, seg, do, lse, di, ctx.sm_scale)
        dk, dv = flash_attention_dkv_cuda(*args)
        dq = flash_attention_dq_cuda(*args)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, seg, sm_scale: float) -> torch.Tensor:
    """Segment-masked attention for the decoder: the differentiable Function
    when a gradient is being recorded, else K3 alone (no lse written)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, seg, sm_scale)
    return flash_attention_cuda(q, k, v, seg, sm_scale)
