"""Mask attention: OneFormer3D's cross-attention, where query i may attend to
key j only where bit (i, j) of a packed per-scene bitmask is set.

  * ``pack_bits``: a (B, Lq, Lk) bool mask as (B, Lq, ceil(Lk / 32)) int32
    words, bit j % 32 of word j / 32 for key j (the layout M1 reads);
  * ``mask_attention_cuda``: M1 (``csrc/mask_attention.cu``), bf16 on the
    tensor cores, for CUDA tensors; for CPU tensors the plain version,
    ``mask_attention_plain``, a dense masked softmax. ``launches`` counts
    the kernel's launches.

Queries and keys have lengths of their own; per scene ``q_len`` / ``k_len``
bound the rows that hold queries and the keys worth visiting. A row with no
open bit, and every row at or past ``q_len``, gives zeros.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

HEAD_DIM = 32  # the kernel's compile-time head dim


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(B, Lq, Lk) bool -> (B, Lq, W) int32 words, W = ceil(Lk / 32); bit
    j % 32 of word j / 32 holds key j, the padding bits past Lk are 0."""
    b, lq, lk = mask.shape
    w = -(-lk // 32)
    m = torch.nn.functional.pad(mask, (0, w * 32 - lk)).view(b, lq, w, 32)
    shifts = torch.arange(32, dtype=torch.int32, device=mask.device)
    # Distinct powers of two: their int32 sum is their OR (bit 31 wraps to
    # the sign, as the kernel's uint32 reads it).
    return (m.int() << shifts).sum(-1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor, lk: int) -> torch.Tensor:
    """The inverse of ``pack_bits``: (B, Lq, W) int32 -> (B, Lq, lk) bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.flatten(-2)[..., :lk].bool()


def mask_attention_plain(q, k, v, bits, q_len, k_len, sm_scale: float):
    """softmax(q k^T * sm_scale over the open keys) v, fp32 sums, p rounded
    to the input dtype before the p v product (as K3's plain version and
    the kernel); rows with no open key, and rows at or past q_len, are 0.

    q: (B, H, Lq, D); k, v: (B, H, Lk, D); bits: (B, Lq, W) int32 from
    ``pack_bits``; q_len, k_len: (B,) int. Returns (B, H, Lq, D) in q's
    dtype."""
    lq, lk = q.shape[2], k.shape[2]
    rows = torch.arange(lq, device=q.device)[None, :] < q_len[:, None].to(q.device)
    keys = torch.arange(lk, device=q.device)[None, :] < k_len[:, None].to(q.device)
    open_ = unpack_bits(bits, lk) & rows[:, :, None] & keys[:, None, :]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    logits = logits.masked_fill(~open_[:, None], float("-inf"))
    m_row = logits.amax(-1, keepdim=True)
    m_row = torch.where(torch.isfinite(m_row), m_row, 0.0)
    p = torch.exp(logits - m_row)
    l_row = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float())
    out = torch.where(l_row > 0, out / l_row.clamp_min(1e-30), 0.0)
    return out.to(q.dtype)


@functools.cache
def _kernel():
    fn = cuda_build.load("mask_attention").mask_attention_fwd
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 7 + [i32] * 4 + [ctypes.c_float, ptr]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, bits, q_len, k_len):
    """The card wrapper's checks; returns (B, H, Lq, Lk)."""
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM or q.dtype != torch.bfloat16:
        raise ValueError(f"q {tuple(q.shape)} {q.dtype}: expected (B, H, Lq, {HEAD_DIM}) bf16")
    b, h, lq, _ = q.shape
    lk = k.shape[2] if k.dim() == 4 else -1
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, h, lk, HEAD_DIM) or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} != ({b}, {h}, Lk, "
                             f"{HEAD_DIM}) bf16 (k's Lk)")
    if tuple(bits.shape) != (b, lq, -(-lk // 32)) or bits.dtype != torch.int32:
        raise ValueError(f"bits {tuple(bits.shape)} {bits.dtype} != ({b}, {lq}, "
                         f"{-(-lk // 32)}) int32")
    for name, t in (("q_len", q_len), ("k_len", k_len)):
        if tuple(t.shape) != (b,) or t.dtype != torch.int32:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} != ({b},) int32")
    for name, t in dict(q=q, k=k, v=v, bits=bits, q_len=q_len, k_len=k_len).items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return b, h, lq, lk


def mask_attention_cuda(q, k, v, bits, q_len, k_len, sm_scale: float):
    """M1: masked cross-attention, (B, H, Lq, 32) queries over (B, H, Lk, 32)
    keys and values -> (B, H, Lq, 32).

    Args:
        q: (B, H, Lq, 32) bf16; k, v: (B, H, Lk, 32) bf16; contiguous.
        bits: (B, Lq, ceil(Lk / 32)) int32 from ``pack_bits``.
        q_len, k_len: (B,) int32, the rows holding queries and the keys
            worth visiting of each scene.
        sm_scale: logit scale (1/sqrt(32) in the decoder).

    Returns:
        (B, H, Lq, 32) bf16.
    """
    if q.device.type == "cpu":
        return mask_attention_plain(q, k, v, bits, q_len, k_len, sm_scale)
    b, h, lq, lk = _check(q, k, v, bits, q_len, k_len)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bits.data_ptr(), q_len.data_ptr(),
            k_len.data_ptr(), out.data_ptr(), b, h, lq, lk, float(sm_scale),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"mask attention kernel launch failed: CUDA error {err}")
    mask_attention_cuda.launches += 1
    return out


mask_attention_cuda.launches = 0
