"""Segment-masked attention of the reference: the port's plain forward and
backward (``ops/attention.py``), no kernel; p and ds are rounded where the
port's kernels round them (``precision.rnd``: the identity in fp32)."""
from __future__ import annotations

import torch

from ..precision import rnd


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
    out = torch.einsum("bhqk,bhkd->bhqd", rnd(p), v.float()) / l_row
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
    dv = torch.einsum("bhqk,bhqd->bhkd", rnd(p), do32)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v.float())
    ds = rnd(p * (dp - di[..., None]) * sm_scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


class AttentionFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, sm_scale: float):
        o, lse = attention_plain(q, k, v, seg, sm_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        do = rnd(do)
        di = (o.float() * do).sum(-1)
        dq, dk, dv = attention_bwd_plain(q, k, v, seg, do, lse, di, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, seg, sm_scale: float) -> torch.Tensor:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return AttentionFunction.apply(q, k, v, seg, sm_scale)
    return attention_plain(q, k, v, seg, sm_scale)
