"""Superpoint transformer decoder with unified multi-dataset heads.

The port of the JAX package's ``models/decoder.py``: an input projection,
N x (self-attention + FFN), post-norm, and the per-dataset class / box heads
after the projection and after every layer (L = N + 1 output sets). The
attention runs the Hopper flash-attention kernels (``ops/attention.py``: K3
forward, K3-dkv and K3-dq backward) on the card. In training, dropout
(flax ``nn.Dropout``) follows the attention output and the FFN's activation
and fc2, with masks drawn from the caller's generator. Flax conventions
kept: ``nn.gelu`` is the tanh approximation, ``nn.LayerNorm`` eps is 1e-6,
masked class columns are -1e9.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention
from ..precision import cast

NEG_INF = -1e9
LN_EPS = 1e-6


class DecoderOutput(NamedTuple):
    """cls_logits: (L, B, Q, NC_MAX + 1) per-dataset gathered logits, padded
    class columns NEG_INF, no_obj at column NC_MAX; boxes: (L, B, Q, 7)."""

    cls_logits: torch.Tensor
    boxes: torch.Tensor


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` in training: each value kept with
    probability 1 - rate and scaled by 1 / (1 - rate), else 0; the mask is
    drawn from `generator` on its own device, then moved to x's. Rate 0 draws
    nothing and returns x."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=generator.device) < keep_prob
    return torch.where(keep.to(x.device), x / keep_prob, x.new_zeros(()))


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A Dense layer computed in `dtype` (flax ``nn.Dense(dtype=...)``)."""
    return F.linear(cast(x), cast(layer.weight), cast(layer.bias))


class Attention(nn.Module):
    """Multi-head self-attention with segment-id masking (query/key/value/out
    projections as in flax MultiHeadDotProductAttention)."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        b, length, d = x.shape
        h = self.num_heads
        hd = d // h

        def heads(layer):
            y = linear(x, layer, self.dtype).view(b, length, h, hd)
            return y.transpose(1, 2).contiguous()

        o = flash_attention(
            heads(self.query), heads(self.key), heads(self.value), seg,
            1.0 / (hd ** 0.5),
        )
        return linear(o.transpose(1, 2).reshape(b, length, d), self.out, self.dtype)


class SelfAttentionLayer(nn.Module):
    """Post-norm MHSA block, dropout on the attention output in training."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype,
                 rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.attn = Attention(d_model, num_heads, dtype)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, seg, train=False, generator=None):
        z = dropout(self.attn(x, seg).float(), self.rate if train else 0.0, generator)
        return self.norm(z + x)


class FFN(nn.Module):
    """Post-norm feed-forward block, dropout after the activation and after
    fc2 in training."""

    def __init__(self, d_model: int, hidden_dim: int, activation: str,
                 dtype: torch.dtype, rate: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.rate = rate
        self.activation = activation
        self.fc1 = nn.Linear(d_model, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, train=False, generator=None):
        rate = self.rate if train else 0.0
        z = linear(x, self.fc1, self.dtype)
        z = F.gelu(z, approximate="tanh") if self.activation == "gelu" else F.relu(z)
        z = dropout(z, rate, generator)
        z = linear(z, self.fc2, self.dtype).float()
        return self.norm(dropout(z, rate, generator) + x)


def decode_boxes(
    sp_centers: torch.Tensor, bbox_pred: torch.Tensor, rotated: torch.Tensor
) -> torch.Tensor:
    """FCAF3D-style decode: (B, Q, 3) centers, (B, Q, 8) predictions with the
    first 6 already exp-ed face distances, (B,) bool per-scene angle flag ->
    (B, Q, 7) boxes, yaw = 0 where not rotated."""
    x_c = sp_centers[..., 0] + (bbox_pred[..., 1] - bbox_pred[..., 0]) / 2
    y_c = sp_centers[..., 1] + (bbox_pred[..., 3] - bbox_pred[..., 2]) / 2
    z_c = sp_centers[..., 2] + (bbox_pred[..., 5] - bbox_pred[..., 4]) / 2
    dx = bbox_pred[..., 0] + bbox_pred[..., 1]
    dy = bbox_pred[..., 2] + bbox_pred[..., 3]
    dz = bbox_pred[..., 4] + bbox_pred[..., 5]

    scale = dx + dy
    s_p, c_p = bbox_pred[..., 6], bbox_pred[..., 7]
    norm2 = s_p**2 + c_p**2
    q = torch.exp(torch.sqrt(norm2 + 1e-20))
    safe = norm2 > 1e-20
    alpha = 0.5 * torch.atan2(
        torch.where(safe, s_p, 0.0), torch.where(safe, c_p, 1.0)
    )

    r = rotated[:, None]
    w = torch.where(r, scale / (1 + q), dx)
    l = torch.where(r, scale / (1 + q) * q, dy)
    yaw = torch.where(r, alpha, 0.0)
    return torch.stack([x_c, y_c, z_c, w, l, dz, yaw], dim=-1)


class UniDecoder(nn.Module):
    """Input proj + N x (MHSA + FFN) + per-layer cls/box heads."""

    def __init__(
        self,
        in_channels: int,
        num_layers: int,
        d_model: int,
        num_heads: int,
        hidden_dim: int,
        activation: str,
        cls_gather: np.ndarray,  # (D, NC_MAX + 1) int32, -1 padding
        angles: tuple,  # (D,) python bools
        dtype: torch.dtype,
        dropout: float = 0.0,  # flax nn.Dropout rate, training only
    ):
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        num_unified = int(cls_gather.max()) + 1
        self.register_buffer(
            "cls_gather", torch.as_tensor(cls_gather, dtype=torch.int64),
            persistent=False,
        )
        self.register_buffer(
            "angles", torch.as_tensor(np.asarray(angles, dtype=bool)),
            persistent=False,
        )
        self.proj_fc1 = nn.Linear(in_channels, d_model)
        self.proj_fc2 = nn.Linear(d_model, d_model)
        self.out_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cls_fc1 = nn.Linear(d_model, d_model)
        self.cls_fc2 = nn.Linear(d_model, num_unified)
        self.box_fc = nn.Linear(d_model, 8)
        for i in range(num_layers):
            self.add_module(
                f"attn{i}", SelfAttentionLayer(d_model, num_heads, dtype, dropout)
            )
            self.add_module(
                f"ffn{i}", FFN(d_model, hidden_dim, activation, dtype, dropout)
            )

    def _head(self, feats, centers, scene_gather, rotated):
        dt = self.dtype
        h = cast(self.out_norm(cast(feats)))
        cls_all = linear(F.relu(linear(h, self.cls_fc1, dt)), self.cls_fc2, dt)
        cls_all = cls_all.float()
        b, q, _ = cls_all.shape
        idx = scene_gather.clamp(min=0)[:, None, :].expand(b, q, -1)
        cls_sel = torch.gather(cls_all, -1, idx)
        cls_sel = torch.where((scene_gather >= 0)[:, None, :], cls_sel, NEG_INF)
        bp = linear(h, self.box_fc, dt).float()
        bp = torch.cat([torch.exp(bp[..., :6]), bp[..., 6:]], dim=-1)
        return cls_sel, decode_boxes(centers, bp, rotated)

    def forward(
        self,
        queries: torch.Tensor,  # (B, Q, C_in)
        query_mask: torch.Tensor,  # (B, Q) bool
        sp_centers: torch.Tensor,  # (B, Q, 3)
        dataset_ids: torch.Tensor,  # (B,) int
        train: bool = False,
        generator: torch.Generator | None = None,  # dropout masks in training
    ) -> DecoderOutput:
        ids = dataset_ids.long()
        scene_gather = self.cls_gather[ids]
        rotated = self.angles[ids]
        seg = torch.where(query_mask, 1, 2).to(torch.int32).contiguous()

        x = F.relu(linear(queries, self.proj_fc1, self.dtype))
        x = linear(x, self.proj_fc2, self.dtype).float()
        cls_list, box_list = [], []
        for i in range(self.num_layers + 1):
            if i:
                x = getattr(self, f"attn{i - 1}")(x, seg, train, generator)
                x = getattr(self, f"ffn{i - 1}")(x, train, generator)
            c, bx = self._head(x, sp_centers, scene_gather, rotated)
            cls_list.append(c)
            box_list.append(bx)
        return DecoderOutput(
            cls_logits=torch.stack(cls_list), boxes=torch.stack(box_list)
        )
