"""Sparse-convolutional 3D U-Net backbone.

The port of the JAX package's ``models/unet.py`` (SubmConv, ResidualBlock,
SpConvUNet, UNetBackbone): a 5-level residual U-Net over the host-built voxel
pyramid, pre-norm blocks (norm -> relu -> conv), channel schedule
(32, 64, 96, 128, 160). Module and parameter names mirror the flax tree so
that ``weights.from_flax`` is a mechanical renaming.

Every conv and the 1x1 identity branch take features and weights cast to the
compute dtype and accumulate in fp32. The 37 submanifold convs run the
Hopper kernels on the card through ``SubmConvFunction`` (``ops/
subm_conv_cuda.py``: K1 forward, K1' input gradient, K2 weight gradient);
the strided and inverse convs stay PyTorch matmuls, as the JAX package left
them to XLA. ``train`` selects the batch norms' masked batch moments (and
running-statistic updates) over their running statistics. The JAX package
rematerialises the residual blocks in training to save TPU memory; that
changes no number and is not done here.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gridpack import GridPack
from ..ops.sparse_conv import inverse_conv, strided_conv
from ..ops.subm_conv_cuda import SubmConvFunction
from .norm import MaskedBatchNorm


def mm_fp32(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x @ w with both operands rounded to `dtype`, accumulated in fp32."""
    return x.to(dtype).float() @ w.to(dtype).float()


class SubmConv(nn.Module):
    """Submanifold 3x3x3 conv (bias-free), fp32 master weight (27, Cin, Cout),
    computed in `dtype`."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(27, in_channels, out_channels))

    def forward(self, x, neighbors, n_valid: int):
        return SubmConvFunction.apply(
            x.to(self.dtype).contiguous(), neighbors, self.weight, n_valid
        )


class ResidualBlock(nn.Module):
    """Pre-norm residual block: norm -> relu -> subm3 -> norm -> relu ->
    subm3, plus the identity (a 1x1 `i_branch` when channels change)."""

    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        if in_channels != out_channels:
            self.i_branch = nn.Parameter(torch.zeros(in_channels, out_channels))
        else:
            self.i_branch = None
        self.norm1 = MaskedBatchNorm(in_channels)
        self.conv1 = SubmConv(in_channels, out_channels, dtype)
        self.norm2 = MaskedBatchNorm(out_channels)
        self.conv2 = SubmConv(out_channels, out_channels, dtype)

    def forward(self, x, mask, neighbors, n_valid: int, train: bool):
        identity = x
        if self.i_branch is not None:
            identity = mm_fp32(x, self.i_branch, self.dtype)
        h = self.conv1(F.relu(self.norm1(x, mask, train)), neighbors, n_valid)
        h = self.conv2(F.relu(self.norm2(h, mask, train)), neighbors, n_valid)
        return h + identity


class SpConvUNet(nn.Module):
    """Per level: 2 pre-blocks, strided down, recurse, inverse up, skip
    concat, 2 tail blocks (the first halves the concatenated channels)."""

    def __init__(self, num_planes: Sequence[int], dtype: torch.dtype,
                 block_reps: int = 2):
        super().__init__()
        self.planes = list(num_planes)
        self.dtype = dtype
        self.block_reps = block_reps
        planes = self.planes
        for lvl, c in enumerate(planes):
            for i in range(block_reps):
                self.add_module(f"level{lvl}_block{i}", ResidualBlock(c, c, dtype))
            if lvl == len(planes) - 1:
                continue
            nxt = planes[lvl + 1]
            self.add_module(f"level{lvl}_down_norm", MaskedBatchNorm(c))
            self.register_parameter(
                f"level{lvl}_down_kernel", nn.Parameter(torch.zeros(8, c, nxt))
            )
            self.add_module(f"level{lvl}_up_norm", MaskedBatchNorm(nxt))
            self.register_parameter(
                f"level{lvl}_up_kernel", nn.Parameter(torch.zeros(8, nxt, c))
            )
            for i in range(block_reps):
                cin = 2 * c if i == 0 else c
                self.add_module(f"level{lvl}_tail{i}", ResidualBlock(cin, c, dtype))

    def forward(self, x, pack: GridPack, train: bool = False):
        levels = len(self.planes)
        skips = []
        for lvl in range(levels):
            mask, nbr, n = pack.valid[lvl], pack.neighbors[lvl], pack.n_valid[lvl]
            for i in range(self.block_reps):
                x = getattr(self, f"level{lvl}_block{i}")(x, mask, nbr, n, train)
            if lvl < levels - 1:
                skips.append(x)
                h = F.relu(getattr(self, f"level{lvl}_down_norm")(x, mask, train))
                x = strided_conv(
                    h.to(self.dtype),
                    pack.parent[lvl],
                    pack.offset_code[lvl],
                    pack.capacity(lvl + 1),
                    getattr(self, f"level{lvl}_down_kernel").to(self.dtype),
                    n_valid=n,
                )
        for lvl in range(levels - 2, -1, -1):
            mask, nbr, n = pack.valid[lvl], pack.neighbors[lvl], pack.n_valid[lvl]
            # The up-norm sees the coarse level's rows.
            h = getattr(self, f"level{lvl}_up_norm")(x, pack.valid[lvl + 1], train)
            h = F.relu(h)
            h = inverse_conv(
                h.to(self.dtype),
                pack.parent[lvl],
                pack.offset_code[lvl],
                getattr(self, f"level{lvl}_up_kernel").to(self.dtype),
                n_valid=n,
            )
            x = torch.cat([skips[lvl], h], dim=-1)
            for i in range(self.block_reps):
                x = getattr(self, f"level{lvl}_tail{i}")(x, mask, nbr, n, train)
        return x


class UNetBackbone(nn.Module):
    """Input subm conv + U-Net + output BN/ReLU; padded rows zeroed."""

    def __init__(self, in_channels: int, num_planes: Sequence[int],
                 dtype: torch.dtype):
        super().__init__()
        self.input_conv = SubmConv(in_channels, num_planes[0], dtype)
        self.unet = SpConvUNet(num_planes, dtype)
        self.output_norm = MaskedBatchNorm(num_planes[0])

    def forward(self, vox_feats, pack: GridPack, train: bool = False):
        x = self.input_conv(vox_feats, pack.neighbors[0], pack.n_valid[0])
        x = self.unet(x, pack, train)
        x = F.relu(self.output_norm(x, pack.valid[0], train))
        # Zero the padding rows so that downstream pooling stays exact.
        return torch.where(pack.valid[0][:, None], x, 0.0)
