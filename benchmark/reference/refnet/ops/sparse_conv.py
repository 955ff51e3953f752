"""Sparse convolutions over GridPack rulebooks in plain PyTorch, and the
rulebook builders of the device-side fallback.

The port's counterparts of the JAX package's ``ops/sparse_conv.py``:

  * ``subm_conv``: the submanifold 3x3x3 conv as 27 gathers + matmuls. It is
    the plain version that the CUDA kernel ``ops/subm_conv_cuda.py`` is held
    against, and what that wrapper runs for CPU tensors.
  * ``subm_conv_dgrad`` / ``subm_conv_wgrad``: the plain versions of the
    conv's input gradient (the mirrored conv) and weight gradient, held
    against the backward kernels the same way.
  * ``strided_conv`` / ``inverse_conv``: the k=2 s=2 down/up convs. Each input
    row meets exactly one kernel offset, so both are one dense matmul over an
    offset-expanded input plus an ``index_add_`` (the JAX package leaves
    these to XLA too).

``build_subm_neighbors`` / ``build_downsample_map`` build one level's
neighbor table and one transition's rulebook on the device from a sorted
``VoxelGrid`` (``ops/voxelize.py``), as the JAX package's do.

Every conv here is differentiable under autograd: none writes in place
into a tensor that carries a gradient.

Weight layouts: (27, Cin, Cout) with offset order (dx, dy, dz), dx-major, each
in (-1, 0, 1); (8, Cin, Cout) with offset code ox*4 + oy*2 + oz.

Every matmul takes its operands in the compute dtype the caller cast them to
and accumulates in fp32: the operands are widened to fp32 first, which is
exact for bf16, so the products and sums are those of an fp32-accumulating
bf16 matmul.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .keys import MAX_COORD, lookup_pair, pack_keys
from .segment import segment_sum
from .voxelize import VoxelGrid, voxelize


def _with_zero_row(features: torch.Tensor) -> torch.Tensor:
    """features plus one zero row at index len(features), the sentinel."""
    return torch.cat([features, features.new_zeros((1,) + features.shape[1:])])


def gather_rows(features: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """features[index] with index == len(features) (the sentinel) -> 0."""
    return _with_zero_row(features)[index.long()]


def subm_conv(
    features: torch.Tensor,
    neighbors: torch.Tensor,
    weights: torch.Tensor,
    n_valid: int | None = None,
) -> torch.Tensor:
    """Submanifold conv: out[i] = sum_o feat[nbr[i, o]] @ W[o] for i < n_valid.

    Args:
        features: (V, Cin) fp32 or bf16.
        neighbors: (V, 27) int32, sentinel V.
        weights: (27, Cin, Cout), same dtype as features.
        n_valid: rows [0, n_valid) are computed, the rest are zero
            (None = all rows).

    Returns:
        (V, Cout) fp32.
    """
    v = features.shape[0]
    n = v if n_valid is None else int(n_valid)
    padded = _with_zero_row(features.float())
    w32 = weights.float()
    nbr = neighbors[:n].long()
    acc = padded[nbr[:, 0]] @ w32[0]
    for o in range(1, weights.shape[0]):
        acc = acc + padded[nbr[:, o]] @ w32[o]
    return _pad_rows(acc, v)


def subm_conv_dgrad(
    grad: torch.Tensor,
    neighbors: torch.Tensor,
    weights: torch.Tensor,
    n_valid: int | None = None,
) -> torch.Tensor:
    """The conv's input gradient as the mirrored conv on the cotangent:
    subm_conv(g, nbr, W') with W'[o] = W[26 - o]^T. It equals the exact
    transpose of ``subm_conv`` because a GridPack table is symmetric (pair
    (i, j, o) <=> (j, i, 26 - o)).

    Args:
        grad: (V, Cout) cotangent of the conv output, fp32 or bf16.
        neighbors: (V, 27) int32, sentinel V.
        weights: (27, Cin, Cout), same dtype as grad.
        n_valid: as for subm_conv.

    Returns:
        (V, Cin) fp32.
    """
    return subm_conv(grad, neighbors, weights.flip(0).transpose(1, 2), n_valid)


def subm_conv_wgrad(
    features: torch.Tensor,
    neighbors: torch.Tensor,
    grad: torch.Tensor,
    n_valid: int | None = None,
) -> torch.Tensor:
    """The conv's weight gradient: dW[o] = sum_{i < n} feat[nbr[i, o]]^T g[i].

    Args:
        features: (V, Cin) fp32 or bf16, the conv's input.
        neighbors: (V, 27) int32, sentinel V.
        grad: (V, Cout) cotangent of the conv output, same dtype.
        n_valid: rows [0, n_valid) contribute (None = all rows).

    Returns:
        (27, Cin, Cout) fp32.
    """
    n = features.shape[0] if n_valid is None else int(n_valid)
    padded = _with_zero_row(features.float())
    g32 = grad[:n].float()
    nbr = neighbors[:n].long()
    return torch.stack(
        [padded[nbr[:, o]].T @ g32 for o in range(neighbors.shape[1])]
    )


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x (n, C) followed by zero rows up to `rows`."""
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + x.shape[1:])])


def _offset_matmul(x32, offset_code, weights):
    """out[i] = x[i] @ W[code[i]] as ONE matmul: x is placed in the column
    block of its offset code, (N, 8*Cin) @ (8*Cin, Cout)."""
    n, cin = x32.shape
    k = weights.shape[0]
    onehot = torch.nn.functional.one_hot(offset_code.long(), k).to(x32.dtype)
    xe = onehot[:, :, None] * x32[:, None, :]
    return xe.reshape(n, k * cin) @ weights.float().reshape(k * cin, -1)


def strided_conv(
    features: torch.Tensor,
    parent: torch.Tensor,
    offset_code: torch.Tensor,
    out_capacity: int,
    weights: torch.Tensor,
    n_valid: int | None = None,
) -> torch.Tensor:
    """k=2 s=2 downsampling conv: out[p] = sum_{i: parent(i)=p} feat[i] @ W[o_i].

    Args:
        features: (V_in, Cin) fine-level features.
        parent: (V_in,) fine -> coarse row (sentinel out_capacity).
        offset_code: (V_in,) 3-bit kernel offset.
        out_capacity: V_out.
        weights: (8, Cin, Cout).
        n_valid: fine rows at or past it have the sentinel parent and are
            skipped (None = all rows).

    Returns:
        (V_out, Cout) fp32 coarse-level features.
    """
    n = features.shape[0] if n_valid is None else int(n_valid)
    contrib = _offset_matmul(features[:n].float(), offset_code[:n], weights)
    return segment_sum(contrib, parent[:n], out_capacity)


def inverse_conv(
    features: torch.Tensor,
    parent: torch.Tensor,
    offset_code: torch.Tensor,
    weights: torch.Tensor,
    n_valid: int | None = None,
) -> torch.Tensor:
    """k=2 inverse (upsampling) conv reusing the downsample rulebook:
    out[i] = feat_coarse[parent(i)] @ W[o_i].

    Args:
        features: (V_out, Cin) coarse-level features.
        parent: (V_in,) fine -> coarse row map.
        offset_code: (V_in,) 3-bit kernel offset.
        weights: (8, Cin, Cout).
        n_valid: fine rows at or past it have the sentinel parent, so their
            output is zero (None = all rows).

    Returns:
        (V_in, Cout) fp32 fine-level features.
    """
    v_in = parent.shape[0]
    n = v_in if n_valid is None else int(n_valid)
    g = gather_rows(features.float(), parent[:n])
    return _pad_rows(_offset_matmul(g, offset_code[:n], weights), v_in)


# ---------------------------------------------------------------------------
# Rulebooks on the device: the JAX package's builders, for GridPack's
# device-side fallback (ops/gridpack.py::build_gridpack_device).
# ---------------------------------------------------------------------------

SUBM_OFFSETS = [
    (dx, dy, dz)
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
]


def build_subm_neighbors(grid: VoxelGrid) -> torch.Tensor:
    """The (V, 27) int32 neighbor table of a sorted grid: entry [i, o] is the
    row of voxel i's neighbor at offset o, or V (the sentinel) when it is
    absent, out of range or i is not a valid row. All 27 offsets are looked
    up in one binary search over a (V, 27) query; the center offset is the
    identity."""
    cap = grid.capacity
    offs = torch.tensor([[0, *o] for o in SUBM_OFFSETS], dtype=torch.int64,
                        device=grid.coords.device)
    q = grid.coords.long()[:, None, :] + offs[None]  # (V, 27, 4)
    in_range = ((q[..., 1:] >= 0) & (q[..., 1:] <= MAX_COORD)).all(-1)
    ok = grid.valid[:, None] & in_range
    idx, found = lookup_pair(grid.key, pack_keys(q.clamp(min=0), ok))
    nbr = torch.where(found & ok, idx, cap).int()
    center = SUBM_OFFSETS.index((0, 0, 0))
    nbr[:, center] = torch.where(
        grid.valid, torch.arange(cap, dtype=torch.int32, device=nbr.device), cap)
    return nbr


class DownsampleMap(NamedTuple):
    """The rulebook from a grid to its 2x-downsampled parent grid.

    grid: the coarse VoxelGrid; parent: (V_in,) int32 fine -> coarse row
    (V_out, the sentinel, for invalid or dropped rows); offset_code: (V_in,)
    int32 in [0, 8), ox * 4 + oy * 2 + oz from the fine coords' low bits."""

    grid: VoxelGrid
    parent: torch.Tensor
    offset_code: torch.Tensor


def build_downsample_map(grid: VoxelGrid, out_capacity: int) -> DownsampleMap:
    """The coarse grid and the rulebook of a k=2 s=2 strided conv."""
    coords = grid.coords
    coarse = torch.cat([coords[:, :1], coords[:, 1:] >> 1], -1)
    out_grid, _ = voxelize(coarse, grid.valid, out_capacity)
    low = coords[:, 1:] & 1
    offset_code = low[:, 0] * 4 + low[:, 1] * 2 + low[:, 2]
    return DownsampleMap(grid=out_grid, parent=out_grid.inverse,
                         offset_code=offset_code.int())
