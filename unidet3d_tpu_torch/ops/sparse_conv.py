"""Sparse convolutions over host-built rulebooks, in plain PyTorch.

The port's counterparts of the JAX package's ``ops/sparse_conv.py``:

  * ``subm_conv``: the submanifold 3x3x3 conv as 27 gathers + matmuls. It is
    the plain version that the CUDA kernel ``ops/subm_conv_cuda.py`` is held
    against, and what that wrapper runs for CPU tensors.
  * ``strided_conv`` / ``inverse_conv``: the k=2 s=2 down/up convs. Each input
    row meets exactly one kernel offset, so both are one dense matmul over an
    offset-expanded input plus an ``index_add_`` (the JAX package leaves
    these to XLA too).

Weight layouts: (27, Cin, Cout) with offset order (dx, dy, dz), dx-major, each
in (-1, 0, 1); (8, Cin, Cout) with offset code ox*4 + oy*2 + oz.

Every matmul takes its operands in the compute dtype the caller cast them to
and accumulates in fp32: the operands are widened to fp32 first, which is
exact for bf16, so the products and sums are those of an fp32-accumulating
bf16 matmul.
"""
from __future__ import annotations

import torch

from .segment import segment_sum


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
    out = features.new_zeros((v, weights.shape[-1]), dtype=torch.float32)
    nbr = neighbors[:n].long()
    acc = out[:n]
    for o in range(weights.shape[0]):
        acc += padded[nbr[:, o]] @ w32[o]
    return out


def _offset_matmul(x32, offset_code, weights):
    """out[i] = x[i] @ W[code[i]] as ONE matmul: x is scattered into the
    column block of its offset code, (N, 8*Cin) @ (8*Cin, Cout)."""
    n, cin = x32.shape
    k = weights.shape[0]
    xe = x32.new_zeros((n, k, cin))
    xe[torch.arange(n, device=x32.device), offset_code.long()] = x32
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
    out = features.new_zeros((v_in, weights.shape[-1]), dtype=torch.float32)
    out[:n] = _offset_matmul(g, offset_code[:n], weights)
    return out
