"""The conv-bottleneck probe: K1 with parts stripped, on the card.

The port of the JAX package's ``scripts/probe_conv_bottleneck.py::
run_variant``, as a bisection of K1 on Hopper. K1's kernel
(``csrc/subm_conv.cu``, both its bf16 tensor-core route and its fp32 FMA
route) is templated on one of four modes:

  * ``full``: K1 itself, ``out[i] = sum_o feat[nbr[i, o]] @ W[o]``;
  * ``gather_only``: the table read, the per-offset skip and the row
    gathers, no weights and no products:
    ``out[i, c] = sum_o feat[nbr[i, o], c]`` (Cin == Cout);
  * ``no_gather``: the table read, the skip, the weight staging and the
    products on the tile's own rows:
    ``out[i] = sum_o [nbr[i, o] valid] feat[i] @ W[o]``;
  * ``no_table``: the weight staging and the products for all 27 offsets on
    the tile's own rows: ``out[i] = sum_o feat[i] @ W[o]``.

``probe_conv_plain`` is each mode's plain version, ``probe_conv_cuda`` the
wrapper (the plain version for CPU tensors; for CUDA tensors the kernel or an
error), and ``probe_work`` what each mode processes and needs, from which a
probe run takes each mode's bound.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .sparse_conv import _pad_rows, _with_zero_row, subm_conv
from .subm_conv_cuda import _launch_k1, conv_tile

MODES = ("full", "gather_only", "no_gather", "no_table")
# H100 SXM published peaks (NVIDIA data sheet, dense): the HBM rate, the
# operation rate by the inputs' itemsize (2: bf16 on the tensor cores; 4:
# fp32 outside them), and the fp32 rate of the units the fp32 route does its
# FMAs on.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {2: 989e12, 4: 67e12}
FP32_UNIT_FLOPS = 67e12
_ROWS = 64  # output rows per block of the kernel
_OFFSETS = 27


def _check_mode(mode: str, cin: int, cout: int) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if mode == "gather_only" and cin != cout:
        raise ValueError(f"gather_only sums input channels into outputs: Cin {cin} != Cout {cout}")


def probe_conv_plain(
    mode: str,
    features: torch.Tensor,
    neighbors: torch.Tensor,
    weights: torch.Tensor,
    n_valid: int,
) -> torch.Tensor:
    """The plain version of one probe mode (see the module docstring), for
    rows [0, n_valid), zero after. Arguments as for ``probe_conv_cuda``.

    Returns:
        (V, Cout) fp32.
    """
    v, cin = features.shape
    _check_mode(mode, cin, weights.shape[2])
    n = int(n_valid)
    if mode == "full":
        return subm_conv(features, neighbors, weights, n)
    if mode == "gather_only":
        padded = _with_zero_row(features.float())
        nbr = neighbors[:n].long()
        acc = padded[nbr[:, 0]]
        for o in range(1, _OFFSETS):
            acc = acc + padded[nbr[:, o]]
        return _pad_rows(acc, v)
    # no_gather and no_table: K1 over a table that points each row at itself,
    # at every offset (no_table) or where the row has a neighbor (no_gather).
    own = torch.arange(v, dtype=neighbors.dtype, device=neighbors.device)
    own = own[:, None].expand(v, _OFFSETS)
    if mode == "no_gather":
        own = torch.where((neighbors >= 0) & (neighbors < v), own, v)
    return subm_conv(features, own, weights, n)


def probe_conv_cuda(
    mode: str,
    features: torch.Tensor,
    neighbors: torch.Tensor,
    weights: torch.Tensor,
    n_valid: int,
) -> torch.Tensor:
    """One probe mode: its kernel for CUDA tensors, its plain version for CPU
    tensors. ``probe_conv_cuda.launches[mode]`` counts the kernel launches.

    Args:
        mode: one of MODES.
        features: (V, Cin) fp32 or bf16, contiguous.
        neighbors: (V, 27) int32, sentinel V, contiguous.
        weights: (27, Cin, Cout), the dtype of `features`, contiguous (not
            read by gather_only, which needs Cin == Cout).
        n_valid: host int; valid voxels are the rows [0, n_valid).

    Returns:
        (V, Cout) fp32, zero past n_valid.
    """
    if features.device.type == "cpu":
        return probe_conv_plain(mode, features, neighbors, weights, n_valid)
    _check_mode(mode, features.shape[1], weights.shape[-1])
    out = _launch_k1(features, neighbors, weights, n_valid, f"probe_conv {mode}",
                     MODES.index(mode))
    if int(n_valid):
        probe_conv_cuda.launches[mode] += 1
    return out


probe_conv_cuda.launches = dict.fromkeys(MODES, 0)


class ProbeWork(NamedTuple):
    """What one probe mode processes on one table: what its kernel loads
    and computes, and what the mode's function needs."""

    tile_offsets: int  # (64-row tile, offset) pairs whose rows the kernel stages
    pairs: int  # (row, offset) pairs whose row it loads
    fmas: int  # multiply-adds the kernel does (0 for gather_only)
    adds: int  # plain adds the kernel does (gather_only only)
    ops: int  # operations the function needs on this table (an FMA counts 2)
    peak_flops: float  # the card's peak operation rate for the inputs' type
    bytes_read: int  # each input the mode reads, read once
    bytes_written: int  # the (V, Cout) fp32 output, written once
    bytes_loaded: int  # the kernel's global loads: table, staged rows, W tiles

    def bound(self) -> tuple:
        """(least ms on the H100, "bytes" or "operations"): bytes read and
        written over the HBM rate against the operations the function needs
        over the peak rate for the inputs' type."""
        bytes_ms = (self.bytes_read + self.bytes_written) / HBM_BYTES_PER_S * 1e3
        ops_ms = self.ops / self.peak_flops * 1e3
        return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"

    def fp32_unit_ms(self) -> float:
        """The kernel's own FMAs and adds at the fp32 rate of the units the
        fp32 route does them on (the bf16 route does its products on the
        tensor cores): a diagnostic of the bisection, not a bound."""
        return (2 * self.fmas + self.adds) / FP32_UNIT_FLOPS * 1e3


def probe_work(
    mode: str, neighbors, n_valid: int, cin: int, cout: int, itemsize: int = 2
) -> ProbeWork:
    """The work of one probe mode on a (V, 27) table (a tensor on any device,
    or a numpy array) with `itemsize`-byte features and weights (2: bf16,
    4: fp32).

    Counted from the kernel: it launches 64-row tiles over [0, n_valid) and
    column blocks of ``conv_tile(cout).cols`` output channels in bf16 (the
    fp32 route: 32, or 64 when Cout > 32). Every mode but
    no_table reads the tile's 27 table entries per row and skips an offset
    that no row of the tile has; no_table stages all 27. A staged offset
    loads the valid rows (the neighbors; for no_gather and no_table the rows
    themselves) and, but in gather_only, W[o]'s tile of the block.

    The function needs fewer operations than some kernels do: full and
    no_gather a product per existing (row, offset) pair, gather_only an add
    per element of those pairs, and no_table one product per row with
    sum_o W[o] (26 adds per weight)."""
    _check_mode(mode, cin, cout)
    nbr = torch.as_tensor(neighbors)
    v, n = nbr.shape[0], int(n_valid)
    tiles = -(-n // _ROWS)
    cols = conv_tile(cout).cols if itemsize == 2 else 32 if cout <= 32 else 64
    col_blocks = -(-cout // cols)
    valid = (nbr[:n] >= 0) & (nbr[:n] < v)  # (n, 27)
    if mode == "no_table":
        tile_offsets, pairs, rows = tiles * _OFFSETS, n * _OFFSETS, n
    else:
        padded = torch.zeros((tiles * _ROWS, _OFFSETS), dtype=torch.bool, device=nbr.device)
        padded[:n] = valid
        tile_offsets = int(padded.view(tiles, _ROWS, _OFFSETS).any(1).sum())
        pairs = int(valid.sum())
        if mode == "no_gather":
            rows = int(valid.any(1).sum())
        else:  # the distinct rows gathered
            seen = torch.zeros(v, dtype=torch.bool, device=nbr.device)
            seen[nbr[:n][valid].long()] = True
            rows = int(seen.sum())
    table = 0 if mode == "no_table" else n * _OFFSETS * 4
    w_tile = 0 if mode == "gather_only" else cin * cout * itemsize
    ops = {"gather_only": pairs * cin,
           "no_table": 2 * n * cin * cout + (_OFFSETS - 1) * cin * cout}.get(
               mode, 2 * pairs * cin * cout)
    return ProbeWork(
        tile_offsets=tile_offsets,
        pairs=pairs,
        fmas=0 if mode == "gather_only" else pairs * cin * cout,
        adds=pairs * cin if mode == "gather_only" else 0,
        ops=ops,
        peak_flops=PEAK_FLOPS[itemsize],
        bytes_read=table + rows * cin * itemsize + _OFFSETS * w_tile,
        bytes_written=v * cout * 4,
        bytes_loaded=col_blocks * (table + pairs * cin * itemsize) + tile_offsets * w_tile,
    )
