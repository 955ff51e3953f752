"""Voxel coordinate keys and their binary search, in PyTorch tensor ops.

The port of the JAX package's ``ops/keys.py``. The TPU keeps a pair of int32
keys, k1 = (batch << 12) | x and k2 = (y << 12) | z, because JAX runs without
int64; here the pair is one int64 key, (k1 << 24) | k2 =
(batch << 36) | (x << 24) | (y << 12) | z, the host builder's packing
(``ops/gridpack.py::_pack64``). Its integer order is the pair's
lexicographic order, (batch, x, y, z). Coordinates lie in [0, MAX_COORD]
(82 m at 2 cm voxels); invalid rows get INVALID_KEY, so they sort last.
"""
from __future__ import annotations

import torch

COORD_BITS = 12
MAX_COORD = (1 << COORD_BITS) - 1  # 4095
INVALID_KEY = torch.iinfo(torch.int64).max


def pack_keys(bxyz: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 4) int (batch, x, y, z), coords already in [0, MAX_COORD] -> (N,)
    int64 keys; rows where `valid` is False get INVALID_KEY."""
    b, x, y, z = bxyz.long().unbind(-1)
    key = (b << 3 * COORD_BITS) | (x << 2 * COORD_BITS) | (y << COORD_BITS) | z
    if valid is not None:
        key = torch.where(valid, key, INVALID_KEY)
    return key


def searchsorted_pair(keys_sorted: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Lower bound of each query key in the ascending table `keys_sorted`
    (V,): the leftmost position whose key >= the query, in [0, V]. One
    ``torch.searchsorted`` over the int64 key does what the JAX package's
    unrolled binary search over the pair does."""
    return torch.searchsorted(keys_sorted, query)


def lookup_pair(keys_sorted: torch.Tensor, query: torch.Tensor):
    """Exact-match lookup: (index in [0, V], found)."""
    n = keys_sorted.shape[0]
    idx = searchsorted_pair(keys_sorted, query)
    found = (idx < n) & (keys_sorted[idx.clamp(max=n - 1)] == query)
    return idx, found
