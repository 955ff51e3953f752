"""Submanifold conv on the card: the wrappers of the Hopper kernels and the
differentiable conv built from them.

  * ``subm_conv_cuda``: K1, the forward (``csrc/subm_conv.cu``), the port of
    the JAX package's ``ops/pallas_conv.py::subm_conv_pallas``. In bf16 it is
    a gather-GEMM on the tensor cores whose block shape ``conv_tile`` chooses;
    in fp32 an FMA kernel.
  * ``subm_conv_dgrad_cuda``: K1', the input gradient: K1 launched on the
    cotangent with the mirrored weights ``W'[o] = W[26 - o]^T`` over the same
    neighbor table (``pallas_conv.py::_banded_conv_bwd``). It relies on the
    table being symmetric (pair (i, j, o) <=> (j, i, 26 - o)), which a
    GridPack table is.
  * ``subm_conv_wgrad_cuda``: K2, the weight gradient
    (``csrc/subm_conv_wgrad.cu``, the port of ``subm_conv_dw_pallas``). In
    bf16 a GEMM per offset on the tensor cores, rows as its k, whose block
    shape ``wgrad_tile`` chooses; in fp32 an FMA kernel.
  * ``SubmConvFunction``: the ``torch.autograd.Function`` around the three,
    the port of ``subm_conv_banded``'s custom VJP.

For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it runs the plain version from ``ops/sparse_conv.py``. Each wrapper's
``launches`` counts its kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import cuda_build
from .sparse_conv import subm_conv, subm_conv_dgrad, subm_conv_wgrad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# K1's bf16 route (csrc/subm_conv.cu): rows per block, warps (16 rows each),
# input channels per pipeline step, cp.async ring stages, widest column block.
_ROWS, _WARPS, _BK, _STAGES, _MAX_COLS = 64, 4, 32, 4, 160
# K2's bf16 route (csrc/subm_conv_wgrad.cu): voxel rows per pipeline step and
# cp.async ring stages.
_W_ROWS, _W_STAGES = 32, 3
# Its compiled instances (MT, NT, GW): Cin tile 16 MT, Cout tile 16 NT, up to
# 2 GW offsets per block; the kernel source's K2_INSTANCES, in its order.
WGRAD_INSTANCES = ((1, 2, 4), (2, 2, 2), (4, 2, 2), (2, 4, 2), (2, 5, 2), (2, 6, 2))
# Blocks per call K2 aims for, per route: 8 or 16 per SM of the H100's 132
# (the bf16 kernel walks a row range in a loop; the fp32 one takes 64 rows a
# tile).
_WGRAD_TARGET_BLOCKS = {torch.bfloat16: 8 * 132, torch.float32: 16 * 132}
# The chooser's weight of a gathered row per tap and input channel, in
# bytes: a fifth to a quarter of the 27 taps exist on surface scans, each 2
# bytes a channel, counted twice since a gather waits on its table read.
_WGRAD_GATHER_BYTES = 1.0


class ConvTile(NamedTuple):
    """The block shape of K1's bf16 route for one conv."""

    rows: int  # output rows per block
    cols: int  # output columns per block (BN)
    warps: int  # warps per block, 16 rows each
    stages: int  # slots of the cp.async ring (stages - 1 steps in flight)
    smem: int  # dynamic shared memory per block, bytes


def conv_tile(cout: int) -> ConvTile:
    """K1's bf16 block shape for `cout` output columns (the input gradient's
    Cout is the forward's Cin): 64 rows by BN columns, BN a multiple of 32
    of at most 160, Cout split into ceil(Cout / 160) column blocks of equal
    width; each warp keeps 16 x BN fp32 accumulators. The shared memory is
    the kernel's ``ConvSmem<BN>``: the ring of gathered rows (64 x 40 bf16)
    and W[o] slices (32 x (BN + 8) bf16), the tile's table (27 x 65 int32),
    the offset list and the warps' offset masks."""
    blocks = -(-int(cout) // _MAX_COLS)
    per_block = -(-int(cout) // blocks)
    cols = 32 * -(-per_block // 32)
    smem = (_STAGES * _ROWS * (_BK + 8) * 2 + _STAGES * _BK * (cols + 8) * 2
            + 27 * (_ROWS + 1) * 4 + 27 * 4 + _WARPS * 4)
    return ConvTile(rows=_ROWS, cols=cols, warps=_WARPS, stages=_STAGES, smem=smem)


@functools.cache
def _kernel():
    fn = cuda_build.load("subm_conv").subm_conv_fwd
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def kernel_smem_bytes(cols: int) -> int:
    """The bf16 route's shared memory per block for `cols` columns, as the
    compiled kernel counts it (-1 for a width it does not take): the card's
    check of ``conv_tile``."""
    fn = cuda_build.load("subm_conv").subm_conv_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(int(cols))


@functools.cache
def _wgrad_kernel():
    fn = cuda_build.load("subm_conv_wgrad").subm_conv_wgrad
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def wgrad_kernel_smem_bytes(cin_tile: int, cout_tile: int) -> int:
    """K2's bf16 shared memory per block for the channel tile, as the
    compiled kernel counts it (-1 for a tile it is not compiled for): the
    card's check of ``wgrad_tile``."""
    fn = cuda_build.load("subm_conv_wgrad").subm_conv_wgrad_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return fn(int(cin_tile), int(cout_tile))


def _check(rows, neighbors, n_valid, **tensors):
    """Shared checks of the card wrappers: one device, contiguous, a
    (V, 27) int32 table and 0 <= n_valid <= V. Returns n_valid as an int."""
    first = next(iter(tensors.values()))
    if tuple(neighbors.shape) != (rows, 27) or neighbors.dtype != torch.int32:
        raise ValueError(
            f"neighbors {tuple(neighbors.shape)} {neighbors.dtype} != "
            f"({rows}, 27) int32"
        )
    for name, t in dict(tensors, neighbors=neighbors).items():
        if t.device != first.device:
            raise ValueError(f"{name} on {t.device}, not {first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    n_valid = int(n_valid)
    if not 0 <= n_valid <= rows:
        raise ValueError(f"n_valid {n_valid} outside [0, {rows}]")
    return n_valid


def _launch_k1(features, neighbors, weights, n_valid, name, mode=0) -> torch.Tensor:
    """Checks, allocates and launches K1's kernel in `mode` (0: the conv;
    1-3: the probe's stripped modes, ops/probe_conv.py); the callers count
    the launch."""
    v, cin = features.shape
    if weights.dim() != 3 or weights.shape[:2] != (27, cin):
        raise ValueError(f"weights {tuple(weights.shape)} != (27, {cin}, Cout)")
    if features.dtype not in _DTYPES or weights.dtype != features.dtype:
        raise ValueError(
            f"features {features.dtype} / weights {weights.dtype}: both fp32 "
            "or both bf16"
        )
    n_valid = _check(v, neighbors, n_valid, features=features, weights=weights)
    cout = weights.shape[2]
    out = torch.empty((v, cout), dtype=torch.float32, device=features.device)
    out[n_valid:].zero_()
    if n_valid == 0:
        return out
    with torch.cuda.device(features.device):
        err = _kernel()(
            mode, features.data_ptr(), neighbors.data_ptr(), weights.data_ptr(),
            out.data_ptr(), v, n_valid, cin, cout, conv_tile(cout).cols,
            _DTYPES[features.dtype], torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def subm_conv_cuda(
    features: torch.Tensor,
    neighbors: torch.Tensor,
    weights: torch.Tensor,
    n_valid: int,
) -> torch.Tensor:
    """K1: out[i] = sum_o feat[nbr[i, o]] @ W[o] for i < n_valid, zero after.

    Args:
        features: (V, Cin) fp32 or bf16, contiguous.
        neighbors: (V, 27) int32, sentinel V, contiguous.
        weights: (27, Cin, Cout), the dtype of `features`, contiguous.
        n_valid: host int; valid voxels are the rows [0, n_valid).

    Returns:
        (V, Cout) fp32.
    """
    if features.device.type == "cpu":
        return subm_conv(features, neighbors, weights, n_valid)
    out = _launch_k1(features, neighbors, weights, n_valid, "subm_conv")
    if int(n_valid):
        subm_conv_cuda.launches += 1
    return out


subm_conv_cuda.launches = 0


def subm_conv_dgrad_cuda(
    grad: torch.Tensor,
    neighbors: torch.Tensor,
    weights: torch.Tensor,
    n_valid: int,
) -> torch.Tensor:
    """K1': dfeat[j] = sum over pairs (i, j, o) of g[i] @ W[o]^T, as K1 on
    the cotangent with W'[o] = W[26 - o]^T over the same (symmetric) table.

    Args:
        grad: (V, Cout) cotangent of the conv output, fp32 or bf16,
            contiguous; rows at or past n_valid are not read.
        neighbors: (V, 27) int32, sentinel V, a GridPack table.
        weights: (27, Cin, Cout) forward weights, the dtype of `grad`.
        n_valid: host int.

    Returns:
        (V, Cin) fp32, zero past n_valid.
    """
    if grad.device.type == "cpu":
        return subm_conv_dgrad(grad, neighbors, weights, n_valid)
    w_mirror = weights.flip(0).transpose(1, 2).contiguous()
    out = _launch_k1(grad, neighbors, w_mirror, n_valid, "subm_conv dgrad")
    if int(n_valid):
        subm_conv_dgrad_cuda.launches += 1
    return out


subm_conv_dgrad_cuda.launches = 0


class WgradTile(NamedTuple):
    """The block shape of K2 for one (Cin, Cout) and dtype."""

    cin_tile: int  # input channels per block (the GEMM's m)
    cout_tile: int  # output channels per block (the GEMM's n)
    group: int  # consecutive offsets per block
    blocks: int  # blocks per row split: offset groups x Cin tiles x Cout tiles
    rows: int  # voxel rows per step of a block's loop
    acc: int  # fp32 accumulators per thread
    smem: int  # dynamic shared memory per block, bytes (0: static, fp32 route)


def wgrad_smem(mt: int, nt: int, gw: int) -> int:
    """The kernel's ``WgradSmem``: per ring stage the gathered rows (2 GW
    offsets x 32 rows x (16 MT + 8) bf16), the gradient rows (32 x (16 NT +
    8) bf16) and the table slice (2 GW x 32 int32), plus a mask per stage
    and one more."""
    tm, tn, gs = 16 * mt, 16 * nt, 2 * gw
    return (_W_STAGES * (gs * _W_ROWS * (tm + 8) * 2 + _W_ROWS * (tn + 8) * 2
                         + gs * _W_ROWS * 4) + (_W_STAGES + 1) * 4)


def wgrad_tile(cin: int, cout: int, dtype: torch.dtype = torch.bfloat16) -> WgradTile:
    """K2's block shape for a conv of `cin` -> `cout` channels.

    bf16 (the tensor-core route): among the compiled instances, each with
    groups of up to 2 GW offsets (the 27 split into groups of equal size),
    prefer the tiles that pad neither Cin nor Cout past its next multiple of
    16, then the least traffic per voxel row: each block pass over a row
    reads its table slice (one 32-byte sector) and its gradient slice (2
    bytes per Cout-tile channel), and each Cout tile gathers the row's
    neighbor rows (_WGRAD_GATHER_BYTES per tap and input channel).

    fp32 (the FMA route): 64 x 64 tiles when both widths reach 64, else 32 x
    32, one offset per block (the grid's 27 offsets), 64 rows per tile."""
    cin, cout = int(cin), int(cout)
    if dtype == torch.float32:
        t = 64 if cin >= 64 and cout >= 64 else 32
        blocks = 27 * -(-cin // t) * -(-cout // t)
        return WgradTile(t, t, 1, blocks, 64, (t // 16) ** 2, 0)
    if dtype != torch.bfloat16:
        raise ValueError(f"K2 takes fp32 or bf16, not {dtype}")
    best = None
    for mt, nt, gw in WGRAD_INSTANCES:
        tm, tn = 16 * mt, 16 * nt
        tiles_c, tiles_d = -(-cin // tm), -(-cout // tn)
        groups = -(-27 // min(27, 2 * gw))
        group = -(-27 // groups)
        pads = tiles_c * tm > 16 * -(-cin // 16) or tiles_d * tn > 16 * -(-cout // 16)
        passes = groups * tiles_c * tiles_d
        cost = passes * (32 + 2 * tn) + tiles_d * 27 * _WGRAD_GATHER_BYTES * cin
        tile = WgradTile(tm, tn, group, passes, _W_ROWS, -(-group // 2) * mt * nt * 4,
                         wgrad_smem(mt, nt, gw))
        if best is None or (pads, cost) < best[0]:
            best = ((pads, cost), tile)
    return best[1]


def wgrad_plan(n_valid: int, cin: int, cout: int, dtype: torch.dtype):
    """(tile, splits, partial scratch shape) of one K2 call: `wgrad_tile`,
    then row splits enough for the route's target of blocks per call, with
    at least 256 voxel rows per split; the scratch holds one fp32 (27, Cin,
    Cout) partial per split, none for one split."""
    tile = wgrad_tile(cin, cout, dtype)
    want = -(-_WGRAD_TARGET_BLOCKS[dtype] // tile.blocks)
    steps = -(-int(n_valid) // tile.rows)
    splits = max(1, min(want, steps // (256 // tile.rows)))
    return tile, splits, (splits if splits > 1 else 0, 27, int(cin), int(cout))


def subm_conv_wgrad_cuda(
    features: torch.Tensor,
    neighbors: torch.Tensor,
    grad: torch.Tensor,
    n_valid: int,
) -> torch.Tensor:
    """K2: dW[o] = sum_{i < n_valid} feat[nbr[i, o]]^T g[i].

    Args:
        features: (V, Cin) fp32 or bf16, contiguous: the conv's input.
        neighbors: (V, 27) int32, sentinel V, contiguous.
        grad: (V, Cout) cotangent of the conv output, the dtype of
            `features`, contiguous.
        n_valid: host int.

    Returns:
        (27, Cin, Cout) fp32.
    """
    if features.device.type == "cpu":
        return subm_conv_wgrad(features, neighbors, grad, n_valid)
    v, cin = features.shape
    if grad.dim() != 2 or grad.shape[0] != v:
        raise ValueError(f"grad {tuple(grad.shape)} != ({v}, Cout)")
    if features.dtype not in _DTYPES or grad.dtype != features.dtype:
        raise ValueError(
            f"features {features.dtype} / grad {grad.dtype}: both fp32 or "
            "both bf16"
        )
    n_valid = _check(v, neighbors, n_valid, features=features, grad=grad)
    cout = grad.shape[1]
    dw = torch.zeros((27, cin, cout), dtype=torch.float32, device=features.device)
    if n_valid == 0:
        return dw
    tile, splits, scratch = wgrad_plan(n_valid, cin, cout, features.dtype)
    part = torch.empty(scratch, dtype=torch.float32, device=features.device)
    with torch.cuda.device(features.device):
        err = _wgrad_kernel()(
            features.data_ptr(), neighbors.data_ptr(), grad.data_ptr(),
            part.data_ptr(), dw.data_ptr(), v, n_valid, cin, cout, tile.cin_tile,
            tile.cout_tile, tile.group, splits, _DTYPES[features.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"subm_conv wgrad kernel launch failed: CUDA error {err}")
    subm_conv_wgrad_cuda.launches += 1
    return dw


subm_conv_wgrad_cuda.launches = 0


class SubmConvFunction(torch.autograd.Function):
    """out = subm_conv(features, neighbors, weight) with the card's backward.

    ``weight`` is the fp32 master weight: the forward casts it to the
    features' dtype for K1, and the backward returns dW in fp32 from K2 (as
    ``dw.astype(weights.dtype)`` in the TPU version), so a bf16 forward never
    rounds the weight gradient. The cotangent is cast to the features' dtype
    before K1' and K2 (``g.astype(features.dtype)`` there); dfeat comes back
    in the features' dtype. K1' is skipped when the input needs no gradient
    (the input conv, whose input is data)."""

    @staticmethod
    def forward(ctx, features, neighbors, weight, n_valid: int):
        w = weight.to(features.dtype).contiguous()
        ctx.save_for_backward(features, neighbors, w)
        ctx.n_valid = int(n_valid)
        return subm_conv_cuda(features, neighbors, w, n_valid)

    @staticmethod
    def backward(ctx, grad_out):
        features, neighbors, w = ctx.saved_tensors
        g = grad_out.to(features.dtype).contiguous()
        dfeat = dw = None
        if ctx.needs_input_grad[0]:
            dfeat = subm_conv_dgrad_cuda(g, neighbors, w, ctx.n_valid)
            dfeat = dfeat.to(features.dtype)
        if ctx.needs_input_grad[2]:
            dw = subm_conv_wgrad_cuda(features, neighbors, g, ctx.n_valid)
        return dfeat, None, dw, None
