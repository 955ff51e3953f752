"""Submanifold conv on the card: the wrappers of the Hopper kernels and the
differentiable conv built from them.

  * ``subm_conv_cuda``: K1, the forward (``csrc/subm_conv.cu``), the port of
    the JAX package's ``ops/pallas_conv.py::subm_conv_pallas``.
  * ``subm_conv_dgrad_cuda``: K1', the input gradient: K1 launched on the
    cotangent with the mirrored weights ``W'[o] = W[26 - o]^T`` over the same
    neighbor table (``pallas_conv.py::_banded_conv_bwd``). It relies on the
    table being symmetric (pair (i, j, o) <=> (j, i, 26 - o)), which a
    GridPack table is.
  * ``subm_conv_wgrad_cuda``: K2, the weight gradient
    (``csrc/subm_conv_wgrad.cu``, the port of ``subm_conv_dw_pallas``).
  * ``SubmConvFunction``: the ``torch.autograd.Function`` around the three,
    the port of ``subm_conv_banded``'s custom VJP.

For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it runs the plain version from ``ops/sparse_conv.py``. Each wrapper's
``launches`` counts its kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .sparse_conv import subm_conv, subm_conv_dgrad, subm_conv_wgrad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Blocks K2 aims to have in flight: 16 per SM of the H100's 132.
_WGRAD_TARGET_BLOCKS = 16 * 132


@functools.cache
def _kernel():
    fn = cuda_build.load("subm_conv").subm_conv_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _wgrad_kernel():
    lib = cuda_build.load("subm_conv_wgrad")
    fn = lib.subm_conv_wgrad
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    tile = lib.subm_conv_wgrad_tile
    tile.argtypes = [ctypes.c_int, ctypes.c_int]
    tile.restype = ctypes.c_int
    return fn, tile


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


def _launch_k1(features, neighbors, weights, n_valid, name) -> torch.Tensor:
    """Checks, allocates and launches K1; the callers count the launch."""
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
            features.data_ptr(), neighbors.data_ptr(), weights.data_ptr(),
            out.data_ptr(), v, n_valid, cin, cout, _DTYPES[features.dtype],
            torch.cuda.current_stream().cuda_stream,
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


def _wgrad_splits(n_valid: int, cin: int, cout: int, tile: int) -> int:
    """Row splits of K2's reduction over voxels: enough blocks to fill the
    card, and at least 4 row tiles of 64 per split."""
    tiles = -(-cin // tile) * -(-cout // tile)
    want = -(-_WGRAD_TARGET_BLOCKS // (27 * tiles))
    return max(1, min(want, -(-n_valid // 64) // 4))


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
    fn, tile = _wgrad_kernel()
    splits = _wgrad_splits(n_valid, cin, cout, tile(cin, cout))
    part = torch.empty(
        (splits if splits > 1 else 0, 27, cin, cout), dtype=torch.float32,
        device=features.device,
    )
    with torch.cuda.device(features.device):
        err = fn(
            features.data_ptr(), neighbors.data_ptr(), grad.data_ptr(),
            part.data_ptr(), dw.data_ptr(), v, n_valid, cin, cout, splits,
            _DTYPES[features.dtype], torch.cuda.current_stream().cuda_stream,
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
