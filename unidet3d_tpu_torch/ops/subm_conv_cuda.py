"""Submanifold conv forward: the wrapper of the Hopper kernel
``csrc/subm_conv.cu`` (the port of the JAX package's
``ops/pallas_conv.py::subm_conv_pallas``).

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU tensor
it runs the plain version ``ops/sparse_conv.py::subm_conv``, the same
function in PyTorch. ``subm_conv_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .sparse_conv import subm_conv

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def subm_conv_cuda(
    features: torch.Tensor,
    neighbors: torch.Tensor,
    weights: torch.Tensor,
    n_valid: int,
) -> torch.Tensor:
    """out[i] = sum_o feat[nbr[i, o]] @ W[o] for i < n_valid, zero after.

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
    v, cin = features.shape
    if weights.dim() != 3 or weights.shape[:2] != (27, cin):
        raise ValueError(f"weights {tuple(weights.shape)} != (27, {cin}, Cout)")
    if tuple(neighbors.shape) != (v, 27) or neighbors.dtype != torch.int32:
        raise ValueError(
            f"neighbors {tuple(neighbors.shape)} {neighbors.dtype} != "
            f"({v}, 27) int32"
        )
    if features.dtype not in _DTYPES or weights.dtype != features.dtype:
        raise ValueError(
            f"features {features.dtype} / weights {weights.dtype}: both fp32 "
            "or both bf16"
        )
    for name, t in (("features", features), ("neighbors", neighbors),
                    ("weights", weights)):
        if t.device != features.device:
            raise ValueError(f"{name} on {t.device}, features on {features.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    n_valid = int(n_valid)
    if not 0 <= n_valid <= v:
        raise ValueError(f"n_valid {n_valid} outside [0, {v}]")
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
        raise RuntimeError(f"subm_conv kernel launch failed: CUDA error {err}")
    subm_conv_cuda.launches += 1
    return out


subm_conv_cuda.launches = 0
