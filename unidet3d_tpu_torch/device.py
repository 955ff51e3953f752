"""Device selection for the port's entry points: the card unless the caller
asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device(device); raises when a CUDA device is asked for and CUDA
    is not available (the CPU runs only when the caller passes "cpu")."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's plain "
            "PyTorch path on the CPU"
        )
    return device
