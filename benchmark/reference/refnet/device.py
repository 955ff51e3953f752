"""Device selection for the port's entry points (the card unless the caller
asks for the CPU), and the card's name and kernel timing for the programs
that measure on it."""
from __future__ import annotations

import subprocess

import torch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's maximum SM clock in Hz, as nvidia-smi gives it."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


def cuda_ms(fn, reps=5, warmup=1) -> float:
    """Mean ms per call over `reps` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
