"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one source ``csrc/<name>.cu`` with a plain C interface,
compiled for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` at the
repository root the first time it is needed. The hash covers the source and
the flags, so an edited source is rebuilt and a stale library never loads.
Nothing here runs at import time: the CPU tests import every module on a
host without nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
KERNELS = ("subm_conv", "subm_conv_wgrad", "attention", "attention_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA "
            "kernels are compiled on a machine with the CUDA toolkit"
        )
    return str(path)


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=KERNELS) -> dict:
    """Compile every kernel in `names` that is not built yet, all nvcc
    processes at once. Returns {name: ptxas report} for the ones built here;
    raises with the compiler's output if any build fails."""
    jobs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, lib)
        reports[name] = log
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
