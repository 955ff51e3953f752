"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each kernel is one source ``csrc/<name>.cu`` with a plain C interface (it
may include the shared headers ``csrc/*.cuh``), compiled for Hopper
(``sm_90a``) into ``build/lib<name>-<hash>.so`` at the repository root the
first time it is needed. The hash covers the source, the headers and the
flags, so an edited source or header is rebuilt and a stale library never
loads. Builds are safe to start at once from several threads (one lock per
process) and several processes (a temporary name unique per build).
Nothing here runs at import time: the CPU tests import every module on a
host without nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
KERNELS = ("subm_conv", "subm_conv_wgrad", "attention", "attention_bwd", "sp_trim",
           "mask_attention", "point_pool")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
_LOCK = threading.Lock()  # one build() at a time in this process


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
    """The library of `name`; its hash covers the source, every shared
    header in csrc/ (``*.cuh``) and the flags."""
    src = b"".join(path.read_bytes() for path in (
        CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=KERNELS) -> dict:
    """Compile every kernel in `names` that is not built yet, all nvcc
    processes at once. Returns {name: ptxas report} for the ones built here;
    raises with the compiler's output if any build fails. Each library is
    written under a temporary name unique to its build and renamed; a thread
    that waited for another's build finds those libraries built."""
    with _LOCK:
        todo = [(name, library_path(name)) for name in names]
        todo = [(name, lib) for name, lib in todo if not lib.exists()]
        if not todo:
            return {}
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmps, jobs, reports, failed = [], {}, {}, []
        try:
            for name, lib in todo:
                fd, tmp = tempfile.mkstemp(prefix=f"{lib.name}.", suffix=".tmp", dir=BUILD_DIR)
                os.close(fd)
                tmps.append(tmp)
                cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
                jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True), tmp, lib)
            for name, (proc, tmp, lib) in jobs.items():
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"nvcc failed for {name}.cu:\n{log}")
                    continue
                os.replace(tmp, lib)
                reports[name] = log
        finally:
            for proc, _, _ in jobs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for tmp in tmps:
                if os.path.exists(tmp):
                    os.remove(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def _kernel_name(mangled: str) -> str:
    """The last name of an Itanium-mangled function in namespaces
    (``_ZN<len><ns>...<len><name>...``), or `mangled` itself, followed by
    its template arguments when all are integers (``ILi160ELi0EE`` ->
    ``<160, 0>``)."""
    if not mangled.startswith("_ZN"):
        return mangled
    at, name = 3, mangled
    while (length := re.match(r"\d+", mangled[at:])) is not None:
        start = at + length.end()
        name = mangled[start:start + int(length[0])]
        at = start + int(length[0])
    args = re.match(r"I((?:Li-?\d+E)+)E", mangled[at:])
    if args:
        name += "<" + ", ".join(re.findall(r"Li(-?\d+)E", args[1])) + ">"
    return name


def ptxas_report(log: str) -> list:
    """Each kernel's resources from a ptxas -v report, in its order:
    [(name, {"registers", "spill_stores", "spill_loads", "smem"})], the name
    demangled to its last part and, for a template over integers only, its
    arguments (other templates' instances share the bare name)."""
    kernels = []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernels.append((_kernel_name(entry[1]), {}))
        elif kernels:
            stats = kernels[-1][1]
            for key, pattern in (("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads"),
                                 ("registers", r"Used (\d+) registers"),
                                 ("smem", r"(\d+) bytes smem")):
                found = re.search(pattern, line)
                if found:
                    stats[key] = int(found[1])
    return kernels


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built first if needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
