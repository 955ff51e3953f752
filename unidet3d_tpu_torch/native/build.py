"""Builds the port's host C++ libraries (``rulebook.cc``, ``segmentator.cc``)
with g++ the first time they are needed.

Each library goes to ``build/<stem>-<hash>.so`` at the repository root; the
hash covers the source and the flags, so an edited source is rebuilt and a
library built with other flags never loads. Nothing builds at import. A
failed build raises with the compiler's output: no caller falls back to
another implementation. Builds are safe to start at once from several
threads (the loaders' workers) and several processes (pytest-xdist): one
lock per process, and a temporary name unique per call.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_LOCK = threading.Lock()  # one build at a time in this process


def library_path(src: Path, stem: str, flags, build_dir: Path) -> Path:
    """Where the library of `src` is built: its name hashes the source and
    the flags."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return build_dir / f"{stem}-{digest.hexdigest()[:12]}.so"


def build_library(src: Path, stem: str, flags, build_dir: Path) -> Path:
    """Compiles `src` unless its library exists; returns the library's path.
    Raises RuntimeError with the compiler's output if g++ is missing or
    fails. The library is written under a temporary name unique to this call
    and renamed, so threads and processes building at once never load a
    partial file; a thread that waited for another's build finds its
    library and returns it."""
    lib = library_path(src, stem, flags, build_dir)
    if lib.exists():
        return lib
    with _LOCK:
        if lib.exists():
            return lib
        build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=f"{lib.name}.", suffix=".tmp", dir=build_dir)
        os.close(fd)
        try:
            try:
                proc = subprocess.run(["g++", *flags, str(src), "-o", tmp],
                                      capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(f"g++ not found: {src.name} cannot be compiled") from e
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return lib
