"""Builds the port's host C++ libraries (``rulebook.cc``, ``segmentator.cc``)
with g++ the first time they are needed.

Each library goes to ``build/<stem>-<hash>.so`` at the repository root; the
hash covers the source and the flags, so an edited source is rebuilt and a
library built with other flags never loads. Nothing builds at import. A
failed build raises with the compiler's output: no caller falls back to
another implementation.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build"


def library_path(src: Path, stem: str, flags, build_dir: Path) -> Path:
    """Where the library of `src` is built: its name hashes the source and
    the flags."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return build_dir / f"{stem}-{digest.hexdigest()[:12]}.so"


def build_library(src: Path, stem: str, flags, build_dir: Path) -> Path:
    """Compiles `src` unless its library exists; returns the library's path.
    Raises RuntimeError with the compiler's output if g++ is missing or
    fails. The library is written under a temporary name and renamed, so
    processes building at once never load a partial file."""
    lib = library_path(src, stem, flags, build_dir)
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *flags, str(src), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found: {src.name} cannot be compiled") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib
