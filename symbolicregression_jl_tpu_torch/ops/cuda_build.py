"""Build and load the port's CUDA sources at first use.

Each source under ``csrc/`` has a plain C interface and is compiled with
``nvcc`` into a shared library that :mod:`ctypes` loads. The library goes
to ``build/kernels/`` at the root of the checkout (``.gitignore`` lists
it), named by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads at once. Nothing is built when a
module is imported: the CPU tests import every module and never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

__all__ = ["NVCC_FLAGS", "build_dir", "load_library", "source_path", "build_seconds"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_PKG = Path(__file__).resolve().parent.parent
_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
_BUILD_SECONDS: Dict[str, float] = {}


def source_path(name: str) -> Path:
    return _PKG / "csrc" / name


def build_dir() -> Path:
    return _PKG.parent / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _target(src: Path) -> Tuple[Path, str]:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"{src.stem}-{digest}.so", digest


def build(name: str) -> Path:
    """Compile ``csrc/<name>`` if its library is missing; return its path."""
    src = source_path(name)
    so, _ = _target(src)
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    _BUILD_SECONDS[name] = time.perf_counter() - t0
    return so


def load_library(name: str) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>``; cached per process."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LOADED[name] = lib
        return lib


def build_seconds(name: str) -> float:
    """Seconds the last build of ``name`` took in this process (0.0 when
    the library was already on disk)."""
    return _BUILD_SECONDS.get(name, 0.0)
