"""Build and load the port's CUDA sources at first use.

Each source under ``csrc/`` has a plain C interface and is compiled with
``nvcc`` into a shared library that :mod:`ctypes` loads. The library goes
to ``build/kernels/`` at the root of the checkout (``.gitignore`` lists
it), named by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads at once; ptxas's report of each
kernel's registers, spills and stack (``-Xptxas -v``) goes beside it
(:func:`build_log`). Nothing is built when a module is imported: the CPU
tests import every module and never build.
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
from typing import Callable, Dict, List, Tuple

__all__ = ["NVCC_FLAGS", "build_dir", "build_all", "load_library", "source_path",
           "build_seconds", "build_log", "add_listener", "remove_listener"]

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PKG = Path(__file__).resolve().parent.parent
_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
_BUILD_SECONDS: Dict[str, float] = {}
# Callbacks told of every build (``("build", name, seconds)``, one per nvcc
# run) and every library load into this process (``("load", name,
# seconds)``): the telemetry hub counts them as the port's compile events.
_LISTENERS: List[Callable[[str, str, float], None]] = []


def add_listener(fn: Callable[[str, str, float], None]) -> None:
    """Call ``fn(kind, source name, seconds)`` on each build and load."""
    _LISTENERS.append(fn)


def remove_listener(fn: Callable[[str, str, float], None]) -> None:
    if fn in _LISTENERS:
        _LISTENERS.remove(fn)


def _notify(kind: str, name: str, seconds: float) -> None:
    for fn in list(_LISTENERS):
        fn(kind, name, seconds)


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
    """The library's path, named by a hash of the source, the headers of
    ``csrc/`` it may include, and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return build_dir() / f"{src.stem}-{digest}.so", digest


def build_all(names) -> Dict[str, Path]:
    """Compile every ``csrc/<name>`` whose library is missing, one nvcc
    process per source, all started together; return the libraries' paths."""
    out, running = {}, []
    for name in dict.fromkeys(names):   # each source once, in order
        src = source_path(name)
        so, _ = _target(src)
        out[name] = so
        if so.exists():
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((name, src, so, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, so, tmp, proc, t0 in running:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name}:\n{stdout}\n{stderr}")
            continue
        so.with_suffix(".log").write_text(stderr)
        os.replace(tmp, so)
        _BUILD_SECONDS[name] = time.perf_counter() - t0
        _notify("build", name, _BUILD_SECONDS[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>`` if its library is missing; return its path."""
    return build_all([name])[name]


def load_library(name: str) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>``; cached per process."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(build(name)))
            _LOADED[name] = lib
            _notify("load", name, time.perf_counter() - t0)
        return lib


def build_seconds(name: str) -> float:
    """Seconds the last build of ``name`` took in this process (0.0 when
    the library was already on disk)."""
    return _BUILD_SECONDS.get(name, 0.0)


def build_log(name: str) -> str:
    """nvcc's report (ptxas's ``-v`` lines) from the build of ``name``'s
    current library ("" when it has not been built)."""
    log = _target(source_path(name))[0].with_suffix(".log")
    return log.read_text() if log.exists() else ""
