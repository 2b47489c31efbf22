"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file exposes a plain C interface, so it compiles in
seconds into its own shared library (no PyTorch headers). Libraries go to
``build/kernels/`` at the repository root, named by a hash of the source,
the shared headers in ``kernels/csrc/`` and the flags, so an edited source
or header is rebuilt and an unchanged one is reused. ``load`` builds on
first use and caches the loaded library; ``build_all`` compiles several
sources at once, one nvcc each. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

REPO_ROOT = Path(__file__).resolve().parents[3]
HEADER_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[Path, ctypes.CDLL] = {}
# nvcc's ptxas report (registers, shared memory, spills) per built source
ptxas_log: Dict[Path, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(HEADER_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build_all(sources) -> None:
    """Compile every source that has no up-to-date library, one nvcc
    process each, all started together; raises with the compiler's output
    if any fails."""
    todo = [(Path(s).resolve(), library_path(Path(s).resolve()))
            for s in sources]
    todo = [(src, lib) for src, lib in todo if not lib.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, lib, tmp, subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        ptxas_log[src] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} (exit "
                          f"{proc.returncode}):\n{ptxas_log[src]}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(source: Path) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    source = Path(source).resolve()
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            build_all([source])
            lib = _loaded[source] = ctypes.CDLL(str(library_path(source)))
        return lib
