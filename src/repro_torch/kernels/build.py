"""Build a CUDA source of the port with ``nvcc`` and load it with ``ctypes``.

Each kernel package keeps its CUDA C++ under ``csrc/`` behind a plain C
interface (no PyTorch headers, so a build takes seconds).  At first use
the source is compiled for Hopper (``sm_90a``) into ``repro_torch/_build/``
— listed in ``.gitignore`` — under a name keyed by a hash of the source and
the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is.  Nothing is built when a module is imported.
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

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LOADED: Dict[Path, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` of the CUDA toolkit PyTorch found, else the one on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.exists():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless its library is already built; returns it."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never loads a half-written file
    return out


def load(source: Path) -> ctypes.CDLL:
    """The built library of ``source``, compiled at first use and cached."""
    with _LOCK:
        lib = _LOADED.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _LOADED[source] = lib
        return lib
