"""Build a CUDA source of the port with ``nvcc`` and load it with ``ctypes``.

Each kernel package keeps its CUDA C++ under ``csrc/`` behind a plain C
interface (no PyTorch headers, so a build takes seconds); the Hopper
building blocks the tensor-core kernels share are in ``kernels/csrc/``,
and what a kernel's routes share in headers beside its sources.
At first use the source is compiled for Hopper (``sm_90a``) into
``repro_torch/_build/`` — listed in ``.gitignore`` — under a name keyed by
a hash of the source, the headers it can include and the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it
is.  ``ptxas -v`` reports each kernel's registers, shared memory and
spills; the report is kept beside the library (:func:`ptxas_report`).
Nothing is built when a module is imported.

:data:`LAUNCHES` counts each kernel's launches, by route, under a lock of
its own: a wrapper records one where it launches its kernel and nowhere
else.  :func:`verify_launch` is the ``PCCL_VERIFY=1`` gate every wrapper
passes before its device check, and :func:`device_geometry` reads what a
library's ``*_geometry`` export says a launch is given.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SHARED_HEADERS = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LOADED: Dict[Path, ctypes.CDLL] = {}


GEOMETRY_ARGTYPES = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                     ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong)]


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
    for header in sorted({*SHARED_HEADERS.glob("*.cuh"), *source.parent.glob("*.cuh")}):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def ptxas_report(source: Path) -> str:
    """What ``ptxas -v`` said when ``source`` was built (empty if not built here)."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


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
    out.with_suffix(".log").write_text(proc.stderr)
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


def device_geometry(fn, *dims: int) -> Dict[str, Any]:
    """What a ``*_geometry`` export of a built library says the launch for
    ``dims`` is given: ``grid`` (x, y, z), ``threads``, ``smem`` (dynamic
    bytes), and from ``cudaFuncGetAttributes`` the kernel's ``static_smem``
    and ``max_threads``.  Host only, but it needs the card's runtime."""
    grid = (ctypes.c_int * 3)()
    threads = ctypes.c_int()
    smem = ctypes.c_longlong()
    attrs = (ctypes.c_longlong * 2)()
    err = fn(*dims, grid, ctypes.byref(threads), ctypes.byref(smem), attrs)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}{dims}: error {err}")
    return {"grid": tuple(grid), "threads": threads.value, "smem": smem.value,
            "static_smem": attrs[0], "max_threads": attrs[1]}


def verify_launch(label: str, wrapper, args: Sequence[Any],
                  kwargs: Optional[Dict[str, Any]] = None) -> None:
    """The ``PCCL_VERIFY=1`` gate of a kernel wrapper: with the variable
    set, the kernel lint proves the launch model of ``wrapper(*args,
    **kwargs)`` (memoized by shapes, dtypes and statics) and raises
    :class:`~repro_torch.analysis.kernel_lint.KernelLintError` before
    anything is launched.  Read as ``compile_schedule`` reads it."""
    if os.environ.get("PCCL_VERIFY", "0") not in ("", "0"):
        from repro_torch.analysis.kernel_lint import verify_entry_point

        verify_entry_point(label, wrapper, args, kwargs)


class LaunchCounts:
    """Launches of each kernel of the port, by route, under one lock.

    Readers get copies, so a count never moves under them; :meth:`reset`
    sets every count to 0.
    """

    def __init__(self, routes: Dict[str, Tuple[str, ...]]) -> None:
        self._lock = threading.Lock()
        self._counts = {kernel: dict.fromkeys(names, 0) for kernel, names in routes.items()}

    def record(self, kernel: str, route: str) -> None:
        """One launch of ``kernel`` on ``route``."""
        with self._lock:
            self._counts[kernel][route] += 1

    def by_route(self, kernel: str) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts[kernel])

    def total(self, kernel: str) -> int:
        with self._lock:
            return sum(self._counts[kernel].values())

    def totals(self) -> Dict[str, int]:
        """Every kernel's launches, all routes together."""
        with self._lock:
            return {kernel: sum(c.values()) for kernel, c in self._counts.items()}

    def reset(self) -> None:
        with self._lock:
            for counts in self._counts.values():
                for route in counts:
                    counts[route] = 0


# K1 and K3 have a tensor-core and a CUDA-core route, K4 two tensor-core
# routes (P = N = 64, and P-tiles with N-slices) and a CUDA-core one; K2 is
# one Triton kernel; the round kernel counts a launch by the mode of what it
# runs: a round in place, each launch of a staged round, a row copy
LAUNCHES = LaunchCounts({
    "matmul": ("wgmma", "fma"),
    "rmsnorm": ("triton",),
    "flash": ("wgmma", "fma"),
    "ssd": ("wgmma", "wgmma_tiled", "fma"),
    "round": ("inplace", "staged", "copy"),
})
