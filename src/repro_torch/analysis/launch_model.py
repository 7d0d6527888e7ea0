"""The launch model of the port's CUDA and Triton kernels — the counterpart
of ``repro.analysis.pallas_model``.

A Pallas kernel is, statically, a grid of programs and one ``BlockSpec``
per operand.  A CUDA launch is a grid of blocks (CTAs) whose offsets each
block computes itself from ``blockIdx``; a Triton launch is the same with
programs.  The kernel lint (:mod:`repro_torch.analysis.kernel_lint`)
proves coverage, race freedom and bounds over **footprints**, so this
module gives each launch a pure-Python mirror, with no device execution:

* a :class:`CallSite` holds the grid, the threads per block, the dynamic
  shared memory the launcher passes (and what it hands
  ``cudaFuncSetAttribute``), the source file and launch line, and for
  every input and output a :class:`Footprint`: a function from the block
  index to the **union of boxes** of elements that block reads or writes
  (K4's recurrence walks a flat ``bh·PN + i`` range that crosses rows; its
  states pass gives the last block of each chunk another role than the
  others), the dims on which the kernel masks at the operand's edge, and
  whether reads go through a TMA tensor map (the hardware zero-fills out
  of range);
* :class:`BlockModel` is the reference's Pallas ``BlockSpec`` model,
  kept so that the reference's own call sites can be analyzed here with
  the reference's semantics (the tests hold the copied checks to it);
* :func:`capture_call_sites` maps a kernel wrapper of the port
  (``matmul_cuda``, ``rmsnorm_triton``, ``flash_attention_cuda``,
  ``ssd_cuda``, ``stacked_round_cuda``) to the call sites its launch model
  builds (each kernel package's ``launch.py``), reading only shapes,
  dtypes and statics, so CPU and meta tensors serve.

The launch models are tied to the real launchers twice: their tile
constants are read from the ``.cu`` sources (:func:`source_constants`,
``constexpr int NAME = <literal>;``), and on the card each library's
``*_geometry`` export, computed by the very function its launcher
launches with, must give the model's grid, threads and shared memory.
"""

from __future__ import annotations

import importlib
import re
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

__all__ = [
    "BlockModel",
    "Box",
    "CallSite",
    "CaptureError",
    "CudaKernel",
    "Footprint",
    "capture_call_sites",
    "cdiv",
    "dtype_name",
    "launch_line",
    "row_runs",
    "source_constants",
    "whole_array_box",
]

REPO = Path(__file__).resolve().parents[3]


class CaptureError(RuntimeError):
    """A wrapper has no launch model, or its model launches nothing."""


# ----------------------------------------------------------------- geometry


@dataclass(frozen=True)
class Box:
    """An axis-aligned element-space footprint: ``[offset, offset+size)``."""

    offset: Tuple[int, ...]
    size: Tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.offset) != len(self.size):
            raise ValueError(f"rank mismatch: {self.offset} vs {self.size}")

    @property
    def volume(self) -> int:
        v = 1
        for s in self.size:
            v *= s
        return v

    @property
    def end(self) -> Tuple[int, ...]:
        return tuple(o + s for o, s in zip(self.offset, self.size))

    def within(self, shape: Sequence[int]) -> bool:
        """True when the whole box lies inside ``[0, shape)``."""
        return len(shape) == len(self.offset) and all(
            0 <= o and o + s <= d for o, s, d in zip(self.offset, self.size, shape)
        )

    def overlaps(self, other: "Box") -> bool:
        return all(
            o1 < o2 + s2 and o2 < o1 + s1
            for o1, s1, o2, s2 in zip(self.offset, self.size, other.offset, other.size)
        )

    def clip(self, shape: Sequence[int], dims: Sequence[int], lower: bool = False) -> "Box":
        """The box cut at ``shape`` on ``dims`` — what a kernel's ``i < n``
        mask leaves of it — and, with ``lower``, at 0 too (TMA's zero fill
        covers both sides).  A dim cut to nothing has size 0."""
        off, size = list(self.offset), list(self.size)
        for d in dims:
            lo = max(off[d], 0) if lower else off[d]
            hi = min(off[d] + size[d], shape[d])
            off[d], size[d] = lo, max(hi - lo, 0)
        return Box(tuple(off), tuple(size))


def whole_array_box(shape: Sequence[int]) -> Box:
    return Box((0,) * len(shape), tuple(int(d) for d in shape))


def cdiv(a: int, b: int) -> int:
    """``(a + b - 1) / b`` of the launchers, for positive ints."""
    return -(-a // b)


def row_runs(start: int, stop: int, cols: int) -> List[Tuple[int, int, int, int]]:
    """The flat range ``[start, stop)`` of a row-major ``(rows, cols)``
    array as at most three rectangles ``(row, n_rows, col, n_cols)``: the
    partial first row, the whole rows, the partial last row."""
    if stop <= start:
        return []
    r0, c0 = divmod(start, cols)
    r1, c1 = divmod(stop, cols)
    if r0 == r1:
        return [(r0, 1, c0, c1 - c0)]
    runs = []
    if c0:
        runs.append((r0, 1, c0, cols - c0))
        r0 += 1
    if r1 > r0:
        runs.append((r0, r1 - r0, 0, cols))
    if c1:
        runs.append((r1, 1, 0, c1))
    return runs


# ------------------------------------------------------------ block models


@dataclass(frozen=True)
class BlockModel:
    """A Pallas ``BlockSpec`` as the reference captures it: block shape
    with ``None`` (squeezed) dims, plus the index map (program ids → block
    coordinates).  Analyzed with the reference's semantics."""

    block_shape: Tuple[Optional[int], ...]
    index_map: Callable[..., Tuple[int, ...]]

    @property
    def sizes(self) -> Tuple[int, ...]:
        """Element-space extent per dim (``None`` squeezed dims are 1)."""
        return tuple(1 if b is None else int(b) for b in self.block_shape)

    def coords(self, program: Sequence[int]) -> Tuple[int, ...]:
        out = self.index_map(*program)
        if not isinstance(out, tuple):
            out = (out,)
        if len(out) != len(self.block_shape):
            raise CaptureError(
                f"index map returned {len(out)} coords for a "
                f"{len(self.block_shape)}-dim block {self.block_shape}"
            )
        return tuple(int(c) for c in out)

    def footprint(self, program: Sequence[int]) -> Box:
        """Element-space box this program touches through this spec."""
        coords = self.coords(program)
        offset = tuple(
            c if b is None else c * int(b)
            for c, b in zip(coords, self.block_shape)
        )
        return Box(offset, self.sizes)


@dataclass(frozen=True)
class Footprint:
    """One operand of a CUDA or Triton launch.

    ``boxes(*block_index)`` gives the elements that block reads or writes
    as a union of boxes in the operand's shape (empty where the block's
    role does not touch the operand), before any mask: the offsets the
    kernel computes from ``blockIdx`` and the extents of its loops.
    ``masked`` names the dims on which the kernel guards with ``i < n``,
    so an overhang there is cut off rather than accessed; ``tma`` marks an
    operand read through a tensor map, whose out-of-range elements the
    hardware fills with zeros on every dim.
    """

    boxes: Callable[..., Sequence[Box]]
    masked: Tuple[int, ...] = ()
    tma: bool = False

    def clipped(self, program: Sequence[int], shape: Sequence[int]) -> Tuple[Box, ...]:
        """The boxes as the block really touches them: cut at the operand's
        edge on the masked dims, or on every dim (both sides) through TMA."""
        dims = range(len(shape)) if self.tma else self.masked
        return tuple(b.clip(shape, dims, lower=self.tma) for b in self.boxes(*program))


@dataclass(frozen=True)
class CudaKernel:
    """A ``__global__`` function: its source file and name (the body rules
    read it)."""

    source: Path
    name: str


Block = Union[BlockModel, Footprint]


# ---------------------------------------------------------------- call site


@dataclass(frozen=True)
class CallSite:
    """One launch: everything the lint needs, nothing device-side.  Dtypes
    are names (``"bfloat16"``), so consumers compare them without torch.

    ``route`` is ``"cuda"`` or ``"triton"`` for the port's launches, whose
    blocks all run in parallel and whose operands are :class:`Footprint`;
    ``None`` for a Pallas grid of :class:`BlockModel` (the reference's
    semantics, ``dimension_semantics`` as declared).
    """

    name: str
    grid: Tuple[int, ...]
    in_blocks: Tuple[Block, ...]
    in_shapes: Tuple[Tuple[int, ...], ...]
    in_dtypes: Tuple[str, ...]
    out_blocks: Tuple[Block, ...]
    out_shapes: Tuple[Tuple[int, ...], ...]
    out_dtypes: Tuple[str, ...]
    kernel: Any = None  # CudaKernel, a Triton function, or a Pallas body
    input_output_aliases: Tuple[Tuple[int, int], ...] = ()
    dimension_semantics: Optional[Tuple[str, ...]] = None
    route: Optional[str] = None
    in_names: Tuple[str, ...] = ()
    out_names: Tuple[str, ...] = ()
    threads: int = 0
    smem: int = 0  # dynamic shared memory the launch passes, bytes
    smem_attr: Optional[int] = None  # cudaFuncSetAttribute's value (None: not set)
    smem_need: int = 0  # what the kernel body carves out of its dynamic smem
    static_smem: int = 0  # the body's __shared__ arrays
    source: str = ""
    line: int = 0

    @property
    def num_programs(self) -> int:
        n = 1
        for g in self.grid:
            n *= g
        return n

    def with_in_block(self, i: int, block: Block) -> "CallSite":
        blocks = list(self.in_blocks)
        blocks[i] = block
        return replace(self, in_blocks=tuple(blocks))

    def with_out_block(self, i: int, block: Block) -> "CallSite":
        blocks = list(self.out_blocks)
        blocks[i] = block
        return replace(self, out_blocks=tuple(blocks))

    def label(self, role: str, i: int) -> str:
        """``in[0]`` as the reference names it, ``in[0](x)`` with a name."""
        names = self.in_names if role == "in" else self.out_names
        return f"{role}[{i}]({names[i]})" if i < len(names) else f"{role}[{i}]"

    @property
    def where(self) -> str:
        return f"{self.source}:{self.line}" if self.source else ""


# ------------------------------------------------------ sources and dtypes


def dtype_name(dtype: Any) -> str:
    """``torch.bfloat16`` → ``"bfloat16"``; a name stays as it is."""
    return str(dtype).rsplit(".", 1)[-1]


def repo_path(path: Path) -> str:
    try:
        return str(Path(path).resolve().relative_to(REPO))
    except ValueError:
        return Path(path).name


def source_constants(source: Path, names: Sequence[str]) -> Dict[str, int]:
    """``{NAME: value}`` of ``constexpr int NAME = <integer literal>;`` in a
    CUDA source, for every name asked; raises :class:`ValueError` when one
    is missing or not a literal, so the source, not the model, is the
    authority on tile sizes."""
    text = Path(source).read_text()
    found = {}
    for name in names:
        m = re.search(rf"\bconstexpr\s+int\s+{name}\s*=\s*([^;]*);", text)
        if m is None:
            raise ValueError(f"{Path(source).name}: no constexpr int {name}")
        value = m.group(1).strip()
        if not re.fullmatch(r"\d+", value):
            raise ValueError(f"{Path(source).name}: constexpr int {name} = {value} is not an "
                             "integer literal")
        found[name] = int(value)
    return found


def launch_line(source: Path, kernel: str) -> int:
    """The 1-based line of ``kernel<<<`` (template arguments allowed) in a
    CUDA source: the launch a call site models."""
    text = Path(source).read_text()
    pattern = re.compile(rf"\b{kernel}\s*(<[^<>;]*>)?\s*<<<")
    for n, line in enumerate(text.splitlines(), 1):
        if pattern.search(line):
            return n
    raise CaptureError(f"{Path(source).name}: no launch of {kernel}")


# ------------------------------------------------------------------ capture

#: wrapper (module.qualname) → the module whose ``call_sites`` models it
LAUNCH_MODELS = {
    "repro_torch.kernels.matmul.kernel.matmul_cuda": "repro_torch.kernels.matmul.launch",
    "repro_torch.kernels.rmsnorm.kernel.rmsnorm_triton": "repro_torch.kernels.rmsnorm.launch",
    "repro_torch.kernels.flash.kernel.flash_attention_cuda": "repro_torch.kernels.flash.launch",
    "repro_torch.kernels.ssd.kernel.ssd_cuda": "repro_torch.kernels.ssd.launch",
    "repro_torch.kernels.rounds.kernel.stacked_round_cuda": "repro_torch.kernels.rounds.launch",
}


def capture_call_sites(fn: Callable, *args: Any, **kwargs: Any) -> List[CallSite]:
    """The call sites ``fn(*args, **kwargs)`` would launch, in launch order.

    ``fn`` is one of the port's kernel wrappers; ``args`` need only
    ``.shape`` and ``.dtype`` (CPU or meta tensors serve).  Raises
    :class:`CaptureError` for a function with no launch model, or a model
    that launches nothing (a wrapper must not pass the lint vacuously).
    """
    name = f"{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', fn)}"
    module = LAUNCH_MODELS.get(name)
    if module is None:
        raise CaptureError(
            f"{name}: no launch model (the port models "
            f"{', '.join(m.rsplit('.', 1)[1] for m in LAUNCH_MODELS)})"
        )
    sites = importlib.import_module(module).call_sites(*args, **kwargs)
    if not sites:
        raise CaptureError(f"{name}: the launch model launches nothing")
    return list(sites)
