"""Static analyzer for the port's CUDA and Triton kernels — launch-model
dataflow proofs plus a source-level precision and hygiene lint.  The
counterpart of ``repro.analysis.kernel_lint``.

Per :class:`~repro_torch.analysis.launch_model.CallSite` it proves:

* **coverage** — every element of every output is written by exactly one
  block.  A CUDA grid has no order, so every grid axis is parallel: two
  blocks whose footprints meet are a ``write-race``, with none of the
  reference's exemption for a block revisited along a sequential axis.
  The check is exact and sort-based: each output is cut at every box edge
  and every cell of that grid must be written once;
* **bounds** — every footprint stays inside its operand at every block.
  A footprint that overhangs a dim on which the kernel masks (``i < n``) is
  cut off there, and one read through a TMA tensor map is cut on every dim
  (the hardware zero-fills), so coverage is exact over the unpadded shape
  where the reference required blocks to divide it; an overhang anywhere
  else is ``oob-read`` / ``oob-write``;
* **smem-budget** — a block's dynamic plus static shared memory fits the
  227 KiB a Hopper block may opt in to, the launch passes exactly what the
  launcher hands ``cudaFuncSetAttribute``, and at least what the body
  carves out of it;
* **grid-limit** — the grid and the block fit CUDA's launch limits;
* **body rules** — for the Triton RMSNorm (plain Python) the reference's
  AST rules, in Triton's terms: ``low-precision-read`` (a sub-fp32
  ``tl.load`` not followed by ``.to(tl.float32)``), ``missing-store-cast``
  (a ``tl.store`` of a value not cast ``.to(<ptr>.dtype.element_ty)``),
  ``dead-param``; for each CUDA ``__global__``, from its source,
  ``dead-param`` (a parameter the body never names) and
  ``missing-store-cast`` (a store into a ``T*`` or ``__nv_bfloat16*``
  output that does not go through ``from_f32<T>`` or a bf16 conversion).

Call sites with ``route=None`` are Pallas grids of
:class:`~repro_torch.analysis.launch_model.BlockModel`; they get the
reference's own checks, copied with their messages (``_check_grid``,
``_check_bounds``, ``_dependent_axes``, ``_check_output_coverage``,
``_check_aliases``), which the tests hold to the reference on its call
sites and mutants.  :data:`UNPORTED_RULES` lists the reference's rules
that have no counterpart here, and why.

What the lint cannot see: the arithmetic (an input read from the wrong but
valid place, which the parity tests catch), what happens inside a block
(the order of its threads' stores, its own shared memory), and a launcher
that differs from its model (the card's ``*_geometry`` check and the
NaN-filled output probe in ``chip_smoke.py`` path 13 catch those).

Entry points: :func:`analyze_call_site`, :func:`analyze_callable` (model a
wrapper's launches and analyze each), :func:`verify_entry_point` (the
``PCCL_VERIFY=1`` gate every kernel wrapper passes before its device
check, memoized), and :func:`run_shipped` / ``python -m
repro_torch.analysis --kernels`` (every route at edge shapes and at the
main paths' shapes).  No device execution anywhere.
"""

from __future__ import annotations

import ast
import inspect
import itertools
import re
import textwrap
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .launch_model import (
    Box, CallSite, CaptureError, CudaKernel, capture_call_sites, dtype_name,
)

__all__ = [
    "KernelLintError",
    "KernelReport",
    "KernelSummary",
    "KernelViolation",
    "KINDS",
    "analyze_call_site",
    "analyze_callable",
    "assert_kernel_clean",
    "clear_verified_cache",
    "gate_counts",
    "main_path_cases",
    "run_shipped",
    "shipped_kernel_cases",
    "summarize_kernel",
    "verify_entry_point",
]

#: Violation kinds emitted by the analyzer (stable identifiers for tests).
KINDS = (
    "grid-empty",          # a grid dimension is <= 0
    "grid-unenumerable",   # too many programs to enumerate exactly
    "grid-limit",          # grid or block over CUDA's launch limits
    "oob-read",            # an input footprint leaves the operand shape
    "oob-write",           # an output footprint leaves the output shape
    "write-race",          # two writers touch overlapping footprints
    "coverage-gap",        # some output elements are never written
    "coverage-misaligned", # writer set too large to check exactly
    "alias-mismatch",      # input_output_aliases with unequal footprints
    "missing-store-cast",  # sub-fp32 output stored without its conversion
    "low-precision-read",  # sub-fp32 operand read without fp32 upcast
    "dead-param",          # kernel param unused (or only multiplied by zero)
    "smem-budget",         # shared memory over the limit or not as launched
)

#: The reference's rules with no counterpart in the port, and why.
UNPORTED_RULES = {
    "scratch-no-reset": "a CUDA carry lives in one block's registers or shared memory, "
                        "initialised in its own loop; nothing carries across blocks",
    "scratch-carry-axis": "a CUDA carry lives in one CTA's loop, never across grid steps",
    "scratch-carry-parallel": "every CUDA grid axis is parallel; the lint assumes it",
    "vmem-budget": "replaced by smem-budget: Hopper's 227 KiB of shared memory a block",
}

#: Shared memory one H100 block may opt in to, bytes
#: (``torch.cuda.get_device_properties(0).shared_memory_per_block_optin``).
DEFAULT_SMEM_BUDGET = 232448

#: Dynamic shared memory a block gets without ``cudaFuncSetAttribute``.
SMEM_DEFAULT_LIMIT = 48 * 1024

#: Exact-enumeration cap: grids beyond this report grid-unenumerable
#: instead of silently sampling.
MAX_PROGRAMS = 1 << 17

#: Cells of an output's cut grid the exact coverage check will count.
MAX_CELLS = 1 << 24

_SUB_FP32 = ("bfloat16", "float16")


class KernelLintError(AssertionError):
    """Raised by :func:`assert_kernel_clean` / :func:`verify_entry_point`."""

    def __init__(self, reports: Sequence["KernelReport"]):
        self.reports = tuple(reports)
        super().__init__("\n".join(str(r) for r in reports))


@dataclass(frozen=True)
class KernelViolation:
    """One attributable kernel-lint failure."""

    kind: str
    site: str                              # call-site (kernel) name
    operand: Optional[str] = None          # "out[0]" / "in[2](x)" / param
    program: Optional[Tuple[int, ...]] = None  # offending block / program id
    box: Optional[Tuple[int, ...]] = None  # block coords or element offset
    detail: str = ""

    def __str__(self) -> str:
        loc = self.site
        if self.operand is not None:
            loc += f" {self.operand}"
        msg = f"{loc} [{self.kind}]"
        if self.program is not None:
            msg += f" program {self.program}"
        if self.box is not None:
            msg += f" block {self.box}"
        if self.detail:
            msg += f": {self.detail}"
        return msg


@dataclass(frozen=True)
class KernelReport:
    """Outcome of analyzing one call site."""

    site: str
    grid: Tuple[int, ...]
    programs_checked: int
    violations: Tuple[KernelViolation, ...] = ()
    where: str = ""  # source:line of the launch

    @property
    def ok(self) -> bool:
        return not self.violations

    def __str__(self) -> str:
        head = f"{self.site} grid={self.grid}"
        if self.where:
            head += f" ({self.where})"
        if self.ok:
            return f"{head}: clean over {self.programs_checked} programs"
        lines = [f"{head}: {len(self.violations)} violation(s)"]
        lines += [f"  {v}" for v in self.violations]
        return "\n".join(lines)


# ------------------------------------------------------------ body summary


@dataclass
class KernelSummary:
    """Structural facts about one kernel body, from its source."""

    fn_name: str
    params: Tuple[str, ...] = ()
    in_params: Tuple[str, ...] = ()
    out_params: Tuple[str, ...] = ()
    uses: Dict[str, int] = field(default_factory=dict)      # name loads per param
    zero_uses: Dict[str, int] = field(default_factory=dict)  # uses inside *0
    raw_reads: Dict[str, List[int]] = field(default_factory=dict)  # no fp32 upcast
    uncast_stores: Dict[str, List[int]] = field(default_factory=dict)
    language: str = "cuda"  # or "triton"
    parsed: bool = True  # False when the source was unavailable


def _is_float32(node: ast.expr) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "float32"


def _is_element_ty_of(node: ast.expr, params: Sequence[str]) -> bool:
    """``<ptr>.dtype.element_ty`` where ``<ptr>`` is a parameter."""
    return (isinstance(node, ast.Attribute) and node.attr == "element_ty"
            and isinstance(node.value, ast.Attribute) and node.value.attr == "dtype"
            and isinstance(node.value.value, ast.Name) and node.value.value.id in params)


def _tl_call(node: ast.AST, name: str) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == name)


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _summarize_triton(fn: Callable, in_params: Sequence[str],
                      out_params: Sequence[str]) -> KernelSummary:
    name = getattr(fn, "__name__", str(fn))
    try:
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    except (OSError, TypeError, SyntaxError):
        return KernelSummary(fn_name=name, language="triton", parsed=False)
    fndef = next((n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                  and n.name == name), None)
    if fndef is None:
        return KernelSummary(fn_name=name, language="triton", parsed=False)
    params = tuple(a.arg for a in fndef.args.args)
    s = KernelSummary(fn_name=name, params=params, in_params=tuple(in_params),
                      out_params=tuple(out_params), language="triton")
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(fndef):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    for node in ast.walk(fndef):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) and node.id in params:
            s.uses[node.id] = s.uses.get(node.id, 0) + 1
            up = parents.get(node)
            while isinstance(up, (ast.BinOp, ast.UnaryOp)):
                if (isinstance(up, ast.BinOp) and isinstance(up.op, ast.Mult)
                        and any(isinstance(f, ast.Constant) and f.value == 0
                                for f in (up.left, up.right))):
                    s.zero_uses[node.id] = s.zero_uses.get(node.id, 0) + 1
                    break
                up = parents.get(up)
        if _tl_call(node, "load") and node.args:
            for p in _names_in(node.args[0]) & set(in_params):
                attr = parents.get(node)
                call = parents.get(attr)
                upcast = (isinstance(attr, ast.Attribute) and attr.attr == "to"
                          and isinstance(call, ast.Call) and len(call.args) == 1
                          and _is_float32(call.args[0]))
                if not upcast:
                    s.raw_reads.setdefault(p, []).append(node.lineno)
        if _tl_call(node, "store") and len(node.args) >= 2:
            value = node.args[1]
            for p in _names_in(node.args[0]) & set(out_params):
                cast = (_tl_call(value, "to") and len(value.args) == 1
                        and _is_element_ty_of(value.args[0], (p,)))
                if not cast:
                    s.uncast_stores.setdefault(p, []).append(node.lineno)
    return s


def _strip_comments(text: str) -> str:
    """``//`` and ``/* */`` comments blanked, newlines kept (line numbers hold)."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, text, flags=re.S)


def _matching(text: str, start: int, open_: str, close: str) -> int:
    """Index just past the bracket closing the one at ``start``."""
    depth = 0
    for i in range(start, len(text)):
        if text[i] == open_:
            depth += 1
        elif text[i] == close:
            depth -= 1
            if depth == 0:
                return i + 1
    raise ValueError(f"unbalanced {open_}{close} at {start}")


def _split_params(params: str) -> List[str]:
    out, depth, cur = [], 0, ""
    for ch in params:
        if ch in "<([":
            depth += 1
        elif ch in ">)]":
            depth -= 1
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        out.append(cur.strip())
    return out


_NOT_FUNCTIONS = {"if", "for", "while", "switch", "return", "sizeof", "catch",
                  "__launch_bounds__", "static_assert", "decltype"}


def _functions(text: str) -> Dict[str, Tuple[List[str], str, int, Tuple[str, ...], bool]]:
    """Every function definition in a CUDA source: name → (parameters, body,
    offset of the body, template type names, is ``__global__``)."""
    found = {}
    for m in re.finditer(r"\b([A-Za-z_]\w*)\s*\(", text):
        name = m.group(1)
        if name in _NOT_FUNCTIONS or name in found:
            continue
        try:
            close = _matching(text, m.end() - 1, "(", ")")
        except ValueError:
            continue
        brace = re.match(r"\s*(?:const\s*)?\{", text[close:])
        prefix = text[max(text.rfind(c, 0, m.start()) for c in ";{}") + 1:m.start()]
        if brace is None or not re.search(r"[\w*&>)]\s*$", prefix):
            continue
        body_start = close + brace.end() - 1
        template = re.search(r"template\s*<([^<>]*)>", prefix)
        types = tuple(re.findall(r"(?:typename|class)\s+(\w+)",
                                 template.group(1) if template else ""))
        found[name] = (_split_params(text[m.end():close - 1]),
                       text[body_start:_matching(text, body_start, "{", "}")], body_start,
                       types, "__global__" in prefix)
    return found


_CONVERTED = re.compile(r"from_f32\s*<|__float2bfloat16|pack_bf16x2\s*\(")


def _param_name(param: str) -> str:
    m = re.search(r"(\w+)\s*(\[[^\]]*\])?$", param)
    return m.group(1) if m else param


def _output_pointers(params: Sequence[str], types: Sequence[str]) -> List[str]:
    """Non-const pointer parameters to a template type or ``__nv_bfloat16``."""
    outs = []
    for p in params:
        if "*" not in p or re.search(r"\bconst\b", p.split("*")[0]):
            continue
        element = re.sub(r"__restrict__|\*", " ", p.rsplit(_param_name(p), 1)[0]).split()
        if element and (element[-1] in types or element[-1] == "__nv_bfloat16"):
            outs.append(_param_name(p))
    return outs


_ASSIGN = re.compile(r"(?<![=!<>+\-*/%&|^])=(?!=)")
_POINTER_DECL = re.compile(r"^\s*(?:const\s+)?[\w:]+\s*\*\s*(?:__restrict__\s*)?(\w+)\s*=(.*)$",
                           flags=re.S)


def _statements(body: str) -> List[Tuple[int, str]]:
    """(offset, text) of the body's simple statements (split at ``; { }``)."""
    out, start = [], 0
    for m in re.finditer(r"[;{}]", body):
        out.append((start, body[start:m.start()]))
        start = m.end()
    return out


def _call_args(stmt: str) -> List[Tuple[str, List[str]]]:
    """(callee, arguments) of every call in a statement."""
    calls = []
    for m in re.finditer(r"\b(\w+)\s*\(", stmt):
        try:
            close = _matching(stmt, m.end() - 1, "(", ")")
        except ValueError:
            continue
        calls.append((m.group(1), _split_params(stmt[m.end():close - 1])))
    return calls


def _names(expr: str) -> Set[str]:
    return set(re.findall(r"\b[A-Za-z_]\w*\b", expr))


def _uncast_stores(body: str, pointer: str, functions, depth: int = 0) -> List[int]:
    """Offsets in ``body`` of stores through ``pointer``, or a local pointer
    derived from it, whose value is not converted (``from_f32<T>``, a bf16
    conversion); a pointer handed to a helper of the source counts as that
    helper's stores into its parameter."""
    statements = _statements(body)
    aliases = {pointer}
    for _, stmt in statements:  # declarations come before their uses
        decl = _POINTER_DECL.match(stmt)
        if decl and _names(decl.group(2)) & aliases:
            aliases.add(decl.group(1))
    bad = []
    for at, stmt in statements:
        assign = _ASSIGN.search(stmt)
        if assign is not None and not _POINTER_DECL.match(stmt):
            lhs, rhs = stmt[:assign.start()].rstrip(), stmt[assign.end():]
            if lhs.endswith(("]", ")")) and _names(lhs) & aliases and not _CONVERTED.search(rhs):
                bad.append(at + len(stmt) - len(stmt.lstrip()))
                continue
        if depth >= 2:
            continue
        for callee, args in _call_args(stmt):
            helper = functions.get(callee)
            if helper is None:
                continue
            for i, arg in enumerate(args[:len(helper[0])]):
                param = helper[0][i]
                if (_names(arg) & aliases and "*" in param
                        and not re.search(r"\bconst\b", param.split("*")[0])
                        and _uncast_stores(helper[1], _param_name(param), functions, depth + 1)):
                    bad.append(at + len(stmt) - len(stmt.lstrip()))
    return sorted(set(bad))


def _summarize_cuda(kernel: CudaKernel) -> KernelSummary:
    raw = Path(kernel.source).read_text()
    text = _strip_comments(raw)
    functions = _functions(text)
    fn = functions.get(kernel.name)
    if fn is None or not fn[4]:
        raise CaptureError(f"{kernel.name}: no __global__ of that name in "
                           f"{Path(kernel.source).name}")
    params, body, offset, types, _ = fn
    names = tuple(_param_name(p) for p in params)
    s = KernelSummary(fn_name=kernel.name, params=names,
                      out_params=tuple(_output_pointers(params, types)))
    for n in names:
        s.uses[n] = len(re.findall(rf"\b{n}\b", body))
    for p in s.out_params:
        lines = [text.count("\n", 0, offset + at) + 1
                 for at in _uncast_stores(body, p, functions)]
        if lines:
            s.uncast_stores[p] = lines
    return s


def summarize_kernel(kernel: Any, *, in_params: Sequence[str] = (),
                     out_params: Sequence[str] = ()) -> KernelSummary:
    """Body facts of a call site's kernel: a
    :class:`~repro_torch.analysis.launch_model.CudaKernel` is read from its
    source; a Triton function (plain Python) is parsed, with the pointer
    parameters it loads (``in_params``) and stores (``out_params``).
    ``parsed=False`` when the source is unavailable: the model checks still
    run."""
    if isinstance(kernel, CudaKernel):
        return _summarize_cuda(kernel)
    return _summarize_triton(kernel, in_params, out_params)


# -------------------------------------------------------- model-side checks
# (the reference's, copied with their messages: Pallas grids of BlockModel)


def _check_grid(site: CallSite, out: List[KernelViolation]) -> bool:
    ok = True
    for a, g in enumerate(site.grid):
        if g <= 0:
            out.append(KernelViolation(
                "grid-empty", site.name, program=None,
                detail=f"grid axis {a} has extent {g}"))
            ok = False
    if ok and site.num_programs > MAX_PROGRAMS:
        out.append(KernelViolation(
            "grid-unenumerable", site.name,
            detail=f"{site.num_programs} programs > cap {MAX_PROGRAMS}; "
                   "cannot prove coverage exactly"))
        ok = False
    return ok


def _check_bounds(
    site: CallSite, programs: Sequence[Tuple[int, ...]],
    out: List[KernelViolation], max_per_spec: int = 3,
) -> Dict[str, Dict[Tuple[int, ...], Tuple[int, ...]]]:
    """Bounds for every spec at every program; returns out-spec offset maps
    (program → element offset) for the coverage pass."""
    offsets: Dict[str, Dict[Tuple[int, ...], Tuple[int, ...]]] = {}
    for role, blocks, shapes in (
        ("in", site.in_blocks, site.in_shapes),
        ("out", site.out_blocks, site.out_shapes),
    ):
        kind = "oob-read" if role == "in" else "oob-write"
        for i, (blk, shape) in enumerate(zip(blocks, shapes)):
            label = f"{role}[{i}]"
            per_prog: Dict[Tuple[int, ...], Tuple[int, ...]] = {}
            reported = 0
            for p in programs:
                try:
                    box = blk.footprint(p)
                except Exception as e:  # index map crashed on this id
                    out.append(KernelViolation(
                        kind, site.name, label, p,
                        detail=f"index map failed: {e}"))
                    reported += 1
                    if reported >= max_per_spec:
                        break
                    continue
                per_prog[p] = box.offset
                if not box.within(shape):
                    if reported < max_per_spec:
                        out.append(KernelViolation(
                            kind, site.name, label, p, box.offset,
                            detail=f"footprint {box.offset}+{box.size} "
                                   f"outside operand shape {shape}"))
                    reported += 1
            if reported > max_per_spec:
                out.append(KernelViolation(
                    kind, site.name, label,
                    detail=f"… {reported - max_per_spec} more programs "
                           "out of bounds"))
            if role == "out":
                offsets[label] = per_prog
    return offsets


def _dependent_axes(
    programs: Sequence[Tuple[int, ...]],
    offset_of: Dict[Tuple[int, ...], Tuple[int, ...]],
    n_axes: int,
) -> Set[int]:
    """Grid axes whose variation (others fixed) ever changes the footprint."""
    dep: Set[int] = set()
    for a in range(n_axes):
        seen: Dict[Tuple[int, ...], Tuple[int, ...]] = {}
        for p in programs:
            key = p[:a] + p[a + 1:]
            off = offset_of.get(p)
            if off is None:
                continue
            prev = seen.get(key)
            if prev is None:
                seen[key] = off
            elif prev != off:
                dep.add(a)
                break
    return dep


def _check_output_coverage(
    site: CallSite, programs: Sequence[Tuple[int, ...]],
    offsets: Dict[str, Dict[Tuple[int, ...], Tuple[int, ...]]],
    out: List[KernelViolation],
) -> None:
    for oi, (blk, shape) in enumerate(zip(site.out_blocks, site.out_shapes)):
        label = f"out[{oi}]"
        per_prog = offsets.get(label, {})
        if len(per_prog) != len(programs):
            continue  # bounds pass already reported index-map failures
        sizes = blk.sizes
        dep = _dependent_axes(programs, per_prog, len(site.grid))
        dep_sorted = sorted(dep)
        # writer class = projection onto depended-on axes; single-axis
        # invariance composes, so each class maps to exactly one box
        class_rep: Dict[Tuple[int, ...], Tuple[int, ...]] = {}
        class_off: Dict[Tuple[int, ...], Tuple[int, ...]] = {}
        for p in programs:
            cls = tuple(p[a] for a in dep_sorted)
            if cls not in class_rep:
                class_rep[cls] = p
                class_off[cls] = per_prog[p]
        # parallel revisit: an ignored axis with extent > 1 that is declared
        # parallel means concurrent programs rewrite the same block
        if site.dimension_semantics is not None:
            for a, sem in enumerate(site.dimension_semantics):
                if (sem == "parallel" and a not in dep
                        and a < len(site.grid) and site.grid[a] > 1):
                    out.append(KernelViolation(
                        "write-race", site.name, label,
                        detail=f"grid axis {a} is parallel but {label}'s "
                               "index map ignores it: "
                               f"{site.grid[a]} programs write each block"))
        aligned = all(
            s > 0 and all(off[d] % s == 0 for off in class_off.values())
            for d, s in enumerate(sizes)
        )
        if aligned:
            # boxes are cells of a regular lattice: identical or disjoint
            cell_of: Dict[Tuple[int, ...], Tuple[int, ...]] = {}
            race = 0
            for cls, off in class_off.items():
                cell = tuple(o // s for o, s in zip(off, sizes))
                other = cell_of.get(cell)
                if other is not None:
                    if race < 3:
                        out.append(KernelViolation(
                            "write-race", site.name, label,
                            program=class_rep[cls], box=cell,
                            detail="also written by program "
                                   f"{class_rep[other]}"))
                    race += 1
                else:
                    cell_of[cell] = cls
            if race > 3:
                out.append(KernelViolation(
                    "write-race", site.name, label,
                    detail=f"… {race - 3} more colliding writer classes"))
            # coverage: the lattice must tile the output exactly
            ragged = [d for d, s in enumerate(sizes) if shape[d] % s]
            if ragged:
                out.append(KernelViolation(
                    "coverage-gap", site.name, label,
                    detail=f"block {sizes} does not divide output "
                           f"shape {shape} on dims {ragged}"))
                continue
            expected = [shape[d] // s for d, s in enumerate(sizes)]
            total = 1
            for e in expected:
                total *= e
            if len(cell_of) < total:
                missing = []
                for cell in itertools.product(*(range(e) for e in expected)):
                    if cell not in cell_of:
                        missing.append(cell)
                        if len(missing) == 3:
                            break
                out.append(KernelViolation(
                    "coverage-gap", site.name, label, box=missing[0],
                    detail=f"{total - len(cell_of)} of {total} blocks never "
                           f"written; first missing block coords: {missing}"))
        else:
            classes = list(class_off.items())
            if len(classes) > 2048:
                out.append(KernelViolation(
                    "coverage-misaligned", site.name, label,
                    detail=f"{len(classes)} unaligned writer classes; "
                           "exact overlap check refused"))
                continue
            overlap = False
            for (c1, o1), (c2, o2) in itertools.combinations(classes, 2):
                if Box(o1, sizes).overlaps(Box(o2, sizes)):
                    out.append(KernelViolation(
                        "write-race", site.name, label,
                        program=class_rep[c1], box=o1,
                        detail=f"overlaps program {class_rep[c2]} at {o2}"))
                    overlap = True
                    break
            if not overlap:
                vol = sum(Box(o, sizes).volume for _, o in classes)
                want = 1
                for d in shape:
                    want *= d
                if vol < want:
                    out.append(KernelViolation(
                        "coverage-gap", site.name, label,
                        detail=f"disjoint writes cover {vol} of {want} "
                               "elements"))


def _check_aliases(
    site: CallSite, programs: Sequence[Tuple[int, ...]],
    out: List[KernelViolation],
) -> None:
    for i_in, i_out in site.input_output_aliases:
        label = f"in[{i_in}]~out[{i_out}]"
        if i_in >= len(site.in_blocks) or i_out >= len(site.out_blocks):
            out.append(KernelViolation(
                "alias-mismatch", site.name, label,
                detail="alias index out of range"))
            continue
        if site.in_shapes[i_in] != site.out_shapes[i_out] or (
                site.in_dtypes[i_in] != site.out_dtypes[i_out]):
            out.append(KernelViolation(
                "alias-mismatch", site.name, label,
                detail=f"aliased buffers differ: "
                       f"{site.in_shapes[i_in]}/{site.in_dtypes[i_in]} vs "
                       f"{site.out_shapes[i_out]}/{site.out_dtypes[i_out]}"))
            continue
        bi, bo = site.in_blocks[i_in], site.out_blocks[i_out]
        for p in programs:
            if bi.footprint(p) != bo.footprint(p):
                out.append(KernelViolation(
                    "alias-mismatch", site.name, label, p,
                    detail=f"read footprint {bi.footprint(p).offset} != "
                           f"write footprint {bo.footprint(p).offset}; an "
                           "aliased operand must be consumed exactly where "
                           "it is overwritten"))
                break


# -------------------------------------------- the port's launches (CUDA, Triton)


def _check_launch_limits(site: CallSite, out: List[KernelViolation]) -> None:
    limits = ((1 << 31) - 1, 65535, 65535)
    for a, (g, limit) in enumerate(zip(site.grid, limits)):
        if g > limit:
            out.append(KernelViolation(
                "grid-limit", site.name,
                detail=f"grid axis {a} has {g} blocks, over CUDA's {limit}"))
    if len(site.grid) > 3:
        out.append(KernelViolation(
            "grid-limit", site.name, detail=f"a CUDA grid has 3 axes, not {len(site.grid)}"))
    if not 0 < site.threads <= 1024:
        out.append(KernelViolation(
            "grid-limit", site.name,
            detail=f"{site.threads} threads a block; CUDA takes 1 to 1024"))


def _clipped_boxes(
    site: CallSite, programs: Sequence[Tuple[int, ...]], out: List[KernelViolation],
    max_per_operand: int = 3,
) -> List[List[Tuple[Tuple[int, ...], Box]]]:
    """Bounds of every operand at every block; returns, per output, the
    (block, box) pairs it writes, cut to the output (empty boxes dropped)."""
    writes: List[List[Tuple[Tuple[int, ...], Box]]] = []
    for role, blocks, shapes in (("in", site.in_blocks, site.in_shapes),
                                 ("out", site.out_blocks, site.out_shapes)):
        kind = "oob-read" if role == "in" else "oob-write"
        for i, (fp, shape) in enumerate(zip(blocks, shapes)):
            label = site.label(role, i)
            mine: List[Tuple[Tuple[int, ...], Box]] = []
            reported = 0
            for p in programs:
                try:
                    boxes = fp.clipped(p, shape)
                except Exception as e:  # the footprint crashed on this block
                    out.append(KernelViolation(kind, site.name, label, p,
                                               detail=f"footprint failed: {e}"))
                    reported += 1
                    if reported >= max_per_operand:
                        break
                    continue
                for box in boxes:
                    if box.volume == 0:
                        continue
                    if not box.within(shape):
                        if reported < max_per_operand:
                            how = ("masked on dims " + str(fp.masked)) if fp.masked else (
                                "through TMA" if fp.tma else "unmasked")
                            out.append(KernelViolation(
                                kind, site.name, label, p, box.offset,
                                detail=f"footprint {box.offset}+{box.size} outside operand "
                                       f"shape {shape} ({how})"))
                        reported += 1
                        box = box.clip(shape, range(len(shape)), lower=True)
                        if box.volume == 0:
                            continue
                    mine.append((p, box))
            if reported > max_per_operand:
                out.append(KernelViolation(
                    kind, site.name, label,
                    detail=f"… {reported - max_per_operand} more out of bounds"))
            if role == "out":
                writes.append(mine)
    return writes


def _check_exact_coverage(
    site: CallSite, writes: List[List[Tuple[Tuple[int, ...], Box]]],
    out: List[KernelViolation],
) -> None:
    """Every element of every output written by exactly one block: each
    output is cut at every box edge, and each cell of the cut grid must be
    covered once (sort-based: the cuts are the sorted box edges)."""
    for oi, (shape, mine) in enumerate(zip(site.out_shapes, writes)):
        label = site.label("out", oi)
        cuts = [np.unique(np.array([0, n] + [b.offset[d] for _, b in mine]
                                   + [b.end[d] for _, b in mine], dtype=np.int64))
                for d, n in enumerate(shape)]
        cells = 1
        for c in cuts:
            cells *= len(c) - 1
        if cells > MAX_CELLS:
            out.append(KernelViolation(
                "coverage-misaligned", site.name, label,
                detail=f"{cells} cells between the writes' edges; exact check refused"))
            continue
        index = [{int(v): i for i, v in enumerate(c)} for c in cuts]
        counts = np.zeros(tuple(len(c) - 1 for c in cuts), dtype=np.int32)
        slices = []
        for p, b in mine:
            sl = tuple(slice(index[d][o], index[d][e]) for d, (o, e) in
                       enumerate(zip(b.offset, b.end)))
            counts[sl] += 1
            slices.append(sl)
        if (counts > 1).any():
            first = tuple(int(i[0]) for i in np.nonzero(counts > 1))
            who = [p for (p, _), sl in zip(mine, slices)
                   if all(s.start <= f < s.stop for s, f in zip(sl, first))]
            at = tuple(int(cuts[d][i]) for d, i in enumerate(first))
            extra = int((counts[counts > 1] - 1).sum())
            out.append(KernelViolation(
                "write-race", site.name, label, program=who[0], box=at,
                detail=f"also written by block {who[1]}; {extra} cell(s) written more "
                       "than once: CUDA blocks run in no order"))
        widths = [np.diff(c) for c in cuts]
        volume = widths[0]
        for w in widths[1:]:
            volume = np.multiply.outer(volume, w)
        gap = int(np.asarray(volume)[counts == 0].sum())
        if gap:
            first = tuple(int(i[0]) for i in np.nonzero(counts == 0))
            at = tuple(int(cuts[d][i]) for d, i in enumerate(first))
            total = int(np.prod(shape, dtype=np.int64))
            out.append(KernelViolation(
                "coverage-gap", site.name, label, box=at,
                detail=f"{gap} of {total} elements never written; first at element {at}"))


def _check_smem(site: CallSite, budget: Optional[int], out: List[KernelViolation]) -> None:
    if budget is None:
        return
    total = site.smem + site.static_smem
    if total > budget:
        out.append(KernelViolation(
            "smem-budget", site.name,
            detail=f"{site.smem} B dynamic + {site.static_smem} B static shared memory a "
                   f"block, over the {budget} B a block may opt in to"))
    if site.smem_attr is not None and site.smem_attr != site.smem:
        out.append(KernelViolation(
            "smem-budget", site.name,
            detail=f"the launch passes {site.smem} B of dynamic shared memory but "
                   f"cudaFuncSetAttribute was given {site.smem_attr} B"))
    if site.smem_attr is None and site.smem > SMEM_DEFAULT_LIMIT:
        out.append(KernelViolation(
            "smem-budget", site.name,
            detail=f"{site.smem} B of dynamic shared memory without cudaFuncSetAttribute "
                   f"(a launch gets {SMEM_DEFAULT_LIMIT} B without it)"))
    if site.smem < site.smem_need:
        out.append(KernelViolation(
            "smem-budget", site.name,
            detail=f"the body carves {site.smem_need} B out of the {site.smem} B launched"))


def _check_body(site: CallSite, summary: KernelSummary, out: List[KernelViolation]) -> None:
    if not summary.parsed:
        return
    dtypes = dict(zip(site.in_names, site.in_dtypes))
    out_dtypes = dict(zip(site.out_names, site.out_dtypes))
    if summary.language == "triton":
        for i, name in enumerate(summary.in_params):
            if dtypes.get(name) in _SUB_FP32 and name in summary.raw_reads:
                out.append(KernelViolation(
                    "low-precision-read", site.name, site.label("in", i),
                    detail=f"{dtypes[name]} operand loaded without .to(tl.float32) at "
                           f"line(s) {summary.raw_reads[name]}: accumulation must be fp32"))
        for i, name in enumerate(summary.out_params):
            if out_dtypes.get(name) in _SUB_FP32 and name in summary.uncast_stores:
                out.append(KernelViolation(
                    "missing-store-cast", site.name, site.label("out", i),
                    detail=f"store to {out_dtypes[name]} output without "
                           f".to({name}.dtype.element_ty) at line(s) "
                           f"{summary.uncast_stores[name]}"))
    else:
        for name, lines in summary.uncast_stores.items():
            out.append(KernelViolation(
                "missing-store-cast", site.name, name,
                detail=f"store into output {name} without from_f32<T> or a bf16 conversion "
                       f"at line(s) {lines} of {site.source or summary.fn_name}"))
    for name in summary.params:
        uses = summary.uses.get(name, 0)
        if uses == 0:
            out.append(KernelViolation(
                "dead-param", site.name, name, detail="kernel parameter is never used"))
        elif summary.zero_uses.get(name, 0) >= uses:
            out.append(KernelViolation(
                "dead-param", site.name, name,
                detail="every use is multiplied by a literal 0 — the parameter has no effect"))


# ------------------------------------------------------------- entry points


def analyze_call_site(
    site: CallSite,
    *,
    summary: Optional[KernelSummary] = None,
    smem_budget: Optional[int] = DEFAULT_SMEM_BUDGET,
) -> KernelReport:
    """Run every rule over one call site.

    A Pallas grid (``site.route is None``) gets the reference's model
    checks; a CUDA or Triton launch the port's (all axes parallel, masked
    dims cut, exact coverage, shared memory, body rules).  ``summary``
    overrides the body extraction (mutation tests corrupt it); by default
    it comes from ``site.kernel``.
    """
    out: List[KernelViolation] = []
    if not _check_grid(site, out):
        return KernelReport(site.name, site.grid, 0, tuple(out), site.where)
    programs = list(itertools.product(*(range(g) for g in site.grid)))
    if site.route is None:
        offsets = _check_bounds(site, programs, out)
        _check_output_coverage(site, programs, offsets, out)
        _check_aliases(site, programs, out)
        return KernelReport(site.name, site.grid, len(programs), tuple(out), site.where)
    _check_launch_limits(site, out)
    writes = _clipped_boxes(site, programs, out)
    _check_exact_coverage(site, writes, out)
    _check_smem(site, smem_budget, out)
    if summary is None and site.kernel is not None:
        summary = summarize_kernel(site.kernel, in_params=site.in_names,
                                   out_params=site.out_names)
    if summary is not None:
        _check_body(site, summary, out)
    return KernelReport(site.name, site.grid, len(programs), tuple(out), site.where)


def analyze_callable(
    fn: Callable, *args: Any,
    smem_budget: Optional[int] = DEFAULT_SMEM_BUDGET,
    **kwargs: Any,
) -> List[KernelReport]:
    """Model ``fn(*args, **kwargs)``'s launches and analyze every one."""
    sites = capture_call_sites(fn, *args, **kwargs)
    return [analyze_call_site(s, smem_budget=smem_budget) for s in sites]


def assert_kernel_clean(fn: Callable, *args: Any, **kwargs: Any) -> List[KernelReport]:
    """Analyze and raise :class:`KernelLintError` on any violation."""
    reports = analyze_callable(fn, *args, **kwargs)
    bad = [r for r in reports if not r.ok]
    if bad:
        raise KernelLintError(bad)
    return reports


# ------------------------------------------- PCCL_VERIFY entry-point gating

_VERIFY_LOCK = threading.Lock()
_VERIFIED: "Dict[Any, bool]" = {}  # signature → clean (bounded)
_VERIFIED_MAX = 256
_GATE: "Dict[str, List[int]]" = {}  # label → [misses, hits]


def _describe(value: Any) -> Any:
    if hasattr(value, "shape") and hasattr(value, "dtype"):
        return (tuple(value.shape), dtype_name(value.dtype))
    return repr(value)


def _signature(label: str, args: Sequence[Any], kwargs: Dict[str, Any]) -> Any:
    shapes = tuple(_describe(a) for a in args)
    statics = tuple(sorted((k, _describe(v)) for k, v in kwargs.items()))
    return (label, shapes, statics)


def verify_entry_point(
    label: str, fn: Callable, args: Sequence[Any],
    kwargs: Optional[Dict[str, Any]] = None,
) -> None:
    """``PCCL_VERIFY=1`` hook of the kernel wrappers
    (:func:`repro_torch.kernels.build.verify_launch`).

    Models and analyzes the wrapper's launches once per (label — kernel
    and route —, shapes and dtypes, statics); repeats are an O(1) hit under
    the lock.  Raises :class:`KernelLintError` on any violation, before
    the wrapper launches anything.  Only shapes and dtypes are read.
    """
    kwargs = dict(kwargs or {})
    key = _signature(label, args, kwargs)
    with _VERIFY_LOCK:
        counts = _GATE.setdefault(label, [0, 0])
        if key in _VERIFIED:
            counts[1] += 1
            return
        counts[0] += 1
    reports = analyze_callable(fn, *args, **kwargs)
    bad = [r for r in reports if not r.ok]
    if bad:
        raise KernelLintError(bad)
    with _VERIFY_LOCK:
        if len(_VERIFIED) >= _VERIFIED_MAX:
            _VERIFIED.clear()
        _VERIFIED[key] = True


def clear_verified_cache() -> None:
    """Drop the entry-point verification memo and its counts (tests)."""
    with _VERIFY_LOCK:
        _VERIFIED.clear()
        _GATE.clear()


def gate_counts() -> Dict[str, Dict[str, int]]:
    """The gate's analyses (``misses``) and memo ``hits`` by label since the
    last :func:`clear_verified_cache`."""
    with _VERIFY_LOCK:
        return {label: {"misses": m, "hits": h} for label, (m, h) in _GATE.items()}


# ------------------------------------------------------- shipped kernel zoo

Case = Tuple[str, Callable, Tuple[Any, ...], Dict[str, Any]]


def _meta(torch, shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def shipped_kernel_cases() -> List[Case]:
    """(label, wrapper, meta-tensor args, kwargs) for every route of every
    kernel, at shapes that reach its edges: ragged tiles, a raster group
    shorter than ``GROUP_M``, head dims that are not powers of two, GQA,
    causal and not, a ragged last chunk, P-tiles and N-slices (fewer
    N-slices than ring stages), the recurrence's flat range crossing
    from one (b, h) to the next, and the round kernel's row moves in
    16-byte units with a ragged tile and one element a thread, by identity
    tables, by the sending rank's and slot's tables and by a receive-slot
    table.  The round kernel's cases are copies and stores: the card's NaN
    probe cannot read a reduce, which keeps the NaN it adds to.  The probe
    makes each table a permutation of its row's entries, so the tables
    stay in range and a receive-slot table writes every slot once."""
    import torch

    from repro_torch.kernels.flash.kernel import flash_attention_cuda
    from repro_torch.kernels.matmul.kernel import matmul_cuda
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_triton
    from repro_torch.kernels.rounds.kernel import stacked_round_cuda
    from repro_torch.kernels.ssd.kernel import ssd_cuda

    bf16, f32 = torch.bfloat16, torch.float32

    def m(*shape, dtype=f32):
        return _meta(torch, shape, dtype)

    cases: List[Case] = [
        # 19 row tiles: a raster group of 16, then one of 3; ragged M and N
        ("matmul wgmma ragged, short raster group", matmul_cuda,
         (m(2348, 200, dtype=bf16), m(200, 520, dtype=bf16)), {}),
        ("matmul fma ragged", matmul_cuda, (m(300, 130), m(130, 200)), {}),
        ("matmul fma bf16 off the tensor cores", matmul_cuda,
         (m(100, 36, dtype=bf16), m(36, 90, dtype=bf16)), {}),
        ("rmsnorm d=100 not a power of two", rmsnorm_triton,
         (m(3, 5, 100, dtype=bf16), m(100)), {"eps": 1e-5}),
    ]
    for D in (64, 80, 128):
        cases.append((f"flash wgmma D={D} gqa 2:1 causal ragged S", flash_attention_cuda,
                      (m(2, 300, 4, D, dtype=bf16), m(2, 300, 2, D, dtype=bf16),
                       m(2, 300, 2, D, dtype=bf16)), {"causal": True}))
    cases += [
        ("flash wgmma D=80 non-causal T != S", flash_attention_cuda,
         (m(1, 200, 4, 80, dtype=bf16), m(1, 333, 2, 80, dtype=bf16),
          m(1, 333, 2, 80, dtype=bf16)), {"causal": False}),
        ("flash fma D=48 gqa causal ragged S", flash_attention_cuda,
         (m(2, 150, 4, 48), m(2, 150, 2, 48), m(2, 150, 2, 48)), {"causal": True}),
        ("flash fma D=80 non-causal", flash_attention_cuda,
         (m(1, 100, 2, 80), m(1, 70, 1, 80), m(1, 70, 1, 80)), {"causal": False}),
        ("ssd wgmma P=N=chunk=64 ragged last chunk, shared B/C", ssd_cuda,
         (m(2, 200, 3, 64, dtype=bf16), m(2, 200, 3), m(2, 200, 64, dtype=bf16),
          m(2, 200, 64, dtype=bf16)), {"chunk": 64, "initial_state": m(2, 3, 64, 64)}),
        ("ssd wgmma per-head B/C", ssd_cuda,
         (m(1, 130, 2, 64, dtype=bf16), m(1, 130, 2), m(1, 130, 2, 64, dtype=bf16),
          m(1, 130, 2, 64, dtype=bf16)), {"chunk": 64}),
        ("ssd wgmma_tiled P=N=128 ragged last chunk, shared B/C", ssd_cuda,
         (m(1, 300, 2, 128, dtype=bf16), m(1, 300, 2), m(1, 300, 128, dtype=bf16),
          m(1, 300, 128, dtype=bf16)), {"chunk": 64, "initial_state": m(1, 2, 128, 128)}),
        ("ssd wgmma_tiled P=64 N=192 per-head B/C: fewer N-slices than ring stages", ssd_cuda,
         (m(2, 130, 3, 64, dtype=bf16), m(2, 130, 3), m(2, 130, 3, 192, dtype=bf16),
          m(2, 130, 3, 192, dtype=bf16)), {"chunk": 64}),
        ("ssd wgmma_tiled mLSTM widths P=1024 N=512, per-head B/C, ragged S", ssd_cuda,
         (m(1, 1000, 4, 1024, dtype=bf16), m(1, 1000, 4), m(1, 1000, 4, 512, dtype=bf16),
          m(1, 1000, 4, 512, dtype=bf16)), {"chunk": 64, "initial_state": m(1, 4, 1024, 512)}),
        ("ssd fma P=16 N=8, the recurrence crossing (b, h)", ssd_cuda,
         (m(2, 100, 3, 16), m(2, 100, 3), m(2, 100, 8), m(2, 100, 8)), {"chunk": 32}),
        ("ssd fma P=24 N=10, the recurrence's rows unaligned", ssd_cuda,
         (m(1, 90, 5, 24), m(1, 90, 5), m(1, 90, 5, 10), m(1, 90, 5, 10)),
         {"chunk": 32, "initial_state": m(1, 5, 24, 10)}),
        ("ssd fma P=130 N=70 chunk 48: P-tiles, N-slices, per head", ssd_cuda,
         (m(1, 100, 2, 130, dtype=bf16), m(1, 100, 2), m(1, 100, 2, 70, dtype=bf16),
          m(1, 100, 2, 70, dtype=bf16)), {"chunk": 48}),
        ("ssd fma P=64 shared B/C: four heads a tile, the last tile past H, ragged S", ssd_cuda,
         (m(1, 150, 5, 64), m(1, 150, 5), m(1, 150, 40), m(1, 150, 40)), {"chunk": 64}),
        ("ssd fma P=128 chunk 128: two heads a tile, two step tiles a chunk", ssd_cuda,
         (m(1, 300, 3, 128), m(1, 300, 3), m(1, 300, 72), m(1, 300, 72)),
         {"chunk": 128, "initial_state": m(1, 3, 128, 72)}),
        ("ssd fma P=300 per head: two column tiles a head", ssd_cuda,
         (m(1, 100, 2, 300), m(1, 100, 2), m(1, 100, 2, 70), m(1, 100, 2, 70)), {"chunk": 48}),
        # rows of 16-byte units: 1500 units, a whole tile of 1024 and a ragged one
        ("round copy bf16 16-byte units, ragged last tile", stacked_round_cuda,
         (m(2, 8, 12000, dtype=bf16), None, None, None, 2, 8), {}),
        ("round copy bf16 rows of 3 elements, one element a thread", stacked_round_cuda,
         (m(8, 4, 3, dtype=bf16), None, None, None, 8, 4), {}),
        # a staged round's gather: the sending rank's and slot's tables
        ("round gather fp16 rows of 13 elements by rank and slot tables", stacked_round_cuda,
         (m(8, 3, 13, dtype=torch.float16), m(8, dtype=torch.int64), m(8, 3, dtype=torch.int64),
          None, 8, 3), {}),
        # a staged round's store: the receive slots' table, 16-byte units, a ragged tile
        ("round store fp32 rows by a receive-slot table", stacked_round_cuda,
         (m(8, 2, 2052), None, None, m(8, 2, dtype=torch.int64), 8, 2), {}),
    ]
    return cases


def main_path_cases() -> List[Case]:
    """The kernels at the shapes the main paths give them (``PERF.md`` §6):
    K1 at the fused mm+RS step of Mistral-Large-123B TP=8, K2 at its
    all-reduced activation, K3 at Zamba2's, OLMoE's and Whisper's prefill
    and Whisper's train microbatch (and on its fp32 route at Zamba2's and
    OLMoE's, the parity prefills), K4 at Zamba2's prefill and the mLSTM's
    (and on its fp32 route at Zamba2's widths, batch 1), and the round
    kernel at the layer cell's all-reduce rounds and the bucket mix's staged
    all-to-all round."""
    import torch

    from repro_torch.kernels.flash.kernel import flash_attention_cuda
    from repro_torch.kernels.matmul.kernel import matmul_cuda
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_triton
    from repro_torch.kernels.rounds.kernel import stacked_round_cuda
    from repro_torch.kernels.ssd.kernel import ssd_cuda

    bf16, f32 = torch.bfloat16, torch.float32

    def m(*shape, dtype=bf16):
        return _meta(torch, shape, dtype)

    def i64(*shape):
        return m(*shape, dtype=torch.int64)

    def attention(B, S, H, K, D, dtype=bf16):
        return (m(B, S, H, D, dtype=dtype), m(B, S, K, D, dtype=dtype), m(B, S, K, D, dtype=dtype))

    return [
        ("main matmul (32768x3584)@(3584x12288) bf16", matmul_cuda,
         (m(32768, 3584), m(3584, 12288)), {}),
        ("main matmul (32768x3584)@(3584x12288) fp32", matmul_cuda,
         (m(32768, 3584, dtype=f32), m(3584, 12288, dtype=f32)), {}),
        ("main rmsnorm (32768, 12288) bf16", rmsnorm_triton,
         (m(32768, 12288), m(12288, dtype=f32)), {"eps": 1e-5}),
        ("main flash Zamba2 (4, 4096, 32, 80)", flash_attention_cuda,
         attention(4, 4096, 32, 32, 80), {"causal": True}),
        ("main flash OLMoE (4, 4096, 16, 128)", flash_attention_cuda,
         attention(4, 4096, 16, 16, 128), {"causal": True}),
        ("main flash Whisper prefill (4, 228, 12, 64)", flash_attention_cuda,
         attention(4, 228, 12, 12, 64), {"causal": True}),
        ("main flash Whisper train (4, 448, 12, 64)", flash_attention_cuda,
         attention(4, 448, 12, 12, 64), {"causal": True}),
        ("main flash Zamba2 (4, 4096, 32, 80) fp32", flash_attention_cuda,
         attention(4, 4096, 32, 32, 80, f32), {"causal": True}),
        ("main flash OLMoE (4, 4096, 16, 128) fp32", flash_attention_cuda,
         attention(4, 4096, 16, 16, 128, f32), {"causal": True}),
        ("main ssd Zamba2 X (4, 4096, 80, 64)", ssd_cuda,
         (m(4, 4096, 80, 64), m(4, 4096, 80, dtype=f32), m(4, 4096, 64), m(4, 4096, 64)),
         {"chunk": 64, "initial_state": m(4, 80, 64, 64, dtype=f32)}),
        ("main ssd mLSTM X (4, 4096, 4, 1024) N=512", ssd_cuda,
         (m(4, 4096, 4, 1024), m(4, 4096, 4, dtype=f32), m(4, 4096, 4, 512),
          m(4, 4096, 4, 512)), {"chunk": 64, "initial_state": m(4, 4, 1024, 512, dtype=f32)}),
        # the fp32 route at Zamba2's prefill widths, batch cut to 1: the same plan (20 tiles a
        # chunk of 4 heads side by side, 4 tiles a block) at a quarter of the programs
        ("main ssd Zamba2 X (1, 4096, 80, 64) fp32", ssd_cuda,
         (m(1, 4096, 80, 64, dtype=f32), m(1, 4096, 80, dtype=f32), m(1, 4096, 64, dtype=f32),
          m(1, 4096, 64, dtype=f32)), {"chunk": 64, "initial_state": m(1, 80, 64, 64, dtype=f32)}),
        # the layer cell's all-reduce of (8, 4096, 12288): 8 chunks a rank of 6,291,456
        # elements, bucket2d's reduce round of 4 chunks a rank and a store round of one
        ("main round reduce bf16 (8 x 4 pairs of 6291456)", stacked_round_cuda,
         (m(8, 8, 6291456), i64(8), i64(8, 4), i64(8, 4), 8, 4),
         {"out": m(8, 8, 6291456), "reduce": True}),
        ("main round store bf16 (8 x 1 pairs of 6291456)", stacked_round_cuda,
         (m(8, 8, 6291456), i64(8), i64(8, 1), i64(8, 1), 8, 1),
         {"out": m(8, 8, 6291456), "reduce": False}),
        # the bucket mix's 16 MiB all-to-all (dex, staged): the gather into scratch, the store
        ("main round staged gather bf16 (8 x 4 pairs of 1048576)", stacked_round_cuda,
         (m(8, 8, 1048576), i64(8), i64(8, 4), None, 8, 4),
         {"out": m(8, 4, 1048576), "reduce": False}),
        ("main round staged store bf16 (8 x 4 pairs of 1048576)", stacked_round_cuda,
         (m(8, 4, 1048576), None, None, i64(8, 4), 8, 4),
         {"out": m(8, 8, 1048576), "reduce": False}),
        ("main round reduce fp32 (8 x 1 pairs of 131072)", stacked_round_cuda,
         (m(8, 8, 131072, dtype=f32), i64(8), i64(8, 1), i64(8, 1), 8, 1),
         {"out": m(8, 8, 131072, dtype=f32), "reduce": True}),
    ]


def run_shipped(verbose: bool = True) -> int:
    """Analyze every shipped case and main-path shape; print one line per
    case.  ``python -m repro_torch.analysis --kernels`` runs this; returns
    the number of failing cases."""
    failures = 0
    for label, fn, args, kwargs in shipped_kernel_cases() + main_path_cases():
        try:
            reports = analyze_callable(fn, *args, **kwargs)
        except CaptureError as e:
            print(f"[kernels] {label}: CAPTURE FAILED: {e}")
            failures += 1
            continue
        bad = [r for r in reports if not r.ok]
        if bad:
            failures += 1
            if verbose:
                for r in bad:
                    print(f"[kernels] {label}: {r}")
        elif verbose:
            checked = sum(r.programs_checked for r in reports)
            print(f"[kernels] {label}: clean "
                  f"({len(reports)} call site(s), {checked} programs)")
    return failures
