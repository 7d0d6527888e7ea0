"""AST-based concurrency lint for the repro_torch tree (a copy of
``repro.analysis.lint_concurrency``, with the port's own shared state
registered beside the reference's).

The repo's planner/executor stack keeps process-wide shared state — the
shortest-path / linear-topology / edge-load caches in ``core/cost_model.py``,
the transition cache in ``core/planner.py``, the exec-engine LRUs and trace
counter in ``comm/exec_engine.py``, and the per-session plan/structure caches
in ``api/session.py`` — all of which must be mutated under their owning lock
(sessions and the executor are explicitly documented as thread-safe).  PRs
2–4 fixed several bugs of exactly three shapes; this pass flags them
statically:

* **UG01 unguarded-global-mutation** — a module-level mutable (or a name in
  the shared-cache registry below) is mutated without holding the lock that
  guards it elsewhere in the module.  The owning lock is *inferred*: if any
  mutation of ``G`` happens inside ``with L:``, every mutation of ``G`` must
  hold one of ``G``'s observed locks.  Registry names must always be
  guarded, even if the module never locks them.
* **CG01 unguarded-attr-mutation** — same discipline for instance state: in
  a class that owns a lock attribute (``self._lock = threading.Lock()``),
  any mutation of a shared attribute (one mutated under the lock somewhere,
  or a mutable container assigned in ``__init__``) outside a
  ``with self.<lock>:`` block and outside ``__init__``.
* **FA01 function-attribute-state** — state stashed on a function object
  (``fn.cache = …``): invisible to locks, shared across threads, and the
  bug class behind the PR-2 ``last_objs`` fix.
* **MD01 mutable-default** — mutable default argument values.

Objects that lock internally (``StructureTable``, the exec-engine
``_LruCache`` instances, ``PlanCache``) are safe to *call* from anywhere;
only rebinding those module globals is a mutation.  A finding can be
suppressed by putting ``# lint-ok`` on the offending line (used sparingly,
with a reason in a comment).

Run as ``python -m repro_torch.analysis.lint_concurrency [paths…]`` (the
paths default to ``src/repro_torch``) — prints findings and exits non-zero
if any.
"""

from __future__ import annotations

import ast
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: Module-level names that are always shared across threads and must only be
#: mutated under a lock, regardless of what this one module's AST shows.
SHARED_CACHE_REGISTRY = {
    "_SP_CACHE",          # core/cost_model: shortest-path factor cache
    "_LINEAR_CACHE",      # core/cost_model: linear-topology label cache
    "_EDGE_LOAD_CACHE",   # core/cost_model: per-edge load cache
    "_TRANS_CACHE",       # core/planner: transition-cost table cache
    "_TRACES",            # comm/exec_engine: retrace counter
    # the port's own: comm/exec_engine's fusion dispatch counters (all under
    # _OVERLAP_LOCK), kernels/build's loaded-library cache (under _LOCK)
    "_FUSED_DISPATCHES",
    "_FALLBACK_DISPATCHES",
    "_CHUNKS_STREAMED",
    "_BYTES_HIDDEN",
    "_LOADED",
}

#: Module-level singletons that serialize internally; calling their methods
#: needs no external lock, but *rebinding* them is still a mutation.
INTERNALLY_LOCKED = {
    "STRUCTURE_TABLE", "_COMPILED", "EXECUTABLES",
    # the port's own: comm/exec_engine's device-table LRU, and the kernels'
    # launch counts (kernels/build.py's LaunchCounts)
    "_DEVICE_TABLES", "LAUNCHES",
}

_MUTATOR_METHODS = {
    "append", "appendleft", "add", "clear", "discard", "extend", "insert",
    "move_to_end", "pop", "popitem", "popleft", "remove", "setdefault",
    "sort", "update",
}
_MUTABLE_FACTORIES = {
    "dict", "list", "set", "OrderedDict", "defaultdict", "Counter", "deque",
}
_LOCK_FACTORIES = {"Lock", "RLock"}


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    name: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} [{self.name}] {self.message}"


@dataclass(frozen=True)
class _Mutation:
    name: str
    line: int
    locks: Tuple[str, ...]  # canonical lock tokens held at the site
    func: str               # enclosing function / method name


def _call_name(node: ast.expr) -> Optional[str]:
    """Trailing name of a call target: ``threading.Lock`` → ``Lock``."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _is_lock_factory(value: ast.expr) -> bool:
    return (isinstance(value, ast.Call)
            and _call_name(value.func) in _LOCK_FACTORIES)


def _is_mutable_literal(value: ast.expr) -> bool:
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                          ast.ListComp, ast.SetComp)):
        return True
    return (isinstance(value, ast.Call)
            and _call_name(value.func) in _MUTABLE_FACTORIES)


def _lock_token(expr: ast.expr) -> Optional[str]:
    """Canonical token for a ``with`` context manager that is a lock-ish
    name: ``Name`` → that name, ``self.X`` → ``self.X``.  ``None`` for
    anything else (contextlib helpers, file handles, …)."""
    if isinstance(expr, ast.Name):
        return expr.id
    if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"):
        return f"self.{expr.attr}"
    return None


def _mutation_target(node: ast.expr) -> Optional[Tuple[str, str]]:
    """Classify the container a store/del/mutator-call touches.

    Returns ``(kind, name)`` with kind ``global`` (module-level name),
    ``attr`` (``self.<name>``), or ``None`` when the base is a local/other
    expression.  ``module.NAME`` counts as a global mutation of ``NAME`` so
    cross-module pokes at registry caches are caught too.
    """
    # peel subscripts: G[k], self.a[k], G[k][j]…
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Name):
        return ("global", node.id)
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        if node.value.id == "self":
            return ("attr", node.attr)
        return ("global", node.attr)  # module.NAME
    return None


class _FunctionScanner(ast.NodeVisitor):
    """Collects mutation events inside one function body, tracking the
    stack of held locks across ``with`` blocks."""

    def __init__(self, func_name: str, module_funcs: Set[str]):
        self.func_name = func_name
        self.module_funcs = module_funcs
        self.locks: List[str] = []
        self.globals_declared: Set[str] = set()
        self.mutations: List[_Mutation] = []  # global-kind events
        self.attr_mutations: List[_Mutation] = []  # self.<attr> events
        self.func_attr_stores: List[Tuple[str, int]] = []
        self.lock_attr_defs: Set[str] = set()  # self.X = threading.Lock()
        self.mutable_attr_defs: Set[str] = set()  # self.X = {} / [] / dict()…
        self.attr_rebinds: List[_Mutation] = []

    # ---- helpers

    def _held(self) -> Tuple[str, ...]:
        return tuple(self.locks)

    def _record_target(self, tgt: ast.expr, line: int, *, is_rebind: bool) -> None:
        cls = _mutation_target(tgt)
        if cls is None:
            return
        kind, name = cls
        if kind == "global":
            if isinstance(tgt, ast.Name):
                # plain `G = …` only mutates shared state when declared global
                if is_rebind and name not in self.globals_declared:
                    return
            if (isinstance(tgt, ast.Attribute)
                    and name not in SHARED_CACHE_REGISTRY
                    and name not in INTERNALLY_LOCKED):
                # f.attr = … — function-attribute state when f is a function
                if isinstance(tgt.value, ast.Name) and tgt.value.id in self.module_funcs:
                    self.func_attr_stores.append((tgt.value.id, line))
                return
            self.mutations.append(
                _Mutation(name, line, self._held(), self.func_name))
        else:
            if is_rebind and isinstance(tgt, ast.Attribute):
                self.attr_rebinds.append(
                    _Mutation(name, line, self._held(), self.func_name))
            else:
                self.attr_mutations.append(
                    _Mutation(name, line, self._held(), self.func_name))

    # ---- visitors

    def visit_Global(self, node: ast.Global) -> None:
        self.globals_declared.update(node.names)

    def visit_With(self, node: ast.With) -> None:
        tokens = [t for item in node.items
                  if (t := _lock_token(item.context_expr)) is not None]
        self.locks.extend(tokens)
        for item in node.items:
            self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        del self.locks[len(self.locks) - len(tokens):]

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._record_target(tgt, node.lineno,
                                is_rebind=not isinstance(tgt, ast.Subscript))
            # remember lock / mutable-container attribute definitions
            if (isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                if _is_lock_factory(node.value):
                    self.lock_attr_defs.add(tgt.attr)
                elif _is_mutable_literal(node.value):
                    self.mutable_attr_defs.add(tgt.attr)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_target(node.target, node.lineno,
                            is_rebind=isinstance(node.target, ast.Name))
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record_target(node.target, node.lineno,
                                is_rebind=not isinstance(node.target, ast.Subscript))
            tgt = node.target
            if (isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                if _is_lock_factory(node.value):
                    self.lock_attr_defs.add(tgt.attr)
                elif _is_mutable_literal(node.value):
                    self.mutable_attr_defs.add(tgt.attr)
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript):
                self._record_target(tgt, node.lineno, is_rebind=False)

    def visit_Call(self, node: ast.Call) -> None:
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATOR_METHODS):
            base = node.func.value
            cls = _mutation_target(base)
            if cls is not None:
                kind, name = cls
                if kind == "global" and not isinstance(base, ast.Name):
                    # module.NAME.mutate(…): only registry names are shared
                    if name not in SHARED_CACHE_REGISTRY:
                        cls = None
                if cls is not None and name not in INTERNALLY_LOCKED:
                    m = _Mutation(name, node.lineno, self._held(), self.func_name)
                    (self.mutations if kind == "global"
                     else self.attr_mutations).append(m)
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested defs execute later, possibly without the current locks —
        # scan them with an empty lock stack
        inner = _FunctionScanner(f"{self.func_name}.{node.name}", self.module_funcs)
        for stmt in node.body:
            inner.visit(stmt)
        inner.globals_declared |= self.globals_declared
        self.mutations.extend(inner.mutations)
        self.attr_mutations.extend(inner.attr_mutations)
        self.attr_rebinds.extend(inner.attr_rebinds)
        self.func_attr_stores.extend(inner.func_attr_stores)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]


def _check_defaults(fn: ast.FunctionDef, path: str, out: List[Finding]) -> None:
    args = fn.args
    for default in list(args.defaults) + [d for d in args.kw_defaults if d]:
        if _is_mutable_literal(default):
            out.append(Finding(
                path, default.lineno, "MD01", fn.name,
                "mutable default argument is shared across calls"))


def lint_module(path: str, source: Optional[str] = None) -> List[Finding]:
    """Run all rules over one module; returns unsuppressed findings."""
    if source is None:
        source = Path(path).read_text()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, "PARSE", "-", str(e))]
    lines = source.splitlines()

    module_funcs: Set[str] = set()
    module_locks: Set[str] = set()
    module_mutables: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            module_funcs.add(stmt.name)
        elif isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
            value = stmt.value
            if value is None:
                continue
            for tgt in targets:
                if not isinstance(tgt, ast.Name):
                    continue
                if _is_lock_factory(value):
                    module_locks.add(tgt.id)
                elif _is_mutable_literal(value):
                    module_mutables.add(tgt.id)

    out: List[Finding] = []
    global_events: List[_Mutation] = []

    def scan_function(fn: ast.FunctionDef, qual: str) -> _FunctionScanner:
        _check_defaults(fn, path, out)
        sc = _FunctionScanner(qual, module_funcs)
        for stmt in fn.body:
            sc.visit(stmt)
        for fname, line in sc.func_attr_stores:
            out.append(Finding(
                path, line, "FA01", fname,
                "state stored on a function object is unsynchronized "
                "process-global state"))
        global_events.extend(sc.mutations)
        return sc

    # ---- module functions and classes
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan_function(stmt, stmt.name)
        elif isinstance(stmt, ast.ClassDef):
            methods = [s for s in stmt.body
                       if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))]
            scanners = [(m.name, scan_function(m, f"{stmt.name}.{m.name}"))
                        for m in methods]
            lock_attrs = set().union(*(sc.lock_attr_defs for _, sc in scanners)) \
                if scanners else set()
            if not lock_attrs:
                continue
            lock_tokens = {f"self.{a}" for a in lock_attrs}
            shared: Set[str] = set()
            guarded_by: Dict[str, Set[str]] = {}
            events: List[Tuple[str, _Mutation]] = []
            for mname, sc in scanners:
                for ev in sc.attr_mutations + sc.attr_rebinds:
                    if ev.name in lock_attrs:
                        continue
                    events.append((mname, ev))
                    held = set(ev.locks) & lock_tokens
                    if held:
                        shared.add(ev.name)
                        guarded_by.setdefault(ev.name, set()).update(held)
                if mname == "__init__":
                    shared |= sc.mutable_attr_defs
            for mname, ev in events:
                if mname == "__init__" or ev.name not in shared:
                    continue
                owners = guarded_by.get(ev.name, lock_tokens)
                if not set(ev.locks) & owners:
                    out.append(Finding(
                        path, ev.line, "CG01", f"self.{ev.name}",
                        f"mutated in {ev.func} without holding "
                        f"{' / '.join(sorted(owners))}"))

    # ---- UG01: module-global lock discipline
    interesting = module_mutables | SHARED_CACHE_REGISTRY | INTERNALLY_LOCKED
    guarded: Dict[str, Set[str]] = {}
    for ev in global_events:
        if ev.name in interesting and set(ev.locks) & module_locks:
            guarded.setdefault(ev.name, set()).update(set(ev.locks) & module_locks)
    for ev in global_events:
        if ev.name not in interesting:
            continue
        must_guard = (ev.name in SHARED_CACHE_REGISTRY
                      or ev.name in INTERNALLY_LOCKED
                      or ev.name in guarded)
        if not must_guard:
            continue  # module never locks this name: no intent to infer from
        owners = guarded.get(ev.name, module_locks)
        if not set(ev.locks) & owners:
            hint = " / ".join(sorted(owners)) if owners else "a lock"
            out.append(Finding(
                path, ev.line, "UG01", ev.name,
                f"mutated in {ev.func} without holding {hint}"))

    # ---- suppression
    def suppressed(f: Finding) -> bool:
        return 0 < f.line <= len(lines) and "# lint-ok" in lines[f.line - 1]

    return sorted((f for f in out if not suppressed(f)),
                  key=lambda f: (f.path, f.line, f.rule))


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []
    for p in paths:
        path = Path(p)
        files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
        for f in files:
            findings.extend(lint_module(str(f)))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    paths = args or ["src/repro_torch"]
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    print(f"concurrency lint: {len(findings)} finding(s) in "
          f"{', '.join(paths)}")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
