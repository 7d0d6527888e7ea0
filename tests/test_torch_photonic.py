"""The port's photonic layer, plan invariants and concurrency lint against
the JAX package's, on the CPU.

* Alg. 3 (``core/circuits.py``): ``route_circuits`` / ``validate_routes`` on
  ``random_requests`` from fixed seeds, the cases of
  ``tests/test_circuits_fibers.py`` and Fig. 19a's 256 × 256 mesh.
* Alg. 4 (``core/fibers.py``): ``route_fibers`` on ``random_demands``
  (Fig. 19b's 64-server grid with 100 and 512 circuits), and
  ``route_fibers_milp`` (the same ``scipy.optimize.milp`` model: equal
  objective, and equal routes where both report success).
* Every ``check_*`` of ``analysis/invariants.py`` on planner output and on
  the corrupted plans of ``tests/test_analysis_invariants.py`` and
  ``tests/test_hierarchical_planner.py``.
* The lint on the snippets of ``tests/test_lint_concurrency.py``, and on
  ``src/repro_torch`` itself: 0 findings.

Everything is compared exactly (routes, loads, failures, objectives,
violation strings, findings) but the routers' own timings, which are
wall-clock and not compared.
"""

import importlib
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import lint_concurrency as ref_lint
from repro.core import circuits as ref_CC
from repro.core import fibers as ref_F
from repro.core import topology as ref_T
from repro_torch.analysis import lint_concurrency as lint
from repro_torch.core import circuits as CC
from repro_torch.core import fibers as F
from repro_torch.core import topology as T

ROOT = Path(__file__).resolve().parents[1]
D = float(1 << 20)


def _package(root):
    """One package's modules that this file drives, by role."""
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(CC=mod("core.circuits"), F=mod("core.fibers"), T=mod("core.topology"),
                           S=mod("core.schedules"), P=mod("core.planner"),
                           cm=mod("core.cost_model"), pccl=mod("core.pccl"),
                           inv=mod("analysis.invariants"))


PORT, REF = _package("repro_torch"), _package("repro")


# ------------------------------------------------------------- Algorithm 3


def _circuits(pkg, rows, cols, reqs, **kw):
    """Route ``reqs`` (a list of (src, dst, λ), or ``(k, λs, seed)`` for
    ``random_requests``) on a rows × cols mesh; validate; return what is
    compared."""
    CCm = pkg.CC
    mesh = CCm.MZIMesh(rows, cols)
    if isinstance(reqs, tuple):
        k, lams, seed = reqs
        requests = CCm.random_requests(mesh, k, n_wavelengths=lams, seed=seed)
    else:
        requests = [CCm.CircuitRequest(*r) for r in reqs]
    res = CCm.route_circuits(mesh, requests, **kw)
    CCm.validate_routes(mesh, res, requests, max_overlap=kw.get("max_overlap", 0))
    return {
        "mesh": (mesh.n_nodes, mesh.n_edges, mesh.edge_id(0, 1), mesh.edge_id(1, 0)),
        "requests": [(r.src, r.dst, r.wavelength) for r in requests],
        "routes": res.routes,
        "edge_counts": {lam: c.tolist() for lam, c in res.edge_counts.items()},
        "failed": res.failed,
        "max_edge_load": res.max_edge_load,
    }


CIRCUIT_CASES = {
    "mesh 4x4": (4, 4, [], {}),
    "two disjoint 8x8": (8, 8, [(0, 63), (7, 56)], {}),
    "same lambda 8x8": (8, 8, (10, 1, 1), {}),
    "oversubscribed 1 lambda": (8, 8, (48, 1, 1), {}),
    "oversubscribed 4 lambdas": (8, 8, (48, 4, 1), {}),
    "lambdas independent": (4, 4, [(0, 15, 0), (0, 15, 1)], {}),
    "conflicting 2x2": (2, 2, [(0, 3), (0, 3)], {}),
    "seed 3, 16x16": (16, 16, (40, 2, 3), {}),
    "seed 5, overlap 1": (8, 8, (30, 1, 5), {"max_overlap": 1}),
    "no rip-up": (8, 8, (48, 1, 1), {"rip_up": False}),
    "fig19a 256x256": (256, 256, (16, 4, 0), {}),
}


@pytest.mark.parametrize("case", sorted(CIRCUIT_CASES))
def test_route_circuits_as_the_reference(case):
    rows, cols, reqs, kw = CIRCUIT_CASES[case]
    got = _circuits(PORT, rows, cols, reqs, **kw)
    assert got == _circuits(REF, rows, cols, reqs, **kw)
    if case in ("two disjoint 8x8", "same lambda 8x8", "lambdas independent",
                "conflicting 2x2", "fig19a 256x256"):
        assert not got["failed"]


def test_wdm_relieves_contention_as_in_the_reference():
    one = _circuits(PORT, 8, 8, (48, 1, 1))
    four = _circuits(PORT, 8, 8, (48, 4, 1))
    assert len(four["failed"]) < len(one["failed"])


def test_validate_routes_rejects_a_shared_waveguide_in_both():
    for CCm in (CC, ref_CC):
        mesh = CCm.MZIMesh(2, 2)
        reqs = [CCm.CircuitRequest(0, 3), CCm.CircuitRequest(0, 3)]
        res = CCm.route_circuits(mesh, reqs)
        res.routes[1] = list(res.routes[0])
        with pytest.raises(AssertionError, match="overlapping circuits"):
            CCm.validate_routes(mesh, res, reqs)


# ------------------------------------------------------------- Algorithm 4


def _fibers(routing):
    return routing.routes, routing.edge_load, routing.z


FIBER_CASES = {
    "grid 2x2": (lambda Fm, Tm: Tm.grid2d(2, 2), [(0, 3), (3, 0)], None),
    "grid 3x3 seed 3": (lambda Fm, Tm: Tm.grid2d(3, 3), (8, 3), None),
    "existing load": (lambda Fm, Tm: Tm.grid2d(2, 2), [(0, 3)], {(0, 1): 3}),
    "fig19b 64 servers, 100": (lambda Fm, Tm: Fm.server_grid(64), (100, 0), None),
    "fig19b 64 servers, 512": (lambda Fm, Tm: Fm.server_grid(64), (512, 0), None),
    "16 servers seed 7": (lambda Fm, Tm: Fm.server_grid(16), (40, 7), None),
}


def _demands(Fm, topo, demands):
    if isinstance(demands, tuple):
        k, seed = demands
        return Fm.random_demands(topo, k, seed=seed)
    return demands


@pytest.mark.parametrize("case", sorted(FIBER_CASES))
def test_route_fibers_as_the_reference(case):
    make, demands, existing = FIBER_CASES[case]
    out = []
    for Fm, Tm in ((F, T), (ref_F, ref_T)):
        topo = make(Fm, Tm)
        dem = _demands(Fm, topo, demands)
        routing = Fm.route_fibers(topo, dem, existing=existing)
        for path, (s, d) in zip(routing.routes, dem):
            assert path[0] == s and path[-1] == d
        out.append((dem, _fibers(routing)))
    assert out[0] == out[1]
    if case.startswith("fig19b"):  # §4.2: 7 and 31 fibers for 100 and 512 circuits
        assert out[0][1][2] <= (7 if case.endswith("100") else 31)


@pytest.mark.parametrize("case", ["grid 2x2", "grid 3x3 seed 3", "existing load"])
def test_route_fibers_milp_as_the_reference(case):
    make, demands, existing = FIBER_CASES[case]
    got, want = [], []
    for Fm, Tm, out in ((F, T, got), (ref_F, ref_T, want)):
        topo = make(Fm, Tm)
        out.append(Fm.route_fibers_milp(topo, _demands(Fm, topo, demands), existing=existing))
    (r,), (ref_r,) = got, want
    assert r.z == ref_r.z  # the objective
    assert (r.routes, r.edge_load) == (ref_r.routes, ref_r.edge_load)
    if case == "existing load":
        assert r.routes == [[0, 2, 3]] and r.z == 3
    heur = F.route_fibers(make(F, T), _demands(F, make(F, T), demands), existing=existing)
    assert heur.z >= r.z


def _joint_round_allocations(pkg, n, tp, dp):
    """tests/test_circuits_fibers.py's helper, for either package: per-round
    per-group circuit sets of a TP × DP mesh running all-reduce rows and
    reduce-scatter columns concurrently, and the concurrent plan."""
    Tm, Sm, Pm, cmm = pkg.T, pkg.S, pkg.P, pkg.cm
    tp_groups, dp_groups = Sm.mesh_groups(tp, dp)
    MB = 1024.0 ** 2
    scheds = [Sm.replicate_groups(Sm.get_schedule("all_reduce", "ring", tp, 64 * MB), tp_groups, n),
              Sm.replicate_groups(Sm.get_schedule("reduce_scatter", "ring", dp, 64 * MB),
                                  dp_groups, n)]
    g0 = Tm.ring(n)
    std = pkg.pccl.default_standard_set(n)
    cp = Pm.plan_concurrent(g0, std, scheds, cmm.H100_DGX)
    structs = [Pm.build_structure(g0, std, sch, cmm.H100_DGX) for sch in scheds]
    rounds = [[sorted(structs[g].states[grp.states[i]].topo.edges)
               for g, grp in enumerate(cp.groups)] for i in range(cp.n_rounds)]
    return rounds, cp


@pytest.mark.parametrize("n,tp,dp", [(4, 2, 2), (8, 2, 4), (16, 4, 4)])
def test_concurrent_allocations_route_as_the_reference(n, tp, dp):
    """Each joint round's union circuit set through Alg. 3 (a wavelength
    pair per group, as the reference test places them) and Alg. 4 (one
    rank per server on the server grid): the same routes in both."""
    out = []
    for pkg in (PORT, REF):
        CCm, Fm = pkg.CC, pkg.F
        rounds, cp = _joint_round_allocations(pkg, n, tp, dp)
        # ranks at interior nodes of a 10 x 10 mesh, a node apart
        place = [10 * (2 * (r // 4) + 1) + 2 * (r % 4) + 1 for r in range(n)]
        mesh = CCm.MZIMesh(10, 10)
        got = {"rounds": rounds, "cost": (cp.total_cost, cp.sequential_cost, cp.serialized)}
        for i, per_group in enumerate(rounds):
            reqs = [CCm.CircuitRequest(place[u], place[v], 2 * lam + (1 if u > v else 0))
                    for lam, circuits in enumerate(per_group) for (u, v) in circuits]
            res = CCm.route_circuits(mesh, reqs)
            CCm.validate_routes(mesh, res, reqs)
            demands = sorted({e for circuits in per_group for e in circuits})
            fib = Fm.route_fibers(Fm.server_grid(n), demands)
            got[i] = (res.routes, res.failed, _fibers(fib))
        out.append(got)
    assert out[0] == out[1]


# -------------------------------------------------------------- invariants


def _v(violations):
    return [(v.kind, v.where, v.message) for v in violations]


@pytest.fixture(scope="module")
def envs():
    return {tag: (pkg, pkg.T.ring(8), list(pkg.T.standard_topologies(8).values()))
            for tag, pkg in (("port", PORT), ("ref", REF))}


def _both(envs, fn):
    """``fn(pkg, g0, std)`` in both packages: the port's result and the
    reference's."""
    return fn(*envs["port"]), fn(*envs["ref"])


def test_round_feasibility_as_the_reference(envs):
    def run(pkg, g0, std):
        Sm, Im, cmm = pkg.S, pkg.inv, pkg.cm
        out = [_v(Im.check_round_feasibility(s, cmm.H100_DGX))
               for s in (Sm.ring_reduce_scatter(8, D), Sm.rhd_all_reduce(8, D),
                         Sm.dex_all_to_all(8, D), Sm.bucket_all_reduce((2, 4), D))]
        base = Sm.direct_all_to_all(4, D)
        merged = Sm.Schedule(base.collective, base.algorithm, base.n, base.buffer_bytes,
                             (Sm.Round(base.rounds[0].transfers + base.rounds[1].transfers,
                                       base.rounds[0].size),) + base.rounds[2:])
        out.append(_v(Im.check_round_feasibility(merged, tx_limit=1)))
        for t in (Sm.Transfer(0, 7, (0,), False), Sm.Transfer(2, 2, (0,), False)):
            bad = Sm.Schedule("p2p", "direct", 4, D, (Sm.Round((t,), D),))
            out.append(_v(Im.check_round_feasibility(bad)))
        return out

    got, want = _both(envs, run)
    assert got == want
    assert got[:4] == [[]] * 4 and all(got[4:])


def test_circuit_realizability_and_check_schedule_as_the_reference(envs):
    def run(pkg, g0, std):
        Sm, Im, cmm = pkg.S, pkg.inv, pkg.cm
        out = [_v(Im.check_circuit_realizability(s))
               for s in (Sm.rhd_reduce_scatter(8, D), Sm.direct_all_to_all(8, D),
                         Sm.ring_all_reduce(8, D), Sm.dex_all_to_all(16, D))]
        out.append(_v(Im.check_schedule(Sm.rhd_all_reduce(8, D), cmm.H100_DGX)))
        out.append(_v(Im.check_schedule(Sm.rhd_reduce_scatter(8, D), cmm.H100_DGX,
                                        realizability=True)))
        return out

    got, want = _both(envs, run)
    assert got == want == [[]] * 6


@pytest.mark.parametrize("mode", ["full", "partial", "overlap"])
def test_check_plan_as_the_reference(envs, mode):
    def run(pkg, g0, std):
        Sm, Pm, cmm, Im = pkg.S, pkg.P, pkg.cm, pkg.inv
        hw = {"full": cmm.H100_DGX,
              "partial": cmm.H100_DGX.with_link_reconfig(cmm.H100_DGX.reconfig_delay / 8),
              "overlap": cmm.H100_DGX.with_link_reconfig(cmm.H100_DGX.reconfig_delay / 8,
                                                         overlap=True)}[mode]
        out = []
        for sched in (Sm.rhd_reduce_scatter(8, D), Sm.dex_all_to_all(8, D),
                      Sm.ring_all_reduce(8, D)):
            p = Pm.plan(g0, std, sched, hw)
            out.append(_v(Im.check_plan(p, g0, std)))
            out.append(_v(Im.check_plan(replace(p, total_cost=p.total_cost * 1.5), g0, std)))
            steps = list(p.steps)
            steps[0] = replace(steps[0], state_idx=steps[0].state_idx + 1)
            out.append(_v(Im.check_plan(replace(p, steps=tuple(steps)), g0, std)))
            idx = next((i for i, s in enumerate(p.steps) if s.reconfigured), None)
            if idx is not None:
                steps = list(p.steps)
                steps[idx] = replace(steps[idx], reconfig_cost=steps[idx].reconfig_cost + 1.0)
                out.append(_v(Im.check_plan(replace(p, steps=tuple(steps)), g0, std)))
        return out

    got, want = _both(envs, run)
    assert got == want
    assert got[0] == [] and "total-cost" in {k for k, _, _ in got[1]} and got[2]


def test_mode_monotonicity_as_the_reference(envs):
    def run(pkg, g0, std):
        Sm, Im, cmm = pkg.S, pkg.inv, pkg.cm
        return [_v(Im.check_mode_monotonicity(g0, std, s, cmm.H100_DGX))
                for s in (Sm.rhd_reduce_scatter(8, D), Sm.ring_all_reduce(8, D))]

    got, want = _both(envs, run)
    assert got == want == [[], []]


def test_concurrent_plan_as_the_reference(envs):
    def run(pkg, g0, std):
        Sm, Pm, cmm, Im = pkg.S, pkg.P, pkg.cm, pkg.inv
        tp_groups, dp_groups = Sm.mesh_groups(4, 2)
        s_tp = Sm.replicate_groups(Sm.ring_all_reduce(4, D), tp_groups, 8)
        s_dp = Sm.replicate_groups(Sm.ring_all_reduce(2, D), dp_groups, 8)
        cp = Pm.plan_concurrent(g0, std, [s_tp, s_dp], cmm.H100_DGX)
        return [_v(Im.check_concurrent_plan(c, g0, std)) for c in (
            cp, replace(cp, joint_cost=cp.joint_cost * 2.0),
            replace(cp, sequential_cost=cp.sequential_cost + 5.0))]

    got, want = _both(envs, run)
    assert got == want
    assert got[0] == [] and {k for k, _, _ in got[1]} & {"joint-cost", "serialized-flag"}
    assert "sequential-cost" in {k for k, _, _ in got[2]}


@pytest.mark.parametrize("coll,algo", [("all_reduce", "ring"), ("reduce_scatter", "rhd"),
                                       ("all_to_all", "direct")])
def test_hierarchical_plan_as_the_reference(coll, algo):
    out = []
    for pkg in (PORT, REF):
        Tm, Sm, Pm, cmm, Im = pkg.T, pkg.S, pkg.P, pkg.cm, pkg.inv
        n = 16
        g0, std = Tm.ring(n), pkg.pccl.default_standard_set(n)
        hp = Pm.plan_hierarchical(g0, std, Sm.get_schedule(coll, algo, n, float(1 << 20)),
                                  cmm.H100_DGX, pod_size=4)
        bad_rounds = replace(hp, round_costs=(hp.round_costs[0] * 3,) + hp.round_costs[1:])
        out.append([_v(Im.check_hierarchical_plan(h, g0, std)) for h in (
            hp, replace(hp, total_cost=hp.total_cost * 2), bad_rounds,
            replace(hp, boundary=(((0, 1), 99),) * len(hp.boundary)))])
    assert out[0] == out[1]
    assert out[0][0] == [] and all(out[0][1:])


def test_assert_invariants_raises_the_same_message(envs):
    def run(pkg, g0, std):
        Sm, Pm, cmm, Im = pkg.S, pkg.P, pkg.cm, pkg.inv
        p = Pm.plan(g0, std, Sm.rhd_reduce_scatter(8, D), cmm.H100_DGX)
        Im.assert_invariants([])
        with pytest.raises(Im.PlanInvariantError) as e:
            Im.assert_invariants(Im.check_plan(replace(p, total_cost=p.total_cost + 1.0), g0, std))
        return str(e.value)

    got, want = _both(envs, run)
    assert got == want and "total-cost" in got


# -------------------------------------------------------------------- lint
#
# The snippets of tests/test_lint_concurrency.py, one rule each; the
# registry names are the reference's (the port's registries hold them too).

SNIPPETS = {
    "ug01_guarded_elsewhere": """
        import threading
        _CACHE = {}
        _LOCK = threading.Lock()

        def guarded(k, v):
            with _LOCK:
                _CACHE[k] = v

        def unguarded(k):
            return _CACHE.setdefault(k, [])
    """,
    "ug01_registry": f"""
        {sorted(ref_lint.SHARED_CACHE_REGISTRY)[0]} = {{}}

        def touch(k):
            {sorted(ref_lint.SHARED_CACHE_REGISTRY)[0]}[k] = 1
    """,
    "ug01_clean": """
        import threading
        _CACHE = {}
        _LOCK = threading.Lock()

        def a(k, v):
            with _LOCK:
                _CACHE[k] = v

        def b(k):
            with _LOCK:
                return _CACHE.pop(k, None)
    """,
    "ug01_internally_locked_call": f"""
        def use():
            return {sorted(ref_lint.INTERNALLY_LOCKED)[0]}.get("k")
    """,
    "ug01_internally_locked_rebind": f"""
        def reset():
            global {sorted(ref_lint.INTERNALLY_LOCKED)[0]}
            {sorted(ref_lint.INTERNALLY_LOCKED)[0]} = {{}}
    """,
    "cg01_unguarded": """
        import threading

        class Sess:
            def __init__(self):
                self._lock = threading.Lock()
                self._cache = {}

            def put(self, k, v):
                self._cache[k] = v
    """,
    "cg01_guarded": """
        import threading

        class Sess:
            def __init__(self):
                self._lock = threading.Lock()
                self._cache = {}

            def put(self, k, v):
                with self._lock:
                    self._cache[k] = v
    """,
    "cg01_annassign": """
        import threading
        from typing import Dict

        class Sess:
            def __init__(self):
                self._lock: threading.Lock = threading.Lock()
                self._cache: Dict = {}

            def put(self, k, v):
                self._cache[k] = v
    """,
    "cg01_no_lock": """
        class Plain:
            def __init__(self):
                self._items = []

            def add(self, x):
                self._items.append(x)
    """,
    "fa01": """
        def f(x):
            f.last = x
            return x
    """,
    "fa01_launch_counter": """
        def kernel_cuda(x):
            kernel_cuda.launches += 1
            return x

        kernel_cuda.launches = 0
    """,
    "md01": """
        def f(x, acc=[]):
            acc.append(x)
            return acc

        def g(x, *, opts={}):
            return opts
    """,
    "nested_def_drops_lock": """
        import threading
        _CACHE = {}
        _LOCK = threading.Lock()

        def outer():
            with _LOCK:
                _CACHE["a"] = 1

                def inner():
                    _CACHE["b"] = 2
                return inner
    """,
    "lint_ok": """
        def f(x):
            f.last = x  # lint-ok: test fixture
            return x
    """,
    "parse_error": "def broken(:\n",
}


def _findings(mod, source):
    import textwrap

    return [(f.path, f.line, f.rule, f.name, f.message)
            for f in mod.lint_module("<test>", source=textwrap.dedent(source))]


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_lint_snippet_findings_as_the_reference(name):
    got = _findings(lint, SNIPPETS[name])
    assert got == _findings(ref_lint, SNIPPETS[name])
    want_rules = {"ug01_guarded_elsewhere": ["UG01"], "ug01_registry": ["UG01"],
                  "ug01_internally_locked_rebind": ["UG01"], "cg01_unguarded": ["CG01"],
                  "cg01_annassign": ["CG01"], "fa01": ["FA01"], "fa01_launch_counter": ["FA01"],
                  "md01": ["MD01", "MD01"], "nested_def_drops_lock": ["UG01"],
                  "parse_error": ["PARSE"]}
    assert [f[2] for f in got] == want_rules.get(name, [])


def test_the_ports_registries_extend_the_references():
    assert ref_lint.SHARED_CACHE_REGISTRY < lint.SHARED_CACHE_REGISTRY
    assert ref_lint.INTERNALLY_LOCKED < lint.INTERNALLY_LOCKED
    assert {"_LOADED", "_FUSED_DISPATCHES", "_FALLBACK_DISPATCHES", "_CHUNKS_STREAMED",
            "_BYTES_HIDDEN"} <= lint.SHARED_CACHE_REGISTRY
    assert {"_DEVICE_TABLES", "LAUNCHES"} <= lint.INTERNALLY_LOCKED


@pytest.mark.parametrize("name", sorted({"_LOADED", "_FUSED_DISPATCHES", "_DEVICE_TABLES",
                                         "LAUNCHES"}))
def test_the_ports_shared_names_must_be_guarded(name):
    """A rebind of any of the port's registered names without its lock is a
    finding; for a registry name, so is any mutation."""
    rebind = _findings(lint, f"""
        def reset():
            global {name}
            {name} = {{}}
    """)
    assert [f[2] for f in rebind] == ["UG01"]
    if name in lint.SHARED_CACHE_REGISTRY:
        touch = _findings(lint, f"""
            def touch(k):
                {name}[k] = 1
        """)
        assert [f[2] for f in touch] == ["UG01"]


def test_the_port_lints_clean_with_both_lints():
    paths = [str(ROOT / "src" / "repro_torch")]
    assert [str(f) for f in lint.lint_paths(paths)] == []
    assert [str(f) for f in ref_lint.lint_paths(paths)] == []


def test_the_reference_tree_lints_the_same_under_the_ports_lint():
    """The port's registries only add names the reference tree does not
    hold at module level, so its lint of ``src/repro`` equals the
    reference's: 0 findings."""
    paths = [str(ROOT / "src" / "repro")]
    assert [str(f) for f in lint.lint_paths(paths)] == [str(f) for f in ref_lint.lint_paths(paths)]
