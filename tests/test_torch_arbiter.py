"""The port's fabric arbiter against the JAX package's, on the CPU.

Each scenario of ``tests/test_serve_arbiter.py`` runs on both packages —
admission, shedding, preemption, joint planning with offsets, the plan
cache, link failures — and what it records must be *equal*: every
request's outcome, the counters, the virtual clock, each round's costs,
the session's cache statistics, the fabric's edges and the error
messages.  The arbiter's clock is virtual and its plans come from the
copied planner, so nothing here is approximate.  Then the engine's joint
pricing of prefill-TP with decode-DP (``tests/test_system.py``'s tp = dp
= 4 engine): ``comm_report()`` of both engines, ``"concurrent"`` included.
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.api import PcclSession as RefSession
from repro.core import cost_model as ref_cm
from repro.core import topology as ref_topology
from repro.runtime import fault as ref_fault
from repro.serve import arbiter as ref_arbiter
from repro.serve import engine as ref_engine
from repro_torch import configs
from repro_torch.api import PcclSession
from repro_torch.core import cost_model as cm
from repro_torch.core import topology
from repro_torch.models import build_model
from repro_torch.runtime import fault
from repro_torch.serve import arbiter
from repro_torch.serve import engine

N = 16
REF = SimpleNamespace(A=ref_arbiter, fault=ref_fault, cm=ref_cm, T=ref_topology,
                      session=lambda hw, **kw: RefSession(hw, **kw))
PORT = SimpleNamespace(A=arbiter, fault=fault, cm=cm, T=topology,
                       session=lambda hw, **kw: PcclSession(hw, device="cpu", **kw))


def _plain(x):
    """``x`` as comparable plain data: dataclasses as dicts, tuples as lists,
    NaN as a string (NaN != NaN)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return _plain(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def _make(m, **cfg_kwargs):
    return m.A.FabricArbiter(m.session(m.cm.H100_DGX, g0=m.T.ring(N)), tp=4, dp=4, d_model=512,
                             cfg=m.A.ArbiterConfig(**cfg_kwargs))


def _record(arb, ticks=()):
    return {"ticks": list(ticks), "outcomes": arb.outcomes, "report": arb.report(),
            "clock": arb.clock, "queue_depth": arb.queue_depth,
            "preempted_rids": dict(arb.preempted_rids),
            "stats": (arb.session.stats.hits, arb.session.stats.misses)}


# ---------------------------------------------------------------- scenarios
def empty_queue_tick(m):
    arb = _make(m)
    ticks = [arb.tick()]
    assert ticks[0]["executed"] == 0 and ticks[0]["round_s"] == 0.0
    assert arb.clock == 0.0 and arb.rounds == 0
    ticks.append(arb.tick(now=1.5))
    assert arb.clock == 1.5 and arb.rounds == 0
    assert arb.report()["utilization"] == 0.0
    return _record(arb, ticks)


def all_deadlines_expired(m):
    arb = _make(m)
    for _ in range(3):
        arb.submit(arb.make_request(m.A.DECODE))
    arb.submit(arb.make_request(m.A.PREFILL, context_len=256))
    out = arb.tick(now=10.0)
    assert out["executed"] == 0 and arb.queue_depth == 0
    assert arb.report()["shed_reasons"][m.A.SHED_DEADLINE] == 4
    return _record(arb, [out])


def burst_beyond_queue_bound(m):
    arb = _make(m, queue_bound=4)
    accepted = [arb.submit(arb.make_request(m.A.DECODE)) for _ in range(10)]
    assert sum(accepted) == 4 and arb.queue_depth == 4
    kv = arb.make_request(m.A.KV_MIGRATION, context_len=64)
    arb2 = _make(m, queue_bound=1)
    accepted += [arb2.submit(kv), arb2.submit(arb2.make_request(m.A.DECODE))]
    assert [o.rid for o in arb2.outcomes if o.status == "shed"] == [kv.rid]
    return {"accepted": accepted, "first": _record(arb), "second": _record(arb2)}


def request_validation(m):
    arb = _make(m)
    errors = []
    for make in (lambda: arb.make_request("training"),
                 lambda: arb.make_request(m.A.PREFILL, context_len=0),
                 lambda: m.A.FabricArbiter(m.session(m.cm.H100_DGX), tp=1, dp=4, d_model=64),
                 lambda: m.A.FabricArbiter(m.session(m.cm.H100_DGX), tp=4, dp=1, d_model=64),
                 lambda: m.A.ArbiterConfig(queue_bound=0),
                 lambda: m.A.ArbiterConfig(max_batch=0),
                 lambda: m.A.ArbiterConfig(prefill_lead_rounds=-1),
                 lambda: m.A.SlaTarget().deadline("training")):
        with pytest.raises(ValueError) as err:
            make()
        errors.append(str(err.value))
    return {"errors": errors, "arbiter": _record(arb)}


def preemption_during_fused_dispatch(m):
    arb = _make(m, sla=m.A.SlaTarget(prefill_s=10.0, decode_s=1e-7, kv_migration_s=10.0),
                fused_dispatch=True)
    pf = arb.make_request(m.A.PREFILL, context_len=512)
    arb.submit(pf)
    arb.submit(arb.make_request(m.A.DECODE))
    out = arb.tick()
    assert out["preempted"] is True and out["kinds"] == (m.A.DECODE,)
    assert arb.preemptions == 1 and arb.fused_fallbacks == 1 and arb.queue_depth == 1
    out2 = arb.tick()
    assert out2["executed"] == 1 and out2["preempted"] is False
    assert [o.preemptions for o in arb.outcomes if o.rid == pf.rid] == [1]
    return _record(arb, [out, out2])


def no_preemption_when_disabled_or_sla_met(m):
    arb = _make(m, preemption=False, sla=m.A.SlaTarget(10.0, 1e-7, 10.0))
    arb.submit(arb.make_request(m.A.PREFILL, context_len=512))
    arb.submit(arb.make_request(m.A.DECODE))
    out = arb.tick()
    assert out["preempted"] is False and out["executed"] == 2
    arb2 = _make(m)
    arb2.submit(arb2.make_request(m.A.PREFILL, context_len=512))
    arb2.submit(arb2.make_request(m.A.DECODE))
    out2 = arb2.tick()
    assert out2["preempted"] is False
    return {"first": _record(arb, [out]), "second": _record(arb2, [out2])}


def mixed_round_plans_jointly_with_offsets(m):
    arb = _make(m, prefill_lead_rounds=2)
    for _ in range(3):
        arb.submit(arb.make_request(m.A.DECODE))
    arb.submit(arb.make_request(m.A.PREFILL, context_len=300))
    arb.submit(arb.make_request(m.A.KV_MIGRATION, context_len=700))
    out = arb.tick()
    assert out["executed"] == 5
    assert out["kinds"] == (m.A.PREFILL, m.A.DECODE, m.A.KV_MIGRATION)
    assert out["joint_s"] <= out["sequential_s"] * (1 + 1e-12)
    return _record(arb, [out])


def repeat_shapes_hit_plan_cache(m):
    arb = _make(m)
    ticks = []
    for _ in range(4):
        for _ in range(3):
            arb.submit(arb.make_request(m.A.DECODE))
        arb.submit(arb.make_request(m.A.PREFILL, context_len=300))
        before = (arb.session.stats.hits, arb.session.stats.misses)
        ticks.append(arb.tick())
    assert (arb.session.stats.hits, arb.session.stats.misses) == (before[0] + 1, before[1])
    return _record(arb, ticks)


def replan_under_load_after_fail_link(m):
    arb = _make(m)
    for _ in range(2):
        arb.submit(arb.make_request(m.A.DECODE))
    ticks = [arb.tick()]
    failure = m.fault.fail_link(arb, 0, 1)
    assert isinstance(failure, m.fault.LinkFailure) and arb.faults == 1
    edges = sorted(arb.session.fabric(N).edges)
    assert (0, 1) not in edges and (1, 0) not in edges
    for _ in range(2):
        arb.submit(arb.make_request(m.A.DECODE))
    arb.submit(arb.make_request(m.A.PREFILL, context_len=128))
    ticks.append(arb.tick())
    assert ticks[-1]["executed"] == 3
    return {"edges": edges, **_record(arb, ticks)}


def fail_link_on_bare_session(m):
    sess = m.session(m.cm.H100_DGX, g0=m.T.ring(8))
    m.fault.fail_link(sess, 2, 3)
    edges = sorted(sess.fabric(8).edges)
    assert (2, 3) not in edges and (3, 2) not in edges
    return {"edges": edges, "stats": (sess.stats.hits, sess.stats.misses)}


SCENARIOS = [empty_queue_tick, all_deadlines_expired, burst_beyond_queue_bound,
             request_validation, preemption_during_fused_dispatch,
             no_preemption_when_disabled_or_sla_met, mixed_round_plans_jointly_with_offsets,
             repeat_shapes_hit_plan_cache, replan_under_load_after_fail_link,
             fail_link_on_bare_session]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_arbiter_scenario_equals_the_references(scenario):
    want, got = _plain(scenario(REF)), _plain(scenario(PORT))
    assert got == want


def test_every_name_of_the_reference_arbiter_is_ported():
    public = {n for n in dir(ref_arbiter) if not n.startswith("_") and n.isupper()
              or n in ("ArbiterConfig", "FabricArbiter", "RequestOutcome", "ServeRequest",
                       "SlaTarget")}
    assert public <= set(dir(arbiter))
    assert {n: getattr(arbiter, n) for n in public if n.isupper()} == \
        {n: getattr(ref_arbiter, n) for n in public if n.isupper()}


# ------------------------------------------------------------------ engine
def _nest(flat):
    nested = {}
    for key, value in flat.items():
        node = nested
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return nested


def test_engine_concurrent_prefill_tp_decode_dp_equals_the_references():
    """tests/test_system.py's engine on both packages, tp = dp = 4, reduced
    chatglm3-6b at 2 layers, one generate: ``comm_report()`` equal but for
    the engine counters, the arbiter's joint pricing (``"concurrent"``)
    included; ``arbiter()`` is
    one shared object and a config rebuilds it; dp = 1 has no
    ``"concurrent"``."""
    ref_cfg = dataclasses.replace(ref_configs.get_config("chatglm3-6b").reduced(), n_layers=2)
    cfg = dataclasses.replace(configs.get_config("chatglm3-6b").reduced(), n_layers=2)
    state = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu").state_dict()
    ref_params = jax.tree.map(jnp.asarray, _nest({k: v.numpy() for k, v in state.items()}))
    reports = []
    for mod, kw in ((ref_engine, dict(params=ref_params)), (engine, dict(params=state,
                                                                          device="cpu"))):
        eng = mod.ServeEngine(cfg if mod is engine else ref_cfg,
                              mod.EngineConfig(batch_size=2, max_len=32, tp=4, dp=4), **kw)
        eng.generate([mod.Request(prompt=np.full(8, 3, np.int32), max_new_tokens=2)])
        rep = eng.comm_report()
        assert eng.arbiter() is eng.arbiter()
        rebuilt = eng.arbiter(type(eng.arbiter().cfg)(queue_bound=8))
        assert rebuilt is eng.arbiter() and rebuilt.cfg.queue_bound == 8
        one = mod.ServeEngine(cfg if mod is engine else ref_cfg,
                              mod.EngineConfig(batch_size=2, max_len=32, tp=4), **kw)
        assert "concurrent" not in one.comm_report()
        reports.append((rep, eng.concurrent_report()))
    (want, want_c), (got, got_c) = reports
    # "exec" holds each package's execution-engine counters, which differ
    # in kind (the port counts device-table uploads too)
    assert _plain({k: v for k, v in got.items() if k != "exec"}) == \
        _plain({k: v for k, v in want.items() if k != "exec"})
    # a second pricing starts from the fabric the first one left (threaded)
    assert _plain(got_c) == _plain(want_c)
    c = got["concurrent"]
    assert c["tp"] == c["dp"] == 4 and len(c["algorithms"]) == 2
    assert c["joint_s"] <= c["sequential_s"] * (1 + 1e-12) and c["speedup"] >= 1.0
