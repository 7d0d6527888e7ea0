"""The port's training runtime against the JAX package, on the CPU.

Checkpoints (round trip, keep-k GC, the COMMIT marker, refusals, a
writer's error at ``wait()``, async saves that AdamW races, and the same
layout on disk as the reference's), the fault runtime (failure injection,
stragglers, a replan after a link failure: the same plan as the
reference's), the ``Trainer`` (each step's loss, the PCCL gradient plan,
restarts, a JAX checkpoint carried across and continued), train →
checkpoint → serve, the CLI and the fault-tolerant example.

Both trainers start from the same weights, drawn by the port's
initializers (the reference's eager init compiles every draw anew): the
JAX ``Trainer``'s ``_init_state`` is replaced by one that returns them.
Tolerances: losses 1e-5 relative (AdamW over several steps in another
summation order; the reference's own restart test uses 1e-5); the PCCL
plan, the fault runtime and the port's restart against its own
uninterrupted run exactly.
"""

import ast
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro import configs as ref_configs
from repro.api import PcclSession as RefSession
from repro.ckpt import checkpoint as ref_ckpt
from repro.core import cost_model as ref_cm
from repro.core import topology as ref_topology
from repro.data import pipeline as ref_pipeline
from repro.runtime import fault as ref_fault
from repro.serve import engine as ref_engine
from repro.train import optimizer as ref_opt
from repro.train import trainer as ref_trainer
from repro_torch import configs
from repro_torch.api import PcclSession
from repro_torch.ckpt import CheckpointConfig, CheckpointManager
from repro_torch.ckpt.checkpoint import flatten
from repro_torch.convert import model_params_from_reference, opt_state_from_reference
from repro_torch.core import cost_model as cm
from repro_torch.core import topology
from repro_torch.data import DataConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import ParamTree, build_model
from repro_torch.runtime import fault
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig
from repro_torch.train import optimizer as opt

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "fault_tolerant_training_torch.py"
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _first_matmul():
    """One plain float32 matmul before any comparison (see
    tests/test_torch_models.py: the first batched MKL product of a fresh
    process can come out wrong)."""
    torch.ones(64, 64) @ torch.ones(64, 64)


def _nest(flat):
    """The reference's nested dicts (and lists, where the names are 0 … n-1)
    of a flat ``{"a.b.c": array}``."""
    nested = {}
    for key, value in flat.items():
        node = nested
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        return list(node.values()) if list(node) == [str(i) for i in range(len(node))] else node

    return lists(nested)


def _cfgs(arch, n_layers=2):
    return (dataclasses.replace(ref_configs.get_config(arch).reduced(), n_layers=n_layers),
            dataclasses.replace(configs.get_config(arch).reduced(), n_layers=n_layers))


def _ref_trainer_class(cfg, seed=0):
    """The JAX ``Trainer`` whose initial weights are the port's draw from
    ``seed`` (the port's ``Trainer`` draws the same)."""
    init = build_model(cfg).init(torch.Generator().manual_seed(seed), "cpu").state_dict()
    weights = _nest({k: v.numpy() for k, v in init.items()})

    class RefTrainer(ref_trainer.Trainer):
        def _init_state(self):
            params = jax.tree.map(jnp.asarray, weights)
            return params, ref_opt.init_opt_state(params)

    return RefTrainer


def _trainers(arch, tmp_path=None, *, steps=8, fail_at=(), n_hosts=1, total=None, **tcfg):
    """The JAX and the port's ``Trainer`` of reduced ``arch`` (2 layers),
    batch 2 × 16, alike in everything; checkpoints every 2 steps under
    ``tmp_path/{ref,port}`` when it is given."""
    ref_cfg, cfg = _cfgs(arch)
    opt_kw = dict(lr=1e-3, total_steps=total or steps, warmup_steps=1)
    data_kw = dict(global_batch=2 * n_hosts, seq_len=16, n_hosts=n_hosts)
    t_kw = dict(total_steps=steps, ckpt_every=2, log_every=100, **tcfg)
    ck = (lambda side, cls: None) if tmp_path is None else (
        lambda side, cls: cls(str(tmp_path / side), keep=3, async_write=False))
    ref = _ref_trainer_class(cfg)(
        ref_cfg, ref_pipeline.DataConfig(**data_kw), ref_opt.OptimizerConfig(**opt_kw),
        ref_trainer.TrainerConfig(**t_kw), ckpt_cfg=ck("ref", ref_ckpt.CheckpointConfig),
        failure_injector=ref_fault.FailureInjector(fail_at_steps=fail_at))
    port = Trainer(cfg, DataConfig(**data_kw), OptimizerConfig(**opt_kw), TrainerConfig(**t_kw),
                   ckpt_cfg=ck("port", CheckpointConfig),
                   failure_injector=fault.FailureInjector(fail_at_steps=fail_at), device="cpu")
    return ref, port


def _losses(out):
    return [(h["step"], h["loss"]) for h in out["history"]]


def _assert_losses_close(got, want):
    assert [s for s, _ in got] == [s for s, _ in want]
    np.testing.assert_allclose([x for _, x in got], [x for _, x in want], rtol=LOSS_RTOL)


def _state(params, state):
    """A train state's tensors by name (the checkpoint's leaf order)."""
    return dict(flatten((params, state)))


# --------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), keep=2, async_write=False))
    tree = {"a": torch.arange(5, dtype=torch.float32), "b": {"c": torch.ones(2, 3)}}
    for s in [10, 20, 30]:
        mgr.save(s, {"a": tree["a"] + s, "b": {"c": tree["b"]["c"] + s}}, extra={"s": s})
    assert mgr.steps() == [20, 30]  # keep=2 GC
    template = {"a": torch.zeros(5), "b": {"c": torch.zeros(2, 3, dtype=torch.float64)}}
    restored, step, extra = mgr.restore(template)
    assert step == 30 and extra == {"s": 30}
    assert restored is template  # the values were copied into the template's tensors
    assert torch.equal(restored["a"], torch.arange(5, dtype=torch.float32) + 30)
    assert restored["b"]["c"].dtype == torch.float64 and bool((restored["b"]["c"] == 31).all())
    _, step, _ = mgr.restore(template, step=20)
    assert step == 20 and torch.equal(template["a"], torch.arange(5, dtype=torch.float32) + 20)


def test_checkpoint_async_and_commit_marker(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_write=True))
    tree = {"w": torch.ones(4)}
    mgr.save(1, tree)
    mgr.wait()
    assert mgr.latest_step() == 1
    # un-committed directories are ignored
    (tmp_path / "step_000000099").mkdir()
    (tmp_path / ".tmp_step_000000100").mkdir()
    assert mgr.latest_step() == 1 and mgr.steps() == [1]
    assert not list(tmp_path.glob(".tmp_step_000000001"))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(CheckpointConfig(str(tmp_path / "empty"))).restore(tree)


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_write=False))
    mgr.save(1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.ones(5)})
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"w": torch.ones(4), "v": torch.ones(4)})


def test_checkpoint_name_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_write=False))
    mgr.save(1, {"w": torch.ones(4), "b": torch.zeros(2)})
    template = {"w": torch.zeros(4), "c": torch.ones(2)}
    with pytest.raises(ValueError, match="names"):
        mgr.restore(template)
    assert torch.equal(template["w"], torch.zeros(4))  # nothing was copied


def test_checkpoint_writer_error_surfaces_at_wait(tmp_path):
    """A write that fails in the writer thread raises at the next ``wait()``
    (here: a file where the temporary directory goes), once, and leaves no
    committed step."""
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_write=True))
    (tmp_path / ".tmp_step_000000007").write_text("in the way")
    mgr.save(7, {"w": torch.ones(3)})
    with pytest.raises(NotADirectoryError):
        mgr.wait()
    mgr.wait()  # raised once
    assert mgr.steps() == []
    (tmp_path / ".tmp_step_000000007").unlink()
    mgr.save(7, {"w": torch.ones(3)})
    mgr.wait()
    assert mgr.steps() == [7]


def test_async_save_then_in_place_adamw_restores_the_saved_state(tmp_path):
    """AdamW updates parameters and moments in place right after an async
    save; the writer, held until the update is done, still writes the state
    as it was at save time."""
    import threading

    params = {"w": torch.linspace(-1, 1, 64).reshape(8, 8).clone()}
    state = opt.init_opt_state(params)
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=1)
    grads = {"w": torch.full((8, 8), 0.5)}
    params, state, _ = opt.adamw_update(cfg, grads, params, state)
    saved = {k: v.clone() for k, v in _state(params, state).items()}
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_write=True))
    gate, write = threading.Event(), mgr._write

    def held_write(*args):
        assert gate.wait(timeout=60)
        write(*args)

    mgr._write = held_write
    mgr.save(1, (params, state))
    params, state, _ = opt.adamw_update(cfg, grads, params, state)  # in place
    assert not torch.equal(params["w"], saved["0.w"])
    gate.set()
    mgr.wait()
    fresh = {"w": torch.zeros(8, 8)}
    (_, restored_state), step, _ = mgr.restore((fresh, opt.init_opt_state(fresh)))
    assert step == 1
    got = _state(fresh, restored_state)
    assert set(got) == set(saved) == {"0.w", "1.step", "1.mu.w", "1.nu.w"}
    assert all(torch.equal(got[k], saved[k]) for k in saved)


def test_bfloat16_leaf_is_refused_by_name(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_write=False))
    with pytest.raises(ValueError, match=r"'b\.h'.*bfloat16"):
        mgr.save(1, {"a": torch.ones(2), "b": {"h": torch.ones(2, dtype=torch.bfloat16)}})
    assert mgr.steps() == []


@pytest.mark.parametrize("shard_bytes", [1 << 30, 300, 0])
def test_checkpoint_layout_equals_the_references(tmp_path, shard_bytes):
    """The same tree through both managers: the same directory and file
    names, the same shards for the same leaf sizes and ``shard_bytes``, the
    same manifest but for ``names`` where the reference writes its treedef,
    and the same arrays in each shard."""
    rng = np.random.default_rng(0)
    flat = {"embed": rng.normal(size=(16, 8)).astype(np.float32),
            "layers.0.w": rng.normal(size=(8, 8)).astype(np.float32),
            "layers.1.w": rng.normal(size=(8, 4)).astype(np.float32),
            "ln": rng.normal(size=(8,)).astype(np.float32)}
    tree = (_nest(flat), (np.int32(3), {"x": np.arange(6, dtype=np.int32)}))

    def to(fn, t):
        return jax.tree.map(fn, t)

    dirs = {"ref": tmp_path / "ref", "port": tmp_path / "port"}
    ref_ckpt.CheckpointManager(ref_ckpt.CheckpointConfig(
        str(dirs["ref"]), async_write=False, shard_bytes=shard_bytes)).save(
        5, to(jnp.asarray, tree), extra={"loss": 1.5})
    CheckpointManager(CheckpointConfig(str(dirs["port"]), async_write=False,
                                       shard_bytes=shard_bytes)).save(
        5, to(lambda a: torch.from_numpy(np.array(a)), tree), extra={"loss": 1.5})
    listing = {k: sorted(str(p.relative_to(d)) for p in d.rglob("*")) for k, d in dirs.items()}
    assert listing["ref"] == listing["port"]
    assert "step_000000005/COMMIT" in listing["port"]
    man = {k: json.loads((d / "step_000000005" / "manifest.json").read_text())
           for k, d in dirs.items()}
    ref_man, port_man = man["ref"], man["port"]
    assert set(ref_man) - {"treedef"} == set(port_man) - {"names"}
    for key in ("step", "n_leaves", "n_shards", "shapes", "dtypes", "extra"):
        assert port_man[key] == ref_man[key], key
    assert port_man["n_shards"] == {1 << 30: 1, 300: 3, 0: 6}[shard_bytes]
    assert port_man["names"] == ["0.embed", "0.layers.0.w", "0.layers.1.w", "0.ln", "1.0", "1.1.x"]
    for si in range(port_man["n_shards"]):
        with np.load(dirs["ref"] / "step_000000005" / f"shard_{si:05d}.npz") as a, \
                np.load(dirs["port"] / "step_000000005" / f"shard_{si:05d}.npz") as b:
            assert a.files == b.files
            assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a.files)


# ------------------------------------------------------------ fault runtime
def test_failure_injector_fires_once_per_step():
    inj = fault.FailureInjector(fail_at_steps=(2, 5))
    for step in (0, 1):
        inj.check(step)
    for step in (2, 5):
        with pytest.raises(fault.InjectedFailure, match=f"step {step}"):
            inj.check(step)
        inj.check(step)  # fired once: the replay passes
    assert inj.fired == {2, 5}
    with pytest.raises(ValueError, match="edge or rank"):
        fault.LinkFailure()
    assert fault.LinkFailure(ranks=(3,)).edges == ()


@pytest.mark.parametrize("hosts", [
    [1.0, 1.1, 0.9, 3.5],          # tests/test_train_substrate.py's straggler
    [0.5, 0.5, 0.5, 0.5, 0.5],     # nobody
    [2.0, 0.3, 0.31, 0.29, 5.0, 0.3],
])
def test_stragglers_and_rebalance_equal_the_references(hosts):
    """The same recorded times (a few steps each, with jitter) through both
    detectors: the same medians, stragglers and grain allocation."""
    dets = [mod.StragglerDetector(mod.StragglerConfig(window=10, threshold=2.0, min_samples=3),
                                  len(hosts)) for mod in (ref_fault, fault)]
    rng = np.random.default_rng(len(hosts))
    for _ in range(6):
        for h, t in enumerate(hosts):
            jitter = float(rng.uniform(0.95, 1.05))
            for det in dets:
                det.record(h, t * jitter)
    ref, port = dets
    assert port.host_medians() == ref.host_medians()
    assert port.stragglers() == ref.stragglers()
    for grains in (100, 7, len(hosts)):
        assert port.rebalance_grains(grains) == ref.rebalance_grains(grains)
        assert sum(port.rebalance_grains(grains).values()) == grains
    empty = fault.StragglerDetector(fault.StragglerConfig(), 4)
    assert empty.rebalance_grains(10) == ref_fault.StragglerDetector(
        ref_fault.StragglerConfig(), 4).rebalance_grains(10)


def _plan_record(plan):
    return plan.schedule.fingerprint(), plan.algorithm, plan.cost


@pytest.mark.parametrize("failure", [dict(edges=((2, 3),)), dict(ranks=(5,)),
                                     dict(edges=((0, 1), (4, 5)))])
def test_replan_after_failure_equals_the_references(failure):
    """A bare session on an 8-ring: the warm replan after a link or rank
    failure, then another plan: the same schedules, algorithms and costs as
    the reference's, and the dead links gone from both fabrics after the
    replan.  (The later plan may re-enter a dead link through a round's
    ideal topology, in both packages: ROADMAP Queue 3.)"""
    out = []
    for mod, session_cls, cost, topo in ((ref_fault, RefSession, ref_cm, ref_topology),
                                         (fault, PcclSession, cm, topology)):
        kw = {} if mod is ref_fault else {"device": "cpu"}
        sess = session_cls(cost.H100_DGX, g0=topo.ring(8), **kw)
        sess.plan("all_reduce", 1 << 20, n=8)
        replanned = mod.replan_after_failure(sess, mod.LinkFailure(**failure), "all_reduce",
                                             1 << 20, n=8)
        degraded = sorted(sess.fabric(8).edges)
        after = sess.plan("reduce_scatter", 1 << 22, n=8)
        out.append((_plan_record(replanned), degraded, _plan_record(after),
                     sorted(sess.fabric(8).edges)))
    assert out[0] == out[1]
    for u, v in failure.get("edges", ()):
        assert (u, v) not in out[1][1] and (v, u) not in out[1][1]


def test_fail_link_on_a_bare_session_equals_the_references():
    out = []
    for mod, session_cls, cost, topo in ((ref_fault, RefSession, ref_cm, ref_topology),
                                         (fault, PcclSession, cm, topology)):
        kw = {} if mod is ref_fault else {"device": "cpu"}
        sess = session_cls(cost.H100_DGX, g0=topo.ring(8), **kw)
        failure = mod.fail_link(sess, 2, 3)
        assert failure == mod.LinkFailure(edges=((2, 3),))
        out.append((sorted(sess.fabric(8).edges),
                    _plan_record(sess.plan("all_reduce", 4096.0, n=8))))
    assert out[0] == out[1]
    assert (2, 3) not in out[1][0] and (3, 2) not in out[1][0]


# ------------------------------------------------------------------ trainer
@pytest.mark.parametrize("arch", ["chatglm3-6b", "whisper-small"])
def test_trainer_losses_match_reference(arch):
    """Reduced ``arch`` at 2 layers, batch 2 × 16, 8 steps from the same
    weights: every step's loss within 1e-5 relative of the JAX Trainer's
    (both plain), and the result's keys the reference's."""
    ref, port = _trainers(arch, steps=8)
    want, got = ref.run(), port.run()
    _assert_losses_close(_losses(got), _losses(want))
    assert set(got) == set(want)
    assert set(got["final_metrics"]) == set(want["final_metrics"])
    assert got["grad_allreduce_algorithm"] == "none" and got["pccl_concurrent"] is None
    assert want["pccl_concurrent"] is None
    assert got["stragglers"] == []
    assert all(p.device.type == "cpu" for p in got["params"].parameters())


@pytest.mark.parametrize("tol", [None, 1e-2])
def test_trainer_pccl_gradient_plan_equals_the_references(tol):
    """At ``n_hosts=4`` both trainers plan the gradient all-reduce of the
    model's fp32 parameters cold and then warm on the photonic fabric
    model: the same algorithm and the same two costs (with a relative-error
    tolerance, the arbitration may take the int8 ring)."""
    ref, port = _trainers("chatglm3-6b", n_hosts=4, grad_allreduce_rel_error_tol=tol)
    assert port.grad_allreduce_algorithm == ref.grad_allreduce_algorithm
    assert port.grad_allreduce_cost_s == ref.grad_allreduce_cost_s
    assert port.grad_allreduce_cost_s["steady"] <= port.grad_allreduce_cost_s["cold"]
    assert (port.pccl.stats.hits, port.pccl.stats.misses) == (ref.pccl.stats.hits,
                                                              ref.pccl.stats.misses)


def test_restart_is_bit_equal_to_the_uninterrupted_run_and_matches_reference(tmp_path):
    """A failure at step 3 with checkpoints every 2 steps: the port restarts
    from step 2, replays steps 2 and 3, and ends with parameters and moments
    bit-equal to its uninterrupted run's; its losses are the JAX failure
    run's within 1e-5."""
    _, clean = _trainers("chatglm3-6b", steps=6)
    ref, port = _trainers("chatglm3-6b", tmp_path, steps=6, fail_at=(3,))
    want, got, base = ref.run(), port.run(), clean.run()
    assert [h["step"] for h in got["history"]] == [0, 1, 2, 2, 3, 4, 5]
    _assert_losses_close(_losses(got), _losses(want))
    a, b = _state(got["params"], got["opt_state"]), _state(base["params"], base["opt_state"])
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert int(got["opt_state"].step) == 6
    assert port.ckpt.latest_step() == 6 and port.ckpt.steps() == [2, 4, 6]


def test_restart_waits_for_the_checkpoint_being_written(tmp_path):
    """A failure while the step-2 checkpoint is still being written (its
    writer held until 0.5 s after the failure): the restart waits for the
    writer and resumes from step 2.  The reference's ``_run_once`` looks up
    the newest committed step before it waits (``src/repro/train/
    trainer.py:195``) and would restart from scratch here; the port waits
    first (found on the card, where a reduced step outruns the writer)."""
    import threading

    port = _trainers("chatglm3-6b", steps=6)[1]
    port = Trainer(port.cfg, port.data_cfg, port.opt_cfg, port.tcfg,
                   ckpt_cfg=CheckpointConfig(str(tmp_path), keep=3, async_write=True),
                   failure_injector=fault.FailureInjector(fail_at_steps=(3,)), device="cpu")
    gate, write, check = threading.Event(), port.ckpt._write, port.injector.check

    def held_write(step, *args):
        if step == 2:
            assert gate.wait(timeout=60)
        write(step, *args)

    def failing_check(step):
        try:
            check(step)
        except fault.InjectedFailure:
            threading.Timer(0.5, gate.set).start()
            raise

    port.ckpt._write, port.injector.check = held_write, failing_check
    out = port.run()
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 2, 3, 4, 5]
    assert gate.is_set() and port.ckpt.steps() == [2, 4, 6]


def test_trainer_refuses_a_mesh():
    """A mesh of several ranks is priced at construction; ``run()`` refuses
    one that is not a torch ``DeviceMesh`` (the sharded step places
    DTensors on it).  (The pricing and the one-rank run:
    ``tests/test_torch_sharding.py``; the sharded step on a live world:
    ``tests/test_torch_elastic.py``.)"""
    from types import SimpleNamespace

    ref_cfg, cfg = _cfgs("chatglm3-6b")
    args = (cfg, DataConfig(global_batch=2, seq_len=16), OptimizerConfig(), TrainerConfig())
    mesh = SimpleNamespace(shape=(2, 2), mesh_dim_names=("data", "model"))
    trainer = Trainer(*args, device="cpu", mesh=mesh, rules=object())
    assert trainer.concurrent_step_cost is not None
    with pytest.raises(TypeError, match="DeviceMesh"):
        trainer.run()


def test_trainer_defaults_to_cuda():
    _, cfg = _cfgs("chatglm3-6b")
    args = (cfg, DataConfig(global_batch=2, seq_len=16), OptimizerConfig(), TrainerConfig())
    if torch.cuda.is_available():
        assert Trainer(*args).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(*args)


def test_trainer_continues_from_a_jax_checkpoint(tmp_path):
    """The JAX Trainer trains 4 steps and checkpoints; the JAX
    ``CheckpointManager`` restores it, ``convert`` carries the parameters
    and the AdamW state across into a port checkpoint, and the port's
    Trainer resumes from it for 2 more steps: its losses are the JAX
    Trainer's own continuation's within 1e-5."""
    ref_cfg, cfg = _cfgs("chatglm3-6b")
    ref, _ = _trainers("chatglm3-6b", tmp_path, steps=4, total=6)
    first = ref.run()
    mgr = ref_ckpt.CheckpointManager(ref_ckpt.CheckpointConfig(str(tmp_path / "ref")))
    (ref_params, ref_state), step, _ = mgr.restore((first["params"], first["opt_state"]))
    assert step == 4
    params = ParamTree.from_state_dict(
        model_params_from_reference(cfg, jax.tree.map(np.asarray, ref_params)))
    state = opt_state_from_reference(cfg, jax.tree.map(np.asarray, ref_state))
    assert int(state.step) == 4
    CheckpointManager(CheckpointConfig(str(tmp_path / "port"), async_write=False)).save(
        4, (params, state))
    ref2, port = _trainers("chatglm3-6b", tmp_path, steps=6)
    want, got = ref2.run(), port.run()
    assert [s for s, _ in _losses(got)] == [4, 5]
    _assert_losses_close(_losses(got), _losses(want))


def test_train_checkpoint_serve_roundtrip(tmp_path):
    """A model trained by the Trainer serves tokens through the engine from
    the restored checkpoint — the full lifecycle (the port of
    tests/test_system.py's), the same tokens as from the trained tree."""
    _, cfg = _cfgs("chatglm3-6b")
    steps = 4
    trainer = Trainer(
        model_cfg=cfg,
        data_cfg=DataConfig(global_batch=2, seq_len=16),
        opt_cfg=OptimizerConfig(lr=1e-3, total_steps=steps, warmup_steps=1),
        trainer_cfg=TrainerConfig(total_steps=steps, ckpt_every=2, log_every=100),
        ckpt_cfg=CheckpointConfig(str(tmp_path), async_write=False),
        device="cpu",
    )
    out = trainer.run()
    model = build_model(cfg)
    fresh = model.init(torch.Generator().manual_seed(1), "cpu")
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path)))
    (params, _), step, _ = mgr.restore((fresh, opt.init_opt_state(fresh)))
    assert step == steps
    out["params"].requires_grad_(False)
    served, logits = [], []
    for tree in (params, out["params"]):
        eng = ServeEngine(cfg, EngineConfig(batch_size=2, max_len=24), params=tree, device="cpu")
        reqs = [Request(prompt=np.arange(8, dtype=np.int32) % cfg.vocab, max_new_tokens=4)
                for _ in range(2)]
        served.append([r.generated for r in eng.generate(reqs)])
        with torch.inference_mode():
            logits.append(model.prefill(tree, {"tokens": torch.arange(8)[None] % cfg.vocab})[0])
    assert all(len(g) == 4 for g in served[0])
    assert all(0 <= t < cfg.vocab for g in served[0] for t in g)
    assert served[0] == served[1]
    assert torch.equal(logits[0], logits[1])


def test_cli_restarts_and_resumes(tmp_path, capsys):
    out = launch_train.main(["--arch", "chatglm3-6b", "--reduced", "--steps", "6", "--batch", "2",
                             "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                             "--fail-at", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "[train] chatglm3-6b on cpu"
    assert any("injected node failure at step 3" in l and "restarting from latest checkpoint" in l
               for l in lines)
    assert "[trainer] resumed from step 2" in lines
    assert lines[-2].startswith("final: {") and "'loss'" in lines[-2]
    assert lines[-1] == "DP gradient all-reduce algorithm chosen by PCCL: none"
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 2, 3, 4, 5]
    assert CheckpointManager(CheckpointConfig(str(tmp_path))).latest_step() == 6


def _example():
    spec = importlib.util.spec_from_file_location("fault_tolerant_training_torch", EXAMPLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_example_survives_two_failures(capsys):
    out = _example().main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "[trainer] resumed from step 6" in text and "[trainer] resumed from step 12" in text
    assert "survived 2 injected failures" in text
    steps = [h["step"] for h in out["history"]]
    assert steps.count(6) == 2 and steps.count(12) == 2 and steps[-1] == 23
    assert np.isfinite(out["final_metrics"]["loss"])


def test_example_imports_no_jax_and_no_repro():
    tree = ast.parse(EXAMPLE.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert names and not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "repro")]
