"""Logical axes, ``sharding/`` and the ``Trainer``'s DP × TP pricing against
the JAX package, on the CPU.

* every copied config dataclass has the reference's fields, in order, with
  its defaults; ``DataConfig(grains_per_host=…)`` and the ``"xla"`` backend
  name work;
* every parameter's logical axes (the reference's ``Box.axes``) and every
  model's ``decode_state_axes()`` equal the reference's for the 11 configs
  at full size, and so does ``spec_for`` of every parameter and
  decode-state leaf under the reference's rules at the 16 × 16 and
  2 × 16 × 16 meshes (the reference's under a device-free
  ``AbstractMesh``; the port's on a ``DeviceMesh`` over a fake process
  group of 512 ranks, set up and torn down by a module fixture);
* ``shard`` is the identity with no mesh and under a one-rank mesh:
  reduced Zamba2, OLMoE, xLSTM and Whisper give the same bits, and the
  sites a Zamba2 prefill reaches at full depth are the count
  ``chip_smoke.py``'s path 11 holds the card to;
* the ``Trainer``'s gradient plan and joint DP × TP step cost equal the
  reference's at (dp, tp) ∈ {(2, 2), (4, 2), (16, 16)}.

Tolerances: every comparison here is exact (the planner and the rules are
copies; the one-rank runs are the same arithmetic).
"""

import dataclasses
import importlib.util
import inspect
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro import configs as ref_configs
from repro.models import build_model as ref_build_model
from repro.models.module import axes_of as ref_axes_of
from repro.sharding import partition as ref_partition
from repro_torch import configs
from repro_torch.launch.mesh import init_fake_world
from repro_torch.models import build_model
from repro_torch.models.module import axes_of, shapes_of
from repro_torch.sharding import SITES, default_rules, partition, shard, use_partitioning

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(configs.ARCH_IDS) + ["bert-base-paper"]
MESHES = {"single": ((16, 16), ("data", "model"), False),
          "multi": ((2, 16, 16), ("pod", "data", "model"), True)}


@pytest.fixture(scope="module")
def world():
    """A fake process group of 512 ranks for this file's meshes; no other
    test file in the worker sees it."""
    assert not dist.is_initialized()
    init_fake_world(512)
    yield
    dist.destroy_process_group()


def _mesh(shape, names):
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape), mesh_dim_names=names)


def _norm_spec(spec):
    """A reference ``PartitionSpec`` as the port's spec: each entry None or
    a tuple of mesh axes, trailing Nones dropped."""
    parts = [None if p is None else ((p,) if isinstance(p, str) else tuple(p)) for p in spec]
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _is_axes(x):
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(t, (str, type(None))) for t in x)


def _ref_flat_axes(arch):
    model = ref_build_model(ref_configs.get_config(arch))
    boxed = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(ref_axes_of(boxed), is_leaf=_is_axes)[0]
    shapes = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda b: b.value.shape, boxed, is_leaf=lambda b: hasattr(b, "axes")),
        is_leaf=lambda x: isinstance(x, tuple))[0]

    def name(path):
        return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)

    return ({name(p): a for p, a in leaves}, {name(p): tuple(s) for p, s in shapes})


def _tree(x):
    """Named tuples and dicts as nested dicts, for comparing trees."""
    if hasattr(x, "_fields"):
        return {k: _tree(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return x


def _leaves(axes, shapes, prefix=""):
    """(name, axes, shape) of every leaf of a decode-state axes tree and
    the matching tree of shapes."""
    if _is_axes(axes):
        yield prefix, axes, tuple(shapes)
        return
    for k in axes:
        yield from _leaves(axes[k], shapes[k], f"{prefix}{k}.")


# --------------------------------------------------------- Queue 3 repairs

def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            d = f.default
        elif f.default_factory is not dataclasses.MISSING:
            d = f.default_factory()
        else:
            d = "<required>"
        out.append((f.name, d if isinstance(d, (int, float, str, bool, tuple, type(None))) else repr(d)))
    return out


CONFIG_CLASSES = [
    ("data.pipeline", "DataConfig"), ("train.trainer", "TrainerConfig"),
    ("ckpt.checkpoint", "CheckpointConfig"), ("train.optimizer", "OptimizerConfig"),
    ("runtime.fault", "StragglerConfig"), ("serve.engine", "ModelSection"),
    ("serve.engine", "RuntimeSection"), ("serve.engine", "FabricSection"),
    ("configs.base", "ModelConfig"), ("configs.base", "MoEConfig"),
    ("configs.base", "MLAConfig"), ("configs.base", "SSMConfig"),
    ("configs.base", "XLSTMConfig"), ("configs.base", "HybridConfig"),
    ("configs.base", "EncDecConfig"), ("configs.base", "VLMConfig"),
    ("configs.base", "ShapeConfig"),
]


@pytest.mark.parametrize("module,name", CONFIG_CLASSES, ids=[n for _, n in CONFIG_CLASSES])
def test_config_fields_equal_the_references(module, name):
    import importlib

    ref = getattr(importlib.import_module(f"repro.{module}"), name)
    port = getattr(importlib.import_module(f"repro_torch.{module}"), name)
    assert _fields(port) == _fields(ref)


def test_engine_config_signature_equals_the_references():
    from repro.serve.engine import EngineConfig as Ref
    from repro_torch.serve.engine import EngineConfig

    def sig(cls):
        return [(p.name, p.kind, p.default) for p in inspect.signature(cls).parameters.values()]

    assert sig(EngineConfig) == sig(Ref)


def test_grains_per_host_and_the_xla_backend_name():
    from repro_torch.api import PcclSession
    from repro_torch.api.backends import NativeBackend
    from repro_torch.core import cost_model as cm
    from repro_torch.data.pipeline import DataConfig

    assert DataConfig(8, 16, grains_per_host={0: 1}).grains_per_host == {0: 1}
    comm = PcclSession(cm.H100_DGX, device="cpu").communicator("x", 8, backend="xla")
    assert isinstance(comm.backend, NativeBackend)
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    native = PcclSession(cm.H100_DGX, device="cpu").communicator("x", 8, backend="native")
    assert torch.equal(comm.all_reduce(x), native.all_reduce(x))


# ------------------------------------------------------------- logical axes

@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_the_references(arch):
    ref_axes, ref_shapes = _ref_flat_axes(arch)
    specs = build_model(configs.get_config(arch)).specs()
    assert axes_of(specs) == ref_axes
    assert shapes_of(specs) == ref_shapes


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_axes_equal_the_references(arch):
    ref = ref_build_model(ref_configs.get_config(arch)).decode_state_axes()
    port = build_model(configs.get_config(arch)).decode_state_axes()
    assert _tree(port) == _tree(ref)
    # shaped like each init_decode_state tree
    state = build_model(configs.get_config(arch)).init_decode_state(2, 64, device="meta")
    shapes = jax.tree.map(lambda t: tuple(t.shape), _tree(state),
                          is_leaf=lambda t: isinstance(t, torch.Tensor))
    for name, axes, shape in _leaves(_tree(port), shapes):
        assert len(axes) == len(shape), name


def test_param_spec_checks_rank():
    from repro_torch.models.module import ParamSpec, normal_init, stack_init

    with pytest.raises(ValueError, match="rank"):
        normal_init((4, 8), ("embed",))
    spec = stack_init(stack_init({"w": normal_init((4, 8), ("embed", "mlp"))}, 3), 2)["w"]
    assert isinstance(spec, ParamSpec) and spec.full_shape == (2, 3, 4, 8)
    assert spec.full_axes == (None, None, "embed", "mlp")


# ----------------------------------------------------------------- spec_for

def test_spec_for_probes(world):
    mesh = _mesh((16, 16), ("data", "model"))
    with partition._installed(mesh, default_rules()):
        assert partition.spec_for(("embed", "kv_heads"), (2560, 8)) == (("data",),)
        assert partition.spec_for(("batch", "kv_seq"), (1, 32768)) == (None, ("data", "model"))
        assert partition.spec_for((None, None)) == ()
    assert partition.spec_for(("batch",)) == ()  # no rules: replicated


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_equals_the_references(world, arch, mesh_kind):
    shape, names, multi = MESHES[mesh_kind]
    mesh = _mesh(shape, names)
    rules = default_rules(multi_pod=multi)
    ref_mesh = AbstractMesh(shape, names)
    ref_rules = ref_partition.default_rules(multi_pod=multi)
    ref_axes, ref_shapes = _ref_flat_axes(arch)
    model = build_model(configs.get_config(arch))
    specs = model.specs()
    port_shard = partition.param_sharding(axes_of(specs), mesh, rules, shapes_tree=shapes_of(specs))
    n = 0
    for name, axes in axes_of(specs).items():
        shp = ref_shapes[name]
        with ref_partition._installed(ref_mesh, ref_rules):
            want = _norm_spec(ref_partition.spec_for(ref_axes[name], shp))
        with partition._installed(mesh, rules):
            got = partition.spec_for(axes, shp)
        assert got == want, (name, got, want)
        assert port_shard[name].spec == want, name
        partition.placements(got, len(shp), mesh)  # in mesh order
        n += 1
    assert n == len(ref_axes)

    # decode-state leaves at each applicable decode shape
    ref_model = ref_build_model(ref_configs.get_config(arch))
    for sname in ("decode_32k", "long_500k"):
        sh = configs.SHAPES[sname]
        if not configs.shape_applicable(model.cfg, sh)[0]:
            continue
        ref_state = jax.eval_shape(lambda: ref_model.init_decode_state(sh.global_batch, sh.seq_len))
        ref_shapes_tree = jax.tree.map(lambda s: tuple(s.shape), _tree(ref_state))
        state = model.init_decode_state(sh.global_batch, sh.seq_len, device="meta")
        shapes_tree = jax.tree.map(lambda t: tuple(t.shape), _tree(state),
                                   is_leaf=lambda t: isinstance(t, torch.Tensor))
        assert shapes_tree == ref_shapes_tree
        for name, axes, shp in _leaves(_tree(model.decode_state_axes()), shapes_tree):
            with ref_partition._installed(ref_mesh, ref_rules):
                want = _norm_spec(ref_partition.spec_for(axes, shp))
            with partition._installed(mesh, rules):
                got = partition.spec_for(axes, shp)
            assert got == want, (sname, name, got, want)


def test_placements_follow_the_mesh_order(world):
    mesh = _mesh((16, 16), ("data", "model"))
    assert partition.placements((("data", "model"),), 2, mesh) == (Shard(0), Shard(0))
    assert partition.placements((None, ("model",)), 3, mesh) == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="mesh's order"):
        partition.placements((("model", "data"),), 1, mesh)
    rules = default_rules().override(seq=("model",), embed=None)
    assert rules.mesh_axes("seq") == ("model",) and rules.mesh_axes("embed") is None
    assert default_rules(multi_pod=True).mesh_axes("batch") == ("pod", "data")


def test_shard_checks_a_plain_tensor_and_returns_it(world):
    mesh = _mesh((2, 2), ("data", "model"))
    x = torch.zeros(4, 6, 8)
    assert shard(x, ("batch", "seq", "heads")) is x  # no mesh: a no-op
    with use_partitioning(mesh, default_rules()):
        assert shard(x, ("batch", "seq", "heads")) is x
        assert shard(x, ("batch", "seq", "heads", None)) is x  # more axes than dims
        with pytest.raises(ValueError, match="does not split"):
            shard(torch.zeros(3, 6, 8), ("batch", None, None))


# ------------------------------------------- shard is the identity on one rank

SERVE_ARCHS = ["zamba2-2.7b", "olmoe-1b-7b", "xlstm-1.3b", "whisper-small"]


def _serve_steps(cfg, params, tokens, extra):
    model = build_model(cfg)
    out = []
    with torch.inference_mode():
        logits, state = model.prefill(params, {"tokens": tokens, **extra}, max_len=tokens.shape[1] + 4)
        out.append(logits.clone())
        for _ in range(2):
            nxt = logits[:, -1].argmax(-1, keepdim=True).to(tokens.dtype)
            logits, state = model.decode_step(params, state, nxt)
            out.append(logits.clone())
    return out


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_shard_is_the_identity_with_no_mesh_and_on_one_rank(world, arch):
    cfg = configs.get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 12)).astype(np.int64))
    extra = {}
    if cfg.enc_dec:
        extra["enc_frames"] = torch.from_numpy(
            rng.standard_normal((2, cfg.enc_dec.enc_seq, cfg.d_model)).astype(np.float32))
    SITES.reset()
    plain = _serve_steps(cfg, params, tokens, extra)
    assert SITES.total() == 0
    with use_partitioning(_mesh((1, 1), ("data", "model")), default_rules()):
        meshed = _serve_steps(cfg, params, tokens, extra)
    sites = SITES.total()
    print(f"{arch} reduced: {sites} shard sites over a prefill and 2 decode steps")
    assert sites > 0
    for a, b in zip(plain, meshed):
        assert torch.equal(a, b)


def _smoke_constant(name):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name)


def test_zamba2_shard_sites_per_prefill_at_full_depth(world):
    """The sites a served Zamba2 prefill reaches at the published depth (54
    Mamba-2 layers, 9 shared-attention calls), counted as path 11 counts
    them on the card: from the start of ``generate`` to its first decode
    step."""
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    full = configs.get_config("zamba2-2.7b")
    cfg = dataclasses.replace(full.reduced(), n_layers=full.n_layers,
                              hybrid=dataclasses.replace(full.reduced().hybrid,
                                                         shared_attn_every=full.hybrid.shared_attn_every))
    engine = ServeEngine(cfg, EngineConfig(batch_size=4, max_len=24), device="cpu")
    seen = {}
    decode = engine.model.decode_step

    def watched(*args, **kwargs):
        seen.setdefault("at_first_decode", SITES.total())
        return decode(*args, **kwargs)

    engine.model.decode_step = watched
    rng = np.random.default_rng(0)
    with use_partitioning(_mesh((1, 1), ("data", "model")), default_rules()):
        SITES.reset()
        engine.generate([Request(prompt=rng.integers(0, cfg.vocab, size=n).astype(np.int32),
                                 max_new_tokens=4) for n in (16, 12, 8, 4)])
    # 9 groups × (6 Mamba-2 layers × 2 + the shared block's q, k, v, out and
    # MLP) + the embedding and the logits
    assert seen["at_first_decode"] == 9 * (6 * 2 + 5) + 2
    assert seen["at_first_decode"] == _smoke_constant("ZAMBA2_SHARD_SITES_PER_PREFILL")


# ---------------------------------------------------- Trainer DP × TP pricing

@pytest.mark.parametrize("dp,tp", [(2, 2), (4, 2), (16, 16)])
def test_trainer_pricing_equals_the_references(world, dp, tp):
    from repro.data.pipeline import DataConfig as RefData
    from repro.train.optimizer import OptimizerConfig as RefOpt
    from repro.train.trainer import Trainer as RefTrainer, TrainerConfig as RefTC
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig

    arch = "chatglm3-6b"
    ref = RefTrainer(ref_configs.get_config(arch).reduced(), RefData(global_batch=32, seq_len=16),
                     RefOpt(), RefTC(), mesh=AbstractMesh((dp, tp), ("data", "model")),
                     rules=ref_partition.default_rules())
    port = Trainer(configs.get_config(arch).reduced(), DataConfig(global_batch=32, seq_len=16),
                   OptimizerConfig(), TrainerConfig(), mesh=_mesh((dp, tp), ("data", "model")),
                   rules=default_rules(), device="cpu")
    assert port.grad_allreduce_algorithm == ref.grad_allreduce_algorithm
    assert port.grad_allreduce_cost_s == ref.grad_allreduce_cost_s
    assert port.concurrent_step_cost == ref.concurrent_step_cost
    assert port.concurrent_step_cost["joint"] > 0


def test_trainer_runs_on_one_rank_and_refuses_several(world):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig

    cfg = configs.get_config("chatglm3-6b").reduced()
    args = (cfg, DataConfig(global_batch=4, seq_len=16), OptimizerConfig(),
            TrainerConfig(total_steps=2, log_every=10))
    # several ranks of the fake world move no data: the sharded step refuses
    # it (it runs on a live world: tests/test_torch_elastic.py)
    with pytest.raises(RuntimeError, match="fake process group"):
        Trainer(*args, mesh=_mesh((2, 2), ("data", "model")), rules=default_rules(),
                device="cpu").run()
    alone = Trainer(*args, device="cpu").run()
    one = Trainer(*args, mesh=_mesh((1, 1), ("data", "model")), rules=default_rules(),
                  device="cpu")
    meshed = one.run()
    assert [h["loss"] for h in meshed["history"]] == [h["loss"] for h in alone["history"]]
    assert one.concurrent_step_cost is None and meshed["grad_allreduce_algorithm"] == "none"
    assert set(one._shardings) == set(dict(meshed["params"].named_parameters()))
