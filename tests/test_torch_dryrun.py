"""The dry run (``repro_torch.launch.{mesh,specs,roofline,dryrun,perf}``) on
the CPU, against the JAX package and against hand counts.

The dry run's world is a fake process group (``torch.testing._internal.
distributed.fake_pg``, a torch-internal testing module): the first test
pins every torch-internal name the port uses, so a torch upgrade that
moves one fails here.  Tests make the group they need and a module fixture
destroys whatever is left, so no other test file in the worker sees one.

The reference's ``repro.launch.{roofline,dryrun,perf}`` set ``XLA_FLAGS``
when imported; the imports here put the variable back as it was.

Tolerances: FLOPs and bytes are exact (integer counts of the same
operations); the depth extrapolation is held to 1e-9 relative (a float
line through two points); ``pccl_pricing`` and the copied formulas
exactly.
"""

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as ref_configs
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import perf as P
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as SP
from repro_torch.models import build_model
from repro_torch.sharding import default_rules, partition, use_partitioning

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(configs.ARCH_IDS) + ["bert-base-paper"]


@pytest.fixture(scope="module", autouse=True)
def _no_group_left_behind():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def _xla_flags_kept():
    saved = os.environ.get("XLA_FLAGS")
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _ref_launch():
    with _xla_flags_kept():
        import repro.launch.hlo_analysis as rh
        import repro.launch.perf as rp
        import repro.launch.roofline as rr
    return rh, rr, rp


def _mesh22():
    D.fake_world(4)
    return D.make_mesh((2, 2), ("data", "model"), device_type="cpu")


# ------------------------------------------------------ torch internals used

def test_the_torch_internals_the_dry_run_uses_are_where_it_expects_them():
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor import DTensor, placement_types
    from torch.distributed.tensor.experimental import implicit_replication  # noqa: F401
    from torch.distributed.tensor.placement_types import _MaskPartial
    from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: F401
    from torch.utils.flop_counter import flop_registry

    assert callable(placement_types.shard_dim_alltoall)
    assert torch.ops._dtensor.shard_dim_alltoall.default is not None
    assert issubclass(_MaskPartial, Partial)
    assert torch.ops.aten.mm in flop_registry and torch.ops.aten.bmm in flop_registry
    for name in ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
                 "all_to_all_single"):
        op = getattr(torch.ops._c10d_functional, name).default
        args = [a.name for a in op._schema.arguments]
        assert "group_name" in args, (name, args)
    mesh = _mesh22()
    assert dist.get_backend() == "fake" and dist.get_world_size() == 4
    assert _resolve_process_group(mesh.get_group(0).group_name).size() == 2
    x = SP.meta_dtensor((4, 8), torch.float32, ("batch", "mlp"), mesh, default_rules())
    assert isinstance(x, DTensor) and x._local_tensor.device.type == "meta"
    assert x.placements == (Shard(0), Shard(1)) and tuple(x._local_tensor.shape) == (2, 4)


# ------------------------------------------------------- the per-rank rule

def _local_flops(fn, *local):
    with FlopCounterMode(display=False) as fc:
        fn(*local)
    return fc.get_total_flops()


@pytest.mark.parametrize("case", ["matmul", "einsum_sharded_contraction", "replicated"])
def test_per_rank_flops_equal_flop_counter_on_the_local_operands(case):
    """A DTensor op's FLOPs divided by the mesh dimensions its output is
    split on equal FlopCounterMode's count of the op on one rank's own
    operands."""
    from torch.distributed.tensor import DTensor

    mesh = _mesh22()

    def dt(local_shape, place, shape):
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return DTensor.from_local(torch.empty(local_shape, device="meta"), mesh, place,
                                  run_check=False, shape=torch.Size(shape), stride=stride)

    if case == "matmul":
        # x batch-split over data, w column-split over model: out split both ways
        x = dt((4, 32), [Shard(0), Replicate()], (8, 32))
        w = dt((32, 8), [Replicate(), Shard(1)], (32, 16))
        fn, local, want_place = (lambda a, b: a @ b), (torch.empty(4, 32, device="meta"),
                                                       torch.empty(32, 8, device="meta")), (Shard(0), Shard(1))
    elif case == "einsum_sharded_contraction":
        # the contracted dim split over model: each rank sums its half (Partial)
        x = dt((2, 6, 16), [Shard(0), Shard(2)], (4, 6, 32))
        w = dt((16, 8), [Replicate(), Shard(0)], (32, 8))
        fn = lambda a, b: torch.einsum("bsd,dk->bsk", a, b)
        local = (torch.empty(2, 6, 16, device="meta"), torch.empty(16, 8, device="meta"))
        want_place = (Shard(0), Partial())
    else:
        x = dt((8, 32), [Replicate(), Replicate()], (8, 32))
        w = dt((32, 16), [Replicate(), Replicate()], (32, 16))
        fn, local, want_place = (lambda a, b: a @ b), (torch.empty(8, 32, device="meta"),
                                                       torch.empty(32, 16, device="meta")), (Replicate(), Replicate())
    with R.count_step() as c:
        out = fn(x, w)
    assert tuple(out.placements) == want_place
    assert c.stats.total_count == 0  # no operand moved
    assert c.flops == _local_flops(fn, *local)


# ----------------------------------------------------- copies of the reference

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_active_params_and_slstm_correction_equal_the_references(arch):
    rh, rr, _ = _ref_launch()
    from repro_torch.models.module import param_count

    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    n = param_count(build_model(cfg).specs())
    assert R._active_params(cfg, n) == rr._active_params(ref_cfg, n)
    for name, shape in configs.SHAPES.items():
        ref_shape = ref_configs.SHAPES[name]
        active = R._active_params(cfg, n)
        assert R.model_flops(cfg, shape, n, active) == rh.model_flops(ref_cfg, ref_shape, n, active)
        assert R._slstm_correction_flops(cfg, shape) == rr._slstm_correction_flops(ref_cfg, ref_shape)
    points, v_full = R.depth_points(cfg)
    ref_points, ref_v_full = rr.depth_points(ref_cfg)
    assert v_full == ref_v_full and sorted(points) == sorted(ref_points)
    for v in points:
        a, b = points[v], ref_points[v]
        assert (a.n_layers, a.enc_dec and a.enc_dec.n_enc_layers) == \
            (b.n_layers, b.enc_dec and b.enc_dec.n_enc_layers)


BYTES_CASES = {
    "zamba2_like": ({"all-gather": 3.28e11, "all-reduce": 8.83e10, "all-to-all": 4.83e10,
                     "reduce-scatter": 7.44e11}, 256),
    "moe_multi": ({"all-to-all": 5.2e8, "all-gather": 5.49e10, "collective-permute": 1e6}, 512),
    "small": ({"all-reduce": 4096.0, "reduce-scatter": 0.0}, 8),
    "one_chip": ({"all-reduce": 1e9}, 1),
}


@pytest.mark.parametrize("case", list(BYTES_CASES))
def test_pccl_pricing_equals_the_references(case):
    _, _, rp = _ref_launch()
    by_op, chips = BYTES_CASES[case]
    assert P.pccl_pricing(by_op, chips) == rp.pccl_pricing(by_op, chips)


def test_variants_are_the_references_and_every_knob_exists():
    _, _, rp = _ref_launch()
    assert [(n, a, s, f) for n, a, s, _, f in P.VARIANTS] == \
        [(n, a, s, f) for n, a, s, _, f in rp.VARIANTS]
    for name, arch, shape, transform, _ in P.VARIANTS:
        assert P.missing_knob(arch, transform) == "", name
        if transform is not None:
            assert transform(configs.get_config(arch)) is not None
    assert P.missing_knob("olmoe-1b-7b", P._moe_dispatch("grouped")) == ""
    assert P.missing_knob("chatglm3-6b", P._moe_dispatch("grouped")) != ""  # no MoE


def test_roofline_uses_h100_constants():
    from repro_torch.core import cost_model as cm

    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 1.0 / cm.H100_DGX.beta)
    rl = R.Roofline(flops=989e12 * 4, hbm_bytes=3.35e12, collective_bytes=0.0, chips=4)
    assert rl.compute_s == 1.0 and rl.memory_s == 0.25 and rl.dominant == "compute"


# ------------------------------------------------------------ hand counts

def _dense_two_layers():
    return dataclasses.replace(configs.get_config("mistral-large-123b").reduced(), n_layers=2,
                               n_kv_heads=4, dtype="bfloat16")


def test_two_layer_dense_prefill_flops_per_rank_equal_a_hand_count():
    """Every matmul of a 2-layer dense prefill on a 2 × 2 mesh has its
    output split 4 ways (batch over data; heads, mlp or vocab over model),
    so one rank does a quarter of the global matmul FLOPs."""
    cfg = _dense_two_layers()
    B, S, d, H, K, Dh, F, V = 4, 16, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim, cfg.d_ff, cfg.vocab
    T = B * S
    per_layer = (
        2 * T * d * (H * Dh + 2 * K * Dh)     # q, k, v projections
        + 2 * (2 * B * H * S * S * Dh)        # scores and probs · v
        + 2 * T * H * Dh * d                  # output projection
        + 3 * 2 * T * d * F                   # SwiGLU gate, up, down
    )
    logits = 2 * B * 1 * d * V                # the last position only
    want = (cfg.n_layers * per_layer + logits) / 4
    c = D.count_cell(cfg, ShapeConfig("hand", S, B, "prefill"), _mesh22(), default_rules())
    assert c.flops == want == 2785280.0
    assert c.fallbacks == 0


def test_mlp_block_collectives_equal_a_hand_count():
    """The FSDP MLP on a 2 × 2 mesh: each of its three weights is split
    over data on ``embed`` and over model on ``mlp``; the matmuls gather
    each over the data axis (groups of 2), a result of d·F/2 fp32 values,
    of which a rank receives half: 3 all-gathers of d·F/2·4/2 bytes."""
    from repro_torch.models.layers import apply_mlp
    from torch.distributed.tensor.experimental import implicit_replication

    mesh, rules = _mesh22(), default_rules()
    B, S, d, F = 4, 16, 64, 128
    with use_partitioning(mesh, rules), implicit_replication():
        x = SP.meta_dtensor((B, S, d), torch.float32, ("batch", "seq", "act_embed"), mesh, rules)
        p = {"wi_gate": SP.meta_dtensor((d, F), torch.float32, ("embed", "mlp"), mesh, rules),
             "wi_up": SP.meta_dtensor((d, F), torch.float32, ("embed", "mlp"), mesh, rules),
             "wo": SP.meta_dtensor((F, d), torch.float32, ("mlp", "embed"), mesh, rules)}
        with R.count_step() as c:
            y = apply_mlp(p, x, mlp_type="swiglu")
    result = d * (F // 2) * 4
    assert c.stats.count_by_op == {"all-gather": 3}
    assert c.stats.bytes_by_op == {"all-gather": 3 * result // 2}
    assert c.flops == 3 * 2 * B * S * d * F / 4
    assert tuple(y.placements) == (Shard(0), Partial())  # summed where the residual adds


def test_depth_extrapolation_agrees_with_counting_every_layer():
    cfg = dataclasses.replace(configs.get_config("chatglm3-6b").reduced(), n_layers=6)
    shape = ShapeConfig("train_small", 16, 4, "train")
    mesh = _mesh22()
    full = D.count_full(cfg, shape, mesh, default_rules(), "full")
    points = D.count_full(cfg, shape, mesh, default_rules(), "points")
    assert points["depth"] == {"points": [2, 4], "v_full": 6} and full["depth"] == {"full": 6}
    assert points["flops"] == pytest.approx(full["flops"], rel=1e-9)
    assert points["hbm_bytes"] == pytest.approx(full["hbm_bytes"], rel=1e-9)
    assert set(points["bytes_by_op"]) == set(full["bytes_by_op"])
    for op, b in full["bytes_by_op"].items():
        assert points["bytes_by_op"][op] == pytest.approx(b, rel=1e-9), op


def test_one_rank_roofline_equals_flop_counter_on_the_plain_model():
    """On one rank every tensor is whole: the count equals FlopCounterMode's
    over the plain model's prefill on meta tensors."""
    from repro_torch.models.module import ParamSpec, ParamTree, children

    cfg = dataclasses.replace(configs.get_config("zamba2-2.7b").reduced(), n_layers=4)
    got = D.one_rank_roofline(cfg, "prefill", 2, 32, max_len=40, depth="full")
    model = build_model(cfg)

    def meta(node):
        if isinstance(node, ParamSpec):
            return torch.empty(node.full_shape, device="meta")
        if isinstance(node, list):
            return [meta(v) for _, v in children(node)]
        return {k: meta(v) for k, v in node.items()}

    params = ParamTree(meta(model.specs()))
    tokens = torch.zeros(2, 32, dtype=torch.int64, device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model.prefill(params, {"tokens": tokens}, max_len=40)
    assert got["flops"] == fc.get_total_flops()
    assert got["compute_s"] == got["flops"] / R.PEAK_FLOPS
    assert got["memory_s"] == got["hbm_bytes"] / R.HBM_BW


# ------------------------------------------------------ specs, memory, CLI

def test_specs_are_placed_meta_dtensors():
    D.fake_world(256)
    mesh = D.make_production_mesh(device_type="cpu")
    rules = default_rules()
    cfg = configs.get_config("zamba2-2.7b")
    params, shardings = SP.param_specs(cfg, mesh, rules)
    for name, t in params.named_parameters():
        assert t._local_tensor.device.type == "meta"
        assert tuple(t.placements) == partition.placements(shardings[name].spec, t.ndim, mesh)
    assert tuple(params["embed"].shape) == (32000, 2560)
    assert tuple(params["embed"]._local_tensor.shape) == (2000, 160)  # vocab/16, embed/16
    batch = SP.batch_specs(cfg, configs.SHAPES["train_4k"], mesh, rules)
    assert tuple(batch["tokens"]._local_tensor.shape) == (16, 4096)
    tokens, state = SP.decode_specs(cfg, configs.SHAPES["long_500k"], mesh, rules)
    # batch 1: the cache length takes both axes
    assert tuple(state["attn"].k.placements) == (Shard(2), Shard(2))
    assert state["attn"].k._local_tensor.shape[2] == 524288 // 256


def test_memory_per_rank_follows_the_placements():
    """The placement breakdown beside the count's ``memory_analysis``
    fields, whose arguments and temporaries decide ``fits``."""
    D.fake_world(256)
    mesh = D.make_production_mesh(device_type="cpu")
    rules = default_rules()
    cfg = configs.get_config("zamba2-2.7b")
    counted = {"argument_size_in_bytes": 3e9, "output_size_in_bytes": 2e9,
               "temp_size_in_bytes": 78e9, "alias_size_in_bytes": 1e9}
    mem = D.memory_per_rank(cfg, configs.SHAPES["train_4k"], mesh, rules, counted)
    model = build_model(cfg)
    from repro_torch.models.module import axes_of, shapes_of

    shapes, axes = shapes_of(model.specs()), axes_of(model.specs())
    params = 4 * sum(SP.local_numel(shapes[k], axes[k], mesh, rules) for k in shapes)
    assert mem["params"] == params and mem["grads"] == params and mem["adam_moments"] == 2 * params
    assert {k: mem[k] for k in D.MEMORY_FIELDS} == counted
    assert mem["total"] == 81e9 and not mem["fits"] and "activations" not in mem
    assert D.memory_per_rank(cfg, configs.SHAPES["train_4k"], mesh, rules,
                             dict(counted, temp_size_in_bytes=77e9))["fits"]
    dec = D.memory_per_rank(cfg, configs.SHAPES["decode_32k"], mesh, rules, counted)
    assert dec["decode_state"] > 0 and "adam_moments" not in dec


def test_list_names_every_cell(capsys):
    assert D.main(["--list", "--arch", "chatglm3-6b"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(configs.SHAPES) and "SKIP" in lines[-1]


def test_the_cli_counts_zamba2_train_4k_on_256_ranks(tmp_path):
    """The acceptance cell, in a fresh process on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "zamba2-2.7b",
         "--shape", "train_4k", "--mesh", "single", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "device memory allocated: 0 bytes" in proc.stdout
    rec = json.loads((tmp_path / "zamba2-2.7b__train_4k__single.json").read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["depth"] == {"points": [1, 2], "v_full": 9}
    assert rec["per_rank"]["flops"] > rec["model_flops"] / 256  # remat recomputes the forward
    assert set(rec["collectives"]["bytes_by_op"]) <= set(R.COLLECTIVE_OPS)
    assert rec["fallbacks"]["count"] == 0
    mem = rec["memory_per_rank"]
    # the arguments: parameters and AdamW's moments, the step count (int32)
    # and a rank's 16 × 4096 int64 tokens
    assert mem["argument_size_in_bytes"] == mem["params"] + mem["adam_moments"] + 4 + 16 * 4096 * 8
    assert mem["alias_size_in_bytes"] == mem["params"] + mem["adam_moments"]
    assert mem["temp_size_in_bytes"] > mem["grads"]
    assert mem["total"] == mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert mem["fits"] == (mem["total"] <= D.CARD_BYTES)
    assert rec["pccl_pricing"]["speedup"] > 0


def test_an_op_with_no_rule_runs_on_whole_tensors():
    """The last resort of the count: gathered inputs, the op on the whole
    local tensors, a replicated result (an in-place op: the DTensor it was
    given)."""
    mesh = _mesh22()
    rules = default_rules()
    x = SP.meta_dtensor((4, 8), torch.float32, ("batch", "mlp"), mesh, rules)
    w = SP.meta_dtensor((8, 6), torch.float32, ("mlp", None), mesh, rules)
    whole = [Replicate(), Replicate()]
    args = (x.redistribute(mesh, whole), w.redistribute(mesh, whole))
    out = R._on_whole_tensors(torch.ops.aten.mm.default, (x, w), args, {})
    assert tuple(out.placements) == tuple(whole) and tuple(out.shape) == (4, 6)
    assert tuple(out._local_tensor.shape) == (4, 6)
    same = R._on_whole_tensors(torch.ops.aten.add_.Tensor, (x, x), (args[0], args[0]), {})
    assert same is x
