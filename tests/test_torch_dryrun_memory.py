"""The dry run's per-rank memory (``repro_torch.launch.roofline.LiveBytes``
and the ``memory_analysis`` fields of ``repro_torch.launch.dryrun``), on
the CPU, against hand counts, real tensors and the JAX package.

The count holds the bytes of every storage a rank's local tensors make
until the storage dies, and their peak.  Tolerances: a hand count, the
same step on real CPU tensors and the reference's argument bytes are
matched exactly (integer bytes of the same tensors); the depth
extrapolation to 1e-9 relative (a float line through two points).

The reference is compiled in a subprocess with four host devices, as its
own dry run forces them; nothing in ``src/repro`` changes for it.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.models import build_model
from repro_torch.sharding import default_rules
from repro_torch.train import OptimizerConfig, init_opt_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _no_group_left_behind():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(shape):
    D.fake_world(shape[0] * shape[1])
    return D.make_mesh(shape, ("data", "model"), device_type="cpu")


def test_a_storage_counts_once_whatever_its_views_and_drops_when_it_dies():
    live = R.LiveBytes()
    x = torch.empty(4, 8, device="meta")
    live.hold(x)
    live.hold(x.view(32))
    live.hold(x[1:])
    assert live.live == live.peak == 128
    y = torch.empty(2, device="meta")
    live.hold(y)
    del x
    assert live.live == 8 and live.peak == 136
    del y
    assert live.live == 0


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_temp_peak_of_a_two_layer_mlp_step_equals_a_hand_count(device):
    """``y = relu(x @ W1) @ W2``, ``y.backward(gy)``, then an in-place
    update.  Live bytes over the arguments: the forward holds ``x @ W1``
    and its relu (2·B·h) until the first product dies, then the relu (kept
    for its backward) and ``y``; the backward adds ``grad_a`` (B·h) and
    ``W2``'s gradient (h·o), then ``grad_h`` (B·h) while ``grad_a`` and the
    relu are still live: 3·B·h + B·o + h·o, fp32.  The update aliases both
    weights; ``y`` is the one new output."""
    B, d, h, o = 8, 16, 32, 4
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, d, generator=g).to(device)
    W1 = torch.randn(d, h, generator=g).to(device).requires_grad_()
    W2 = torch.randn(h, o, generator=g).to(device).requires_grad_()
    gy = torch.randn(B, o, generator=g).to(device)
    with R.count_step(x, W1, W2, gy) as c:
        y = torch.relu(x @ W1) @ W2
        y.backward(gy)
        with torch.no_grad():
            for w in (W1, W2):
                w.sub_(w.grad, alpha=0.1)
        c.memory.returned((y, W1, W2))
    assert c.memory.analysis() == {
        "argument_size_in_bytes": 4 * (B * d + d * h + h * o + B * o),
        "output_size_in_bytes": 4 * (B * o + d * h + h * o),
        "temp_size_in_bytes": 4 * (3 * B * h + B * o + h * o),
        "alias_size_in_bytes": 4 * (d * h + h * o),
    }


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "olmoe-1b-7b", "chatglm3-6b"])
def test_the_meta_count_equals_the_tracker_on_real_cpu_tensors(arch):
    """The dry run's count of a reduced train step on a one-rank mesh (meta
    DTensors) against the same tracker around the same step on real CPU
    tensors with no mesh: every field equal."""
    cfg = configs.get_config(arch).reduced()
    meta = D.count_cell(cfg, ShapeConfig("t", 32, 2, "train"), _mesh((1, 1)), default_rules())
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    opt = init_opt_state(params)
    batch = {"tokens": torch.zeros(2, 32, dtype=torch.int64)}
    step = make_train_step(model, OptimizerConfig())
    with R.count_step(params, opt, batch) as real:
        real.memory.returned(step(params, opt, batch))
    assert meta.memory.analysis() == real.memory.analysis()
    assert meta.memory.peak == real.memory.peak > meta.memory.argument


def test_depth_extrapolated_memory_equals_a_full_depth_count():
    """As the FLOPs (``test_depth_extrapolation_agrees_with_counting_every_layer``):
    the memory fields through two depths equal the count of every layer.
    The line holds where the peak falls in the same phase of the step at
    both depths; at 64 tokens a row it does from 2 layers on (at 16 the
    2-layer step peaks in its backward pass, the deeper ones in AdamW's
    update)."""
    cfg = dataclasses.replace(configs.get_config("chatglm3-6b").reduced(), n_layers=6)
    shape = ShapeConfig("train_small", 64, 4, "train")
    mesh = _mesh((2, 2))
    full = D.count_full(cfg, shape, mesh, default_rules(), "full")
    points = D.count_full(cfg, shape, mesh, default_rules(), "points")
    assert points["depth"] == {"points": [2, 4], "v_full": 6}
    for k in D.MEMORY_FIELDS + ("peak_bytes",):
        assert points[k] == pytest.approx(full[k], rel=1e-9), k
    assert full["temp_size_in_bytes"] > 0


_REFERENCE = """
import json, sys
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.launch import hlo_analysis as H
from repro.launch.mesh import make_mesh
from repro.launch.specs import batch_specs, param_specs
from repro.models import build_model
from repro.sharding import default_rules, use_partitioning
from repro.train.optimizer import OptimizerConfig, OptState
from repro.train.train_step import make_train_step

cfg = get_config(sys.argv[1]).reduced()
shape = ShapeConfig("t", int(sys.argv[2]), int(sys.argv[3]), "train")
mesh = make_mesh((2, 2), ("data", "model"))
rules = default_rules()
with use_partitioning(mesh, rules):
    p, _ = param_specs(cfg, mesh, rules)
    mu = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, jnp.float32, sharding=x.sharding), p)
    opt = OptState(step=jax.ShapeDtypeStruct((), jnp.int32), mu=mu, nu=mu)
    batch = batch_specs(cfg, shape, mesh, rules)
    step = make_train_step(build_model(cfg), OptimizerConfig())
    compiled = jax.jit(step, donate_argnums=(0, 1)).lower(p, opt, batch).compile()
print("MEMORY " + json.dumps(H.memory_analysis_dict(compiled)))
"""


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "olmoe-1b-7b"])
def test_argument_bytes_equal_the_references_memory_analysis_but_for_the_tokens(arch):
    """A reduced train cell on a 2 × 2 mesh: the port's
    ``argument_size_in_bytes`` against XLA's for the reference's compiled
    step.  The arguments are the same leaves placed the same way, but for
    one: the batch's tokens are int64 in the port
    (``repro_torch/launch/specs.py:63``) and int32 in the reference
    (``repro/launch/specs.py:40``), 4 more bytes for each of a rank's
    tokens; nothing else may differ."""
    S, B = 64, 4
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, arch, str(S), str(B)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = json.loads(next(x for x in proc.stdout.splitlines()
                          if x.startswith("MEMORY "))[len("MEMORY "):])
    cfg = configs.get_config(arch).reduced()
    counted = D.count_full(cfg, ShapeConfig("t", S, B, "train"), _mesh((2, 2)), default_rules(),
                           "full")
    tokens_per_rank = (B // 2) * S       # batch over "data", the sequence whole
    assert counted["argument_size_in_bytes"] - ref["argument_size_in_bytes"] == \
        tokens_per_rank * (8 - 4)


def test_one_rank_roofline_reports_the_peak_and_the_memory_fields():
    cfg = dataclasses.replace(configs.get_config("zamba2-2.7b").reduced(), n_layers=4)
    got = D.one_rank_roofline(cfg, "train", 2, 32, depth="full")
    assert set(D.MEMORY_FIELDS) <= set(got)
    assert got["peak_bytes"] == got["argument_size_in_bytes"] + got["temp_size_in_bytes"]
    assert got["alias_size_in_bytes"] <= got["output_size_in_bytes"]
