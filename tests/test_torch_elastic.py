"""The elastic re-mesh and the sharded ``Trainer`` on processes, on the CPU.

* ``tests/elastic_check.py`` on 8 gloo processes: a ``(4, 2)`` mesh loses
  data slice 2, ``shrink_mesh`` gives ``(3, 2)``, ``reshard_tree`` keeps
  every value exactly (``w``'s 8 rows do not split 3 ways, so they
  replicate; its ``"model"`` split stays) and a step runs on the
  survivors.
* A reduced Whisper (2 encoder and 2 decoder layers) through the port's
  ``Trainer`` on a ``("data", "model") = (2, 2)`` mesh of 4 gloo
  processes: its losses within 1e-4 of the one-process port ``Trainer``
  and of the JAX ``Trainer`` on a 4-device XLA host mesh with the same
  initial weights; and through a failure injected at step 3, equal to the
  uninterrupted run within 1e-6 (the smoke's replay tolerance, path 9).

The JAX oracle runs in a subprocess of this file (``python
tests/test_torch_elastic.py --oracle``), which sets ``XLA_FLAGS`` before it
imports JAX; it starts first and is read last, so it runs while the
spawns do.
"""

import os
import sys

if __name__ == "__main__" and "--oracle" in sys.argv:
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               + os.environ.get("XLA_FLAGS", ""))

import dataclasses
import json
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs
from repro_torch.data import DataConfig
from repro_torch.launch import procs
from repro_torch.models import build_model
from repro_torch.sharding import default_rules
from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-4     # the sharded step against each oracle: fp32 sums in other orders
REPLAY_TOL = 1e-6   # a restart against the uninterrupted run (path 9's)
STEPS, FAIL_AT = 6, 3
TIMEOUT_S = 240.0


def _cfg(pkg_configs):
    cfg = pkg_configs.get_config("whisper-small").reduced()
    return dataclasses.replace(cfg, n_layers=2)


def _settings():
    """(data, optimizer, trainer) config keyword arguments, the same in
    both packages."""
    return (dict(global_batch=4, seq_len=16),
            dict(lr=1e-3, total_steps=STEPS, warmup_steps=1),
            dict(total_steps=STEPS, ckpt_every=2, log_every=100))


def _port_args():
    data, opt, tc = _settings()
    return (_cfg(configs), DataConfig(**data), OptimizerConfig(**opt), TrainerConfig(**tc))


# ------------------------------------------------------------ the JAX oracle


def oracle() -> None:
    """The JAX ``Trainer`` on a (2, 2) host mesh, from the port's initial
    weights; prints its losses as one JSON line."""
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro import configs as ref_configs
    from repro.data import pipeline as ref_pipeline
    from repro.models.module import axes_of
    from repro.sharding import partition as ref_partition
    from repro.train import optimizer as ref_opt
    from repro.train import trainer as ref_trainer

    assert jax.device_count() == 4, jax.devices()
    init = build_model(_cfg(configs)).init(torch.Generator().manual_seed(0), "cpu").state_dict()
    flat = {k: v.numpy() for k, v in init.items()}

    class RefTrainer(ref_trainer.Trainer):
        def _init_state(self):
            params = _nest({k: jnp.asarray(v) for k, v in flat.items()})
            boxed = jax.eval_shape(self.model.init, jax.random.PRNGKey(0))
            shardings = ref_partition.param_sharding(axes_of(boxed), self.mesh, self.rules,
                                                     shapes_tree=params)
            params = jax.tree.map(jax.device_put, params, shardings)
            return params, ref_opt.init_opt_state(params)

    data, opt, tc = _settings()
    mesh = compat.make_mesh((2, 2), ("data", "model"))
    out = RefTrainer(_cfg(ref_configs), ref_pipeline.DataConfig(**data),
                     ref_opt.OptimizerConfig(**opt), ref_trainer.TrainerConfig(**tc),
                     mesh=mesh, rules=ref_partition.default_rules()).run()
    print(json.dumps([h["loss"] for h in out["history"]]))


def _nest(flat):
    """The reference's nested dicts (lists where the keys are 0 … n-1)."""
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


@pytest.fixture(scope="module")
def jax_losses():
    """Started at once, read when a test first needs it."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--oracle"],
                            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    got = {}

    def read():
        if "losses" not in got:
            try:
                out, err = proc.communicate(timeout=TIMEOUT_S)
            finally:
                proc.kill()
            assert proc.returncode == 0, err[-3000:]
            got["losses"] = json.loads(out.strip().splitlines()[-1])
        return got["losses"]

    yield read
    proc.kill()
    proc.communicate()


# -------------------------------------------------------------- the spawns


@pytest.fixture(scope="module")
def sharded(tmp_path_factory, jax_losses):
    """The port's ``Trainer`` on (2, 2): uninterrupted, and with a failure
    at step 3 and checkpoints every 2 steps (then the elastic shrink)."""
    runs = {}
    for name, kw in (("plain", {}), ("failed", dict(fail_at=(FAIL_AT,), shrink=True))):
        d = tmp_path_factory.mktemp(name)
        if kw:
            kw["ckpt_dir"] = str(d / "ckpt")
        runs[name] = procs.spawn(procs.trainer_program, 4, _port_args(),
                                 dict(mesh_shape=(2, 2), rules=default_rules(), device="cpu", **kw),
                                 store_dir=str(d), timeout_s=TIMEOUT_S)
    return runs


@pytest.fixture(scope="module")
def one_process():
    out = Trainer(*_port_args(), device="cpu").run()
    return [h["loss"] for h in out["history"]]


def test_elastic_shrink_and_reshard_on_eight_processes(tmp_path):
    results = procs.spawn(procs.elastic_program, 8, ("cpu",), store_dir=str(tmp_path),
                          timeout_s=TIMEOUT_S)
    failed = [r for r in results if r["failed"]]
    survivors = [r for r in results if not r["failed"]]
    assert len(failed) == 2 and len(survivors) == 6  # data slice 2: ranks 4 and 5
    for r in results:
        assert r["shape"] == {"data": 3, "model": 2}
    for r in survivors:
        # values preserved exactly
        np.testing.assert_array_equal(r["w"], np.arange(64.0).reshape(8, 8))
        # w: 8 rows % 3 data shards != 0 → fit-or-drop replicates rows, keeps model
        assert r["w_split"] == [None, 1]
        # training continues on the shrunk mesh
        np.testing.assert_array_equal(r["b_stepped"], 2 * np.ones((4, 8)))


def test_sharded_trainer_matches_the_one_process_trainer(sharded, one_process):
    for rank in sharded["plain"]:
        assert rank["steps"] == list(range(STEPS))
        np.testing.assert_allclose(rank["losses"], one_process, rtol=0, atol=LOSS_TOL)


def test_sharded_trainer_matches_the_jax_trainer_on_a_host_mesh(sharded, jax_losses):
    want = jax_losses()
    assert len(want) == STEPS
    np.testing.assert_allclose(sharded["plain"][0]["losses"], want, rtol=0, atol=LOSS_TOL)


def test_every_rank_restarts_from_the_checkpoint_and_replays(sharded):
    plain = sharded["plain"][0]["losses"]
    for rank in sharded["failed"]:
        # the failure at step 3 restarts from the step-2 checkpoint: step 2 replays
        assert rank["steps"] == [0, 1, 2, 2, 3, 4, 5]
        assert rank["ckpt_steps"] == [2, 4, 6]
        by_step = dict(zip(rank["steps"], rank["losses"]))
        np.testing.assert_allclose([by_step[s] for s in range(STEPS)], plain, rtol=0,
                                   atol=REPLAY_TOL)
        np.testing.assert_allclose(rank["losses"][3], rank["losses"][2], rtol=0, atol=REPLAY_TOL)


def test_the_trainer_state_reshards_exactly_onto_the_survivors(sharded):
    runs = sharded["failed"]
    failed = [r for r in runs if r["failed"]]
    survivors = [r for r in runs if not r["failed"]]
    assert len(failed) == 2 and len(survivors) == 2  # data slice 1: ranks 2 and 3
    for r in runs:
        assert tuple(r["shrunk_shape"]) == (1, 2)
    for r in survivors:
        assert r["reshard_exact"] is True
        assert np.isfinite(r["survivor_loss"])
    assert survivors[0]["survivor_loss"] == survivors[1]["survivor_loss"]


if __name__ == "__main__" and "--oracle" in sys.argv:
    oracle()
