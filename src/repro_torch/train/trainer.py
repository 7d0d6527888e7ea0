"""Trainer: the fault-tolerant training loop (``repro.train.trainer``).

* the train step (:func:`~repro_torch.train.train_step.make_train_step`:
  microbatched, parameters and AdamW moments updated in place), batches
  from the deterministic pipeline put on the trainer's device;
* periodic async checkpoints; auto-resume from the newest committed step;
* survive injected node failures by checkpoint-restart (the outer loop
  catches, restores, and replays the deterministic data stream);
* straggler detection hooks recording per-step times;
* PCCL integration point: a :class:`repro_torch.api.PcclSession` owned by
  the trainer plans the data-parallel gradient all-reduce (paper §2.2),
  cold and then warm on the threaded fabric, and reports both costs — a
  price on the fabric model, not a time on the card;
* DP × TP step pricing: given a ``torch.distributed`` device mesh with
  "data" and "model" axes (``mesh=``, ``rules=``), the TP activation
  all-reduces and the DP gradient all-reduce are priced *together*, as the
  fabric arbiter's joint plan (``concurrent_step_cost``).

It runs on one device per process, CUDA unless the caller passes
``device="cpu"``.  Under a one-rank mesh a run installs the mesh and rules
(:func:`repro_torch.sharding.use_partitioning`), which leaves every tensor
where it is.  On a mesh of several ranks (one process each, a live
``torch.distributed`` world) the step is sharded: parameters and AdamW's
moments are DTensors placed by :func:`~repro_torch.sharding.partition.param_sharding`,
every rank draws the same initial weights from the seed and keeps its
part, the batch is split over ``"data"`` as the rules say, and the step
runs under ``use_partitioning``; DTensor issues the collectives (the
reference's "on the pjit path XLA emits the collectives").  Checkpoints
keep the reference's layout: rank 0 writes whole tensors, every rank
restores its part, and an injected failure, which every rank meets at
the same step, restarts them all from the newest checkpoint.
"""

from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.api import ConcurrentCollectiveRequest, PcclSession
from repro_torch.ckpt.checkpoint import CheckpointConfig, CheckpointManager
from repro_torch.comm import exec_engine
from repro_torch.configs.base import ModelConfig
from repro_torch.core import cost_model as cm
from repro_torch.data.pipeline import DataConfig, SyntheticLMData, to_device
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.module import axes_of, param_count, shapes_of
from repro_torch.runtime.fault import (
    FailureInjector,
    InjectedFailure,
    StragglerConfig,
    StragglerDetector,
)
from repro_torch.sharding import partition

from .optimizer import OptimizerConfig, init_opt_state
from .train_step import make_train_step


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    microbatches: int = 1
    seed: int = 0
    max_restarts: int = 8
    # Relative-error tolerance the job accepts on the DP gradient
    # all-reduce (see repro_torch.core.cost_model.compressed_ef_error_bound):
    # when set, PCCL's auto arbitration may plan the int8-on-the-wire
    # ring_ef8 algorithm (bytes/4 wire time) for the gradient collective.
    # None (default) keeps the gradient sum exact.
    grad_allreduce_rel_error_tol: Optional[float] = None


class Trainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        data_cfg: DataConfig,
        opt_cfg: OptimizerConfig,
        trainer_cfg: TrainerConfig,
        ckpt_cfg: Optional[CheckpointConfig] = None,
        mesh=None,
        rules=None,
        failure_injector: Optional[FailureInjector] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.cfg = model_cfg
        self.data_cfg = data_cfg
        self.opt_cfg = opt_cfg
        self.tcfg = trainer_cfg
        self.mesh = mesh
        self.rules = rules
        self.device = resolve_device(device)
        self.model = build_model(model_cfg)
        self.data = SyntheticLMData(model_cfg, data_cfg)
        self.sharded = mesh is not None and math.prod(mesh.shape) > 1
        group = dist.group.WORLD if self.sharded and ckpt_cfg else None
        self.ckpt = CheckpointManager(ckpt_cfg, group) if ckpt_cfg else None
        self.injector = failure_injector or FailureInjector()
        self.straggler = StragglerDetector(StragglerConfig(), data_cfg.n_hosts)
        self.metrics_log: list = []

        # PCCL planning for the DP gradient all-reduce (paper integration):
        # one session per trainer; warm-plan (cold + threaded re-plan) gives
        # the steady-state per-step cost the job will actually pay.
        n_dp = data_cfg.n_hosts if mesh is None else _axis_size(mesh, "data")
        n_tp = 1 if mesh is None else _axis_size(mesh, "model")
        grad_bytes = 4.0 * param_count(self.model.specs())
        self.pccl = PcclSession(cm.TPU_V5E_PHOTONIC, device=self.device)
        if n_dp >= 2:
            tol = trainer_cfg.grad_allreduce_rel_error_tol
            cold = self.pccl.plan(
                "all_reduce", grad_bytes, n=n_dp, algorithm="auto",
                rel_error_tol=tol,
            )
            warm = self.pccl.plan(
                "all_reduce", grad_bytes, n=n_dp, algorithm="auto",
                rel_error_tol=tol,
            )
            self.grad_allreduce_algorithm = warm.algorithm
            self.grad_allreduce_cost_s = {"cold": cold.cost, "steady": warm.cost}
        else:
            self.grad_allreduce_algorithm = "none"
            self.grad_allreduce_cost_s = {"cold": 0.0, "steady": 0.0}
        # DP×TP step pricing: on a 2-D mesh the TP activation all-reduces and
        # the DP gradient all-reduce are in flight *together*, so the step
        # cost is the fabric arbiter's joint plan (TP rows ∥ DP columns), not
        # the sum of two fabric-to-itself plans.
        self.concurrent_step_cost = None
        if n_dp >= 2 and n_tp >= 2:
            from repro_torch.core.schedules import mesh_groups

            n_mesh = n_dp * n_tp
            tp_groups, dp_groups = mesh_groups(n_tp, n_dp)
            # per-group buffer sizes as the mesh actually shards them: each
            # TP group all-reduces its own DP shard of the batch activation,
            # and each DP rank reduces its 1/n_tp TP slice of the gradients
            act_bytes = (
                4.0 * (data_cfg.global_batch / n_dp)
                * data_cfg.seq_len * model_cfg.d_model
            )
            dp_grad_bytes = grad_bytes / n_tp
            cp = self.pccl.plan_concurrent(
                [
                    ConcurrentCollectiveRequest(
                        "all_reduce", act_bytes, groups=tp_groups, algorithm="auto"
                    ),
                    ConcurrentCollectiveRequest(
                        "all_reduce", dp_grad_bytes, groups=dp_groups, algorithm="auto"
                    ),
                ],
                n=n_mesh,
            )
            self.concurrent_step_cost = {
                "joint": cp.cost,
                "sequential": cp.sequential_cost,
                "speedup": cp.speedup,
                "serialized": cp.serialized,
                "algorithms": cp.algorithms,
            }

        self._step_fn = None
        self._shardings = None
        self.resumed_from: list = []  # the checkpoint step each restart resumed from

    # ------------------------------------------------------------- plumbing
    def _build(self):
        self._step_fn = make_train_step(self.model, self.opt_cfg, microbatches=self.tcfg.microbatches)

    def _init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = self.model.init(gen, self.device)
        if self.mesh is not None and self.rules is not None:
            # a one-rank mesh: every placement leaves the whole tensor here
            specs = self.model.specs()
            self._shardings = partition.param_sharding(
                axes_of(specs), self.mesh, self.rules, shapes_tree=shapes_of(specs)
            )
            if self.sharded:
                _place(params, self._shardings, self.mesh)
        return params, init_opt_state(params)

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The step's global batch; on a sharded mesh each rank keeps its
        rows of it (every rank reads the same deterministic batch)."""
        batch = to_device(self.data.global_batch(step), self.device)
        if not self.sharded:
            return batch
        out = {}
        with partition.use_partitioning(self.mesh, self.rules):
            for k, v in batch.items():
                spec = partition.spec_for(("batch",) + (None,) * (v.ndim - 1), tuple(v.shape))
                place = partition.placements(spec, v.ndim, self.mesh)
                out[k] = distribute_tensor(v, self.mesh, place, src_data_rank=None)
        return out

    # ----------------------------------------------------------------- run
    def run(self) -> Dict[str, Any]:
        if self.sharded:
            _check_live(self.mesh, self.rules)
        self._build()
        restarts = 0
        while True:
            try:
                return self._run_once()
            except InjectedFailure as e:
                # the failed attempt's state went with its frame: nothing
                # here holds it while the next attempt builds its own
                restarts += 1
                if restarts > self.tcfg.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                print(f"[trainer] {e} — restarting from latest checkpoint "
                      f"(restart {restarts}/{self.tcfg.max_restarts})")
                continue

    def _run_once(self) -> Dict[str, Any]:
        ctx = (
            partition.use_partitioning(self.mesh, self.rules)
            if self.mesh is not None and self.rules is not None
            else contextlib.nullcontext()
        )
        # plain tensors made inside the step (positions, masks, the step
        # count) meet DTensors as replicated values
        dense = implicit_replication() if self.sharded else contextlib.nullcontext()
        with ctx, dense, self._wire():
            return self._run_steps()

    def _wire(self):
        """DTensor's collectives of CUDA tensors over a gloo mesh take the
        ``gloo-staged`` route (host copies; gloo's own CUDA path is not
        taken); NCCL and CPU tensors go as they are."""
        if (self.sharded and self.device.type == "cuda"
                and str(dist.get_backend(self.mesh.get_group(0))) == "gloo"):
            return exec_engine.staged_functional_collectives()
        return contextlib.nullcontext()

    def _run_steps(self) -> Dict[str, Any]:
        params, opt_state = self._init_state()
        start_step = 0
        if self.ckpt is not None:
            # a save still being written commits before the newest step is
            # looked up: the reference looks first, and a failure that comes
            # while the writer runs restarts it from scratch
            self.ckpt.wait()
            if self.ckpt.latest_step() is not None:
                (params, opt_state), start_step, extra = self.ckpt.restore((params, opt_state))
                self.resumed_from.append(start_step)
                print(f"[trainer] resumed from step {start_step}")

        last_metrics: Dict[str, float] = {}
        for step in range(start_step, self.tcfg.total_steps):
            self.injector.check(step)  # may raise → checkpoint-restart
            batch = self._batch(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = self._step_fn(params, opt_state, batch)
            # the loss is read after the whole step on the stream: the
            # window ends when the device is done
            last_metrics = {k: _value(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            for h in range(self.data_cfg.n_hosts):
                self.straggler.record(h, dt)  # single-process: same signal
            last_metrics["step_time_s"] = dt
            self.metrics_log.append({"step": step, **last_metrics})
            if step % self.tcfg.log_every == 0:
                print(f"[trainer] step {step} loss={last_metrics['loss']:.4f} "
                      f"({dt*1e3:.0f} ms)")
            if self.ckpt is not None and (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1, (params, opt_state), extra={"loss": last_metrics["loss"]})
        if self.ckpt is not None:
            self.ckpt.save(self.tcfg.total_steps, (params, opt_state),
                           extra={"loss": last_metrics.get("loss")})
            self.ckpt.wait()
        return {
            "params": params,
            "opt_state": opt_state,
            "final_metrics": last_metrics,
            "history": self.metrics_log,
            "grad_allreduce_algorithm": self.grad_allreduce_algorithm,
            "grad_allreduce_cost_s": self.grad_allreduce_cost_s,
            "pccl_concurrent": self.concurrent_step_cost,
            "pccl_cache": self.pccl.stats,
            "pccl_exec": self.pccl.exec_stats(),
            "stragglers": self.straggler.stragglers(),
        }


def _value(t: torch.Tensor) -> float:
    """A 0-dim metric as a float (a DTensor's whole value)."""
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def _check_live(mesh, rules) -> None:
    """A sharded run needs a ``DeviceMesh`` over a world that moves data,
    and rules to place the parameters by."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"Trainer.run on several ranks needs a torch DeviceMesh, got "
                        f"{type(mesh).__name__}")
    if rules is None:
        raise ValueError("Trainer.run on several ranks needs sharding rules (rules=)")
    if str(dist.get_backend(mesh.get_group(0))) == "fake":
        raise RuntimeError(
            "Trainer.run on a fake process group: its collectives move no data, so a "
            "step would train on garbage; the dry run (python -m repro_torch.launch.dryrun) "
            "counts a step on such a group")


def _place(params, shardings, mesh) -> None:
    """Replace every parameter of ``params`` with a DTensor holding this
    rank's part of it, placed as ``shardings`` says (the values every rank
    drew from the same seed, so nothing moves)."""
    for name, p in list(params.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = params.get_submodule(owner) if owner else params
        place = partition.placements(shardings[name].spec, p.ndim, mesh)
        module._parameters[leaf] = nn.Parameter(
            distribute_tensor(p.detach(), mesh, place, src_data_rank=None),
            requires_grad=False)


def _axis_size(mesh, name: str) -> int:
    """Size of the mesh axis ``name`` (1 if the mesh has none)."""
    names = tuple(mesh.mesh_dim_names or ())
    return int(mesh.shape[names.index(name)]) if name in names else 1
