"""Serving engine: batched prefill + decode with KV cache / recurrent state.

A port of ``repro.serve.engine``.  Requests are admitted into a fixed-size
batch, left-padded to the longest prompt, prefilled together, then decoded
step by step, greedily.  Prefill and decode run under
``torch.inference_mode()`` on the engine's device (CUDA unless the caller
passes ``device="cpu"``); with ``cfg.use_pallas`` the prefill's attention
and SSD scan run the hand-written kernels K3 and K4.  The modality
frontends are stubs, as in the reference: a VLM's prefill takes zero image
embeddings, which sit before the prompt and take KV slots of their own;
an encoder–decoder's takes zero encoder frames ``(B, enc_seq, d_model)``,
which its encoder reads and which take no KV slot (their keys and values
sit in the cross state).

With ``EngineConfig.tp > 1`` the engine also accounts for the
tensor-parallel activation all-reduces through the port's PCCL session
(``sim`` backend: the planner prices each collective, no data moves) —
``engine.comm_report()`` returns the planned communication time and
algorithm, and with ``dp > 1`` replicas also the fabric arbiter's joint
pricing of prefill-TP with decode-DP (``concurrent_report``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.api import PcclSession
from repro_torch.configs.base import ModelConfig
from repro_torch.core import cost_model as cm
from repro_torch.device import resolve_device
from repro_torch.models import ParamTree, build_model
from repro_torch.serve.arbiter import ArbiterConfig, FabricArbiter


@dataclass
class Request:
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    generated: List[int] = field(default_factory=list)
    done: bool = False


@dataclass(frozen=True)
class ModelSection:
    """Decoding-policy knobs: how tokens are sampled from the model."""

    greedy: bool = True


@dataclass(frozen=True)
class RuntimeSection:
    """Batching/KV-cache shape: how many sequences share the engine."""

    batch_size: int = 4
    max_len: int = 256

    def __post_init__(self) -> None:
        if self.batch_size < 1:
            raise ValueError(
                f"RuntimeSection.batch_size must be >= 1, got {self.batch_size}"
            )
        if self.max_len < 1:
            raise ValueError(
                f"RuntimeSection.max_len must be >= 1, got {self.max_len}"
            )
        if self.batch_size > self.max_len:
            raise ValueError(
                f"RuntimeSection: batch_size={self.batch_size} exceeds the "
                f"max_len={self.max_len} KV slots one sequence owns — the "
                f"engine cannot admit more sequences than slots"
            )


@dataclass(frozen=True)
class FabricSection:
    """Parallelism layout on the shared photonic fabric."""

    tp: int = 1                 # tensor-parallel degree priced via PCCL
    dp: int = 1                 # data-parallel replicas sharing the fabric
    mesh_n: Optional[int] = None  # fabric domain size; defaults to tp·dp

    def __post_init__(self) -> None:
        if self.tp < 1:
            raise ValueError(f"FabricSection.tp must be >= 1, got {self.tp}")
        if self.dp < 1:
            raise ValueError(f"FabricSection.dp must be >= 1, got {self.dp}")
        if self.mesh_n is not None and self.mesh_n != self.tp * self.dp:
            raise ValueError(
                f"FabricSection: tp*dp = {self.tp}*{self.dp} = "
                f"{self.tp * self.dp} does not cover mesh_n={self.mesh_n} "
                f"fabric ranks — fix tp/dp or drop mesh_n"
            )

    @property
    def n(self) -> int:
        """The fabric domain size every plan spans."""
        return self.mesh_n if self.mesh_n is not None else self.tp * self.dp


class EngineConfig:
    """Sectioned engine configuration with construction-time validation.

    Three frozen sections — :class:`ModelSection` (decoding policy),
    :class:`RuntimeSection` (batching/KV shape), :class:`FabricSection`
    (parallelism layout) — each validating its own invariants so a bad
    config raises an attributable ``ValueError`` at construction instead of
    failing deep inside planning.  The historical flat surface is kept
    intact both ways: flat constructor kwargs
    (``EngineConfig(batch_size=2, tp=4)``) build the sections, and flat
    attributes (``cfg.batch_size`` …) read through to them.  Pass whole
    sections for anything beyond the defaults::

        EngineConfig(runtime=RuntimeSection(8, 4096),
                     fabric=FabricSection(tp=8, dp=4, mesh_n=32))
    """

    def __init__(
        self,
        batch_size: Optional[int] = None,
        max_len: Optional[int] = None,
        greedy: Optional[bool] = None,
        tp: Optional[int] = None,
        dp: Optional[int] = None,
        *,
        model: Optional[ModelSection] = None,
        runtime: Optional[RuntimeSection] = None,
        fabric: Optional[FabricSection] = None,
    ) -> None:
        if runtime is not None and (batch_size is not None or max_len is not None):
            raise ValueError(
                "EngineConfig: pass runtime= or flat batch_size/max_len, not both"
            )
        if model is not None and greedy is not None:
            raise ValueError("EngineConfig: pass model= or flat greedy, not both")
        if fabric is not None and (tp is not None or dp is not None):
            raise ValueError("EngineConfig: pass fabric= or flat tp/dp, not both")
        self.model = model if model is not None else ModelSection(
            greedy=True if greedy is None else greedy
        )
        self.runtime = runtime if runtime is not None else RuntimeSection(
            batch_size=4 if batch_size is None else batch_size,
            max_len=256 if max_len is None else max_len,
        )
        self.fabric = fabric if fabric is not None else FabricSection(
            tp=1 if tp is None else tp, dp=1 if dp is None else dp
        )

    # ------------------------------------------------- flat read-through
    @property
    def greedy(self) -> bool:
        return self.model.greedy

    @property
    def batch_size(self) -> int:
        return self.runtime.batch_size

    @property
    def max_len(self) -> int:
        return self.runtime.max_len

    @property
    def tp(self) -> int:
        return self.fabric.tp

    @property
    def dp(self) -> int:
        return self.fabric.dp

    def __repr__(self) -> str:
        return (
            f"EngineConfig(model={self.model!r}, runtime={self.runtime!r}, "
            f"fabric={self.fabric!r})"
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, EngineConfig):
            return NotImplemented
        return (self.model, self.runtime, self.fabric) == (
            other.model, other.runtime, other.fabric
        )

    def __hash__(self) -> int:
        return hash((self.model, self.runtime, self.fabric))


class ServeEngine:
    """Greedy batched serving of one model on one device.

    ``params`` may be a :class:`~repro_torch.models.module.ParamTree` or its
    ``state_dict`` (as :func:`repro_torch.convert.model_params_from_reference`
    returns it); without it the parameters are drawn from a
    ``torch.Generator`` seeded with ``seed``.  ``timings`` holds the host
    seconds of the last :meth:`generate`'s prefill and decode loop, each
    step ending in the copy of its tokens to the host (which waits for the
    device); the ``sim`` pricing of the TP collectives is left out.
    """

    def __init__(self, cfg: ModelConfig, engine_cfg: EngineConfig,
                 params: Optional[Union[ParamTree, Mapping[str, torch.Tensor]]] = None,
                 seed: int = 0, session: Optional[PcclSession] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.ecfg = engine_cfg
        self._arbiter = None
        self.device = resolve_device(device)
        self.model = build_model(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, self.device)
        elif not isinstance(params, ParamTree):
            params = ParamTree.from_state_dict(params)
        self.params = params.to(self.device)
        # PCCL communication accounting (sim backend: plans, no data moves)
        self.pccl = session
        self.comm = None
        if engine_cfg.tp > 1:
            self.pccl = self.pccl or PcclSession(cm.TPU_V5E_PHOTONIC, device=self.device)
            self.comm = self.pccl.communicator("model", engine_cfg.tp, backend="sim")
            self._act = torch.zeros((engine_cfg.batch_size, cfg.d_model), dtype=torch.float32,
                                    device=self.pccl.device)
        self.timings: Dict[str, float] = {}

    def _charge_tp_step(self, seq_len: int = 1) -> None:
        """Price one model step's TP collectives: two partial-sum activation
        all-reduces per layer (attention out-proj + MLP down-proj).  Decode
        moves a (batch, d_model) activation; prefill moves the full
        (batch, seq_len, d_model) prompt activation.  The operand is the
        rank-stacked ``(tp, *local)`` view of one zero activation."""
        if self.comm is None:
            return
        act = self._act if seq_len <= 1 else self._act.expand(seq_len, *self._act.shape)
        stacked = act.expand(self.ecfg.tp, *act.shape)
        for _ in range(2 * self.cfg.n_layers):
            self.comm.all_reduce(stacked)

    def comm_report(self) -> Dict[str, Any]:
        """Planned TP communication accounting for this engine's lifetime.

        ``exec`` carries the execution-engine counters (zeros under the
        ``sim`` backend)."""
        if self.comm is None:
            return {"tp": 1, "sim_comm_s": 0.0, "algorithm": "none", "events": 0}
        report = {
            "tp": self.ecfg.tp,
            "sim_comm_s": self.comm.sim_elapsed_s,
            "algorithm": self.comm.chosen_algorithm("all_reduce", self._act.numel() * 4),
            "events": len(self.comm.backend.events),
            "exec": self.pccl.exec_stats(),
        }
        if self.ecfg.dp > 1:
            report["concurrent"] = self.concurrent_report()
        return report

    def arbiter(self, cfg: Optional[ArbiterConfig] = None) -> FabricArbiter:
        """The engine's online fabric arbiter (lazily built, then shared).

        Returns a :class:`repro_torch.serve.arbiter.FabricArbiter` bound to
        this engine's session and ``tp × dp`` layout; pass an
        :class:`~repro_torch.serve.arbiter.ArbiterConfig` to rebuild with
        different control-plane policy.
        """
        if self._arbiter is None or cfg is not None:
            self.pccl = self.pccl or PcclSession(cm.TPU_V5E_PHOTONIC, device=self.device)
            self._arbiter = FabricArbiter(
                self.pccl, tp=self.ecfg.tp, dp=self.ecfg.dp,
                d_model=self.cfg.d_model, cfg=cfg,
            )
        return self._arbiter

    def concurrent_report(self) -> Dict[str, Any]:
        """Joint fabric pricing for a continuous-batching step with ``dp``
        replicas on one photonic fabric: the prefill TP all-reduces (full
        ``(batch, max_len, d_model)`` prompt activation, within each
        replica's TP group) run *concurrently* with the decode-side DP
        all-gather (per-token activations exchanged across replicas).  The
        arbiter overlaps the two axes with per-link contention pricing;
        ``speedup`` is the planned gain over pricing each collective as if
        it owned the fabric (sequential baseline).  Pricing goes through
        :meth:`arbiter`, the same control plane that runs the online
        admission/preemption loop (see ``repro_torch.serve.arbiter``).
        """
        tp, dp = self.ecfg.tp, self.ecfg.dp
        if tp < 2 or dp < 2:
            return {"tp": tp, "dp": dp, "speedup": 1.0, "serialized": False}
        prefill_bytes = 4.0 * self.ecfg.batch_size * self.ecfg.max_len * self.cfg.d_model
        decode_bytes = 4.0 * self.ecfg.batch_size * self.cfg.d_model
        cp = self.arbiter().price_joint(prefill_bytes, decode_bytes)
        return {
            "tp": tp,
            "dp": dp,
            "joint_s": cp.cost,
            "sequential_s": cp.sequential_cost,
            "speedup": cp.speedup,
            "serialized": cp.serialized,
            "algorithms": cp.algorithms,
        }

    def _extra_inputs(self, B: int) -> Dict[str, torch.Tensor]:
        """The stub frontends' inputs: zero fp32 image embeddings for a VLM,
        zero fp32 encoder frames for an encoder–decoder."""
        out = {}
        if self.cfg.vlm:
            out["img_embeds"] = torch.zeros((B, self.cfg.vlm.n_img_tokens, self.cfg.d_model),
                                            dtype=torch.float32, device=self.device)
        if self.cfg.enc_dec:
            out["enc_frames"] = torch.zeros((B, self.cfg.enc_dec.enc_seq, self.cfg.d_model),
                                            dtype=torch.float32, device=self.device)
        return out

    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve a batch of requests to completion (prefill + decode loop)."""
        B = self.ecfg.batch_size
        if not 0 < len(requests) <= B:
            raise ValueError(f"generate: {len(requests)} requests for a batch of {B}")
        S = max(len(r.prompt) for r in requests)
        max_new = max(r.max_new_tokens for r in requests)
        n_img = self.cfg.vlm.n_img_tokens if self.cfg.vlm else 0
        if n_img + S + max_new - 1 > self.ecfg.max_len:
            raise ValueError(
                f"generate: {n_img} image tokens, a prompt of {S} tokens and {max_new} new "
                f"tokens need {n_img + S + max_new - 1} KV slots, over max_len={self.ecfg.max_len}"
            )
        toks = np.zeros((B, S), np.int64)
        for i, r in enumerate(requests):
            toks[i, S - len(r.prompt):] = r.prompt  # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(self.device), **self._extra_inputs(B)}
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, state = self.model.prefill(self.params, batch, max_len=self.ecfg.max_len)
            nxt = logits[:, -1, :].argmax(dim=-1, keepdim=True)
            host = nxt.cpu()
            self.timings = {"prefill_s": time.perf_counter() - t0, "decode_s": 0.0,
                            "decode_steps": 0}
            self._charge_tp_step(seq_len=S)
            for i, r in enumerate(requests):
                r.generated.append(int(host[i, 0]))

            t0 = time.perf_counter()
            for _ in range(max_new - 1):
                logits, state = self.model.decode_step(self.params, state, nxt)
                nxt = logits[:, -1, :].argmax(dim=-1, keepdim=True)
                host = nxt.cpu()
                for i, r in enumerate(requests):
                    if len(r.generated) < r.max_new_tokens:
                        r.generated.append(int(host[i, 0]))
            self.timings["decode_s"] = time.perf_counter() - t0
            self.timings["decode_steps"] = max_new - 1
            # priced after the timed loop, in step order: the sum is the same
            for _ in range(max_new - 1):
                self._charge_tp_step()
        for r in requests:
            r.done = True
        return requests
