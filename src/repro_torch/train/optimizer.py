"""Optimizer: AdamW with global-norm clipping and LR schedules.

A port of ``repro.train.optimizer``: fp32 moments, a global-norm clip
computed in fp32, weight decay on every leaf, and the bias corrections and
the schedule in fp32, term for term as the reference.  Everything stays on
the parameters' device: the step, the learning rate, the norm and the clip
scale are 0-dim tensors, so an update makes no host sync.

Trees are flat ``{name: tensor}`` dicts in ``state_dict`` order
(:func:`leaves` takes them from a :class:`~repro_torch.models.module.ParamTree`).
:func:`adamw_update` updates the parameters and moments **in place**, under
``torch.no_grad()``, a chunk of at most :data:`CHUNK` elements at a time: a
full-size fp32 temporary of a 2.4 B-parameter model's largest leaf would be
5.8 GB.  Each element's arithmetic is the reference's, whatever the chunk.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, Mapping, NamedTuple, Tuple, Union

import torch
from torch import nn
from torch.distributed.tensor import DTensor

Tree = Dict[str, torch.Tensor]
CHUNK = 1 << 24  # elements per in-place update step: 64 MiB of fp32


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | linear | constant
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor   # () int32, on the parameters' device
    mu: Tree             # fp32, like params
    nu: Tree             # fp32, like params


def leaves(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Tree:
    """``{name: tensor}`` of a module's parameters, or of a dict as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params) -> OptState:
    p = leaves(params)
    device = next(iter(p.values())).device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu={k: torch.zeros_like(v, dtype=torch.float32) for k, v in p.items()},
        nu={k: torch.zeros_like(v, dtype=torch.float32) for k, v in p.items()},
    )


def learning_rate(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The schedule at ``step`` (a tensor), fp32: linear warmup, then cosine,
    linear or constant decay to ``min_lr_ratio``."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * frac
    else:
        decay = torch.ones_like(step)
    return cfg.lr * warm * decay


def _chunks(t: torch.Tensor, *, written: bool = False) -> Iterator[torch.Tensor]:
    """``t``'s elements, at most :data:`CHUNK` at a time: views, which a
    tensor the update writes must give (``view`` raises where ``reshape``
    would copy).  A sharded :class:`DTensor` is one chunk: flattening it
    would gather its shards."""
    if isinstance(t, DTensor):
        return iter((t,))
    flat = t.view(-1) if written else t.reshape(-1)
    return iter(flat.split(CHUNK))


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²), in fp32, on the leaves' device."""
    total = None
    for x in tree.values():
        sq = sum(c.float().square().sum() for c in _chunks(x))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / (norm + 1e-9)), in fp32 on the norm's device."""
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float):
    """(grads scaled by :func:`_clip_scale` in fp32, the norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(
    cfg: OptimizerConfig, grads: Mapping[str, torch.Tensor], params, state: OptState
) -> Tuple[object, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  ``grads`` is ``{name: gradient}`` for every parameter
    of ``params`` (a module or a dict).  Updates ``params`` and the moments
    in place and returns ``(params, new state, {"grad_norm", "lr"})``."""
    p = leaves(params)
    if set(grads) != set(p):
        raise KeyError(f"adamw_update: gradients for {sorted(set(grads) ^ set(p))} "
                       "missing or unknown")
    norm = global_norm(grads)
    scale = _clip_scale(norm, cfg.grad_clip)
    step = state.step + 1
    b1, b2 = cfg.betas
    lr = learning_rate(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for name, param in p.items():
        g_all = grads[name]
        for w, g, m, v in zip(_chunks(param, written=True), _chunks(g_all),
                              _chunks(state.mu[name], written=True),
                              _chunks(state.nu[name], written=True)):
            # the clip's cast back to the gradient's dtype, as the reference
            g32 = (g.float() * scale).to(g.dtype).float()
            m.copy_(b1 * m + (1 - b1) * g32)
            v.copy_(b2 * v + (1 - b2) * g32.square())
            w32 = w.float()
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * w32
            w.copy_(w32 - lr * delta)
    return params, OptState(step, state.mu, state.nu), {"grad_norm": norm, "lr": lr}
