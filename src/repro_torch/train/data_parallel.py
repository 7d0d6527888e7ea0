"""Data-parallel training whose gradient all-reduce runs on PCCL's plan.

The counterpart of ``per_shard_step`` in ``examples/pccl_dp_training.py``,
with the ``n`` data-parallel ranks stacked on one device, as every
collective of the port runs them: rank ``r`` takes rows
``[r·B/n, (r+1)·B/n)`` of the batch and differentiates its own ``loss``;
each leaf's fp32 gradients form a rank-stacked ``(n, *shape)`` operand
that ``comm.all_reduce`` sums along the planned schedule, leaf by leaf as
the example does.  Every row of the result is the same sum (the smoke and
the tests check it bit for bit); the step divides row 0 by ``n`` and runs
one :func:`~repro_torch.train.optimizer.adamw_update`, which each rank of
the example runs on its identical copy.  The loss is the ranks' mean.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from .optimizer import OptimizerConfig, OptState, adamw_update, leaves


def dp_gradients(model, params, batch: Dict[str, torch.Tensor], comm,
                 n: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(each rank's loss ``(n,)``, ``{name: (n, *shape)`` all-reduced fp32
    gradients``}``) of ``batch`` split over ``n`` ranks."""
    p = leaves(params)
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} rows does not split over {n} ranks")
    b = B // n
    stacked = {k: t.new_empty((n, *t.shape), dtype=torch.float32) for k, t in p.items()}
    losses = []
    for t in p.values():
        t.requires_grad_(True)
    for r in range(n):
        shard = {k: v[r * b:(r + 1) * b] for k, v in batch.items()}
        with torch.enable_grad():
            loss, _ = model.loss(params, shard)
            grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        for (k, t), g in zip(p.items(), grads):
            stacked[k][r] = 0.0 if g is None else g
        losses.append(loss.detach())
    return torch.stack(losses), {k: comm.all_reduce(g) for k, g in stacked.items()}


def make_dp_train_step(model, opt_cfg: OptimizerConfig, comm, n: int) -> Callable:
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``metrics`` ``{"loss", "grad_norm", "lr"}``."""

    def step(params, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        losses, reduced = dp_gradients(model, params, batch, comm, n)
        grads = {k: g[0] / n for k, g in reduced.items()}
        params, opt_state, metrics = adamw_update(opt_cfg, grads, params, opt_state)
        return params, opt_state, {"loss": losses.sum() / n, **metrics}

    return step
