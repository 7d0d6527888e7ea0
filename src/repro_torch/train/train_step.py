"""Train and serve steps (``repro.train.train_step``).

``make_train_step`` accumulates gradients over microbatches, the
counterpart of the reference's ``lax.scan`` (``train_step.py:37-60`` there):
the batch splits into ``microbatches`` equal runs of rows, each one's
``loss`` is differentiated in turn, and the fp32 sums of the losses and
gradients are divided by their number.  The gradients accumulate in the
parameters' ``.grad`` (autograd adds each microbatch's into the sum as the
backward pass produces it, so no second full-size buffer is held); they are
dropped after the update.  Parameters and optimizer moments are updated in
place (:func:`repro_torch.train.optimizer.adamw_update`), where the
reference donates them to XLA.  Nothing in a step waits for the device.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from .optimizer import OptimizerConfig, OptState, adamw_update, leaves


def _microbatches(batch: Dict[str, torch.Tensor], m: int):
    """``m`` runs of equal rows of every entry, in order: the reference's
    reshape to ``(m, B // m, …)``."""
    B = next(iter(batch.values())).shape[0]
    if B % m:
        raise ValueError(f"a batch of {B} rows does not split into {m} microbatches")
    b = B // m
    return [{k: v[i * b:(i + 1) * b] for k, v in batch.items()} for i in range(m)]


def make_train_step(model, opt_cfg: OptimizerConfig, *, microbatches: int = 1) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``metrics`` holds ``loss``, the model's metrics (``xent``
    alone, the mean loss, when ``microbatches > 1``, as the reference),
    ``grad_norm`` and ``lr``, all 0-dim tensors on the device."""

    def train_step(params, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        p = leaves(params)
        for t in p.values():
            t.requires_grad_(True)
            t.grad = None
        with torch.enable_grad():
            if microbatches == 1:
                loss, metrics = model.loss(params, batch)
                loss.backward()
            else:
                loss = torch.zeros((), dtype=torch.float32, device=next(iter(p.values())).device)
                for one in _microbatches(batch, microbatches):
                    part, _ = model.loss(params, one)
                    part.backward()
                    loss = loss + part.detach()
                loss = loss / microbatches
                metrics = {"xent": loss}
        grads = {}
        for k, t in p.items():
            g = torch.zeros_like(t) if t.grad is None else t.grad
            grads[k] = g.div_(microbatches) if microbatches > 1 else g
        params, opt_state, opt_metrics = adamw_update(opt_cfg, grads, params, opt_state)
        for t in p.values():
            t.grad = None
        out = {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}
        return params, opt_state, out

    return train_step


def make_eval_step(model) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params, batch)
        return {"loss": loss, **metrics}

    return eval_step


def make_prefill_step(model) -> Callable:
    def prefill_step(params, batch):
        with torch.inference_mode():
            return model.prefill(params, batch)

    return prefill_step


def make_serve_step(model) -> Callable:
    """One decode step: (params, state, tokens (B,1)) -> (logits, state)."""

    def serve_step(params, state, tokens):
        with torch.inference_mode():
            return model.decode_step(params, state, tokens)

    return serve_step
