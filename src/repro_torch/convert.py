"""Carry weights and state from the JAX package into the port.

Arrays cross as numpy: the caller turns the reference's arrays into numpy
(``np.asarray``) and :func:`from_reference` puts them on the port's
device.  :func:`from_reference` covers the collectives' parameters — the
fused matmul's projection weight ``w``, the RMSNorm ``gamma`` and an
``ErrorFeedbackState`` ``residual``; :func:`model_params_from_reference`
carries a whole model's parameter tree, and :func:`opt_state_from_reference`
an AdamW state over it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

# name → expected rank, for the parameters of this slice
PARAMETERS = {"w": 2, "gamma": 1, "residual": None}


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy: JAX's arrays are read-only
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX's arrays carry ml_dtypes');
        # its bits cross as uint16 and are reinterpreted
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_reference(
    arrays: Dict[str, np.ndarray], *, device: Union[str, torch.device]
) -> Dict[str, torch.Tensor]:
    """Tensors on ``device`` with the same values, bit for bit.

    Raises ``KeyError`` on a name this slice does not know and
    ``ValueError`` on a parameter of the wrong rank.
    """
    out = {}
    for name, a in arrays.items():
        if name not in PARAMETERS:
            raise KeyError(f"unknown parameter {name!r}; known: {sorted(PARAMETERS)}")
        rank = PARAMETERS[name]
        if rank is not None and np.ndim(a) != rank:
            raise ValueError(f"parameter {name!r} needs rank {rank}, got shape {np.shape(a)}")
        out[name] = _to_tensor(a).to(device)
    return out


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"a.b.c": leaf}`` of nested dicts and lists (a list entry is named
    by its index: ``layers.ffn.shared.0.wi_gate``)."""
    items = enumerate(tree) if isinstance(tree, (list, tuple)) else tree.items()
    out: Dict[str, Any] = {}
    for k, v in items:
        if isinstance(v, (Mapping, list, tuple)):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def model_params_from_reference(cfg, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port model's ``state_dict`` from the reference's parameter tree.

    ``tree`` is the reference's unboxed tree (``repro.models.module.unbox``)
    as nested dicts (and lists: DeepSeek's shared experts) of numpy
    arrays, for the model ``cfg`` builds.  Keys are
    the tree's paths joined by ``.``; values are CPU tensors equal to the
    arrays bit for bit.  Raises ``KeyError`` on a missing or an extra key
    and ``ValueError`` on a wrong shape.
    """
    from repro_torch.models import build_model

    want = build_model(cfg).param_shapes()
    got = _flatten(tree)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(
            f"model_params_from_reference({cfg.name}): missing {missing}, extra {extra}"
        )
    out = {}
    for name, shape in want.items():
        a = got[name]
        if tuple(np.shape(a)) != tuple(shape):
            raise ValueError(
                f"model_params_from_reference({cfg.name}): {name} has shape "
                f"{tuple(np.shape(a))}, the port needs {tuple(shape)}"
            )
        out[name] = _to_tensor(a)
    return out


def opt_state_from_reference(cfg, state):
    """The port's :class:`~repro_torch.train.optimizer.OptState` from the
    reference's ``OptState(step, mu, nu)`` for the model ``cfg`` builds,
    as numpy (``jax.tree.map(np.asarray, state)``): the step a 0-dim int32
    tensor, the moments ``{name: tensor}`` checked and carried as
    :func:`model_params_from_reference` carries parameters.  CPU tensors,
    equal bit for bit."""
    from repro_torch.train.optimizer import OptState

    step, mu, nu = state
    return OptState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32),
        mu=model_params_from_reference(cfg, mu),
        nu=model_params_from_reference(cfg, nu),
    )
