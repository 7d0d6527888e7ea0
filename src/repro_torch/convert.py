"""Carry weights and state from the JAX package into the port.

Arrays cross as numpy: the caller turns the reference's arrays into numpy
(``np.asarray``) and :func:`from_reference` puts them on the port's
device.  This slice covers its own parameters — the fused matmul's
projection weight ``w``, the RMSNorm ``gamma`` and an
``ErrorFeedbackState`` ``residual``; the model parameter trees come with
the model slice.
"""

from __future__ import annotations

from typing import Dict, Union

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
