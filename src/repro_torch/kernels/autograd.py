"""The gradient of a kernel that has no backward kernel: its plain version's.

The JAX package differentiates K3 and K4 only through their plain versions
(``use_pallas=False``): it has no backward Pallas kernel, and ``jax.grad``
through ``pallas_call`` fails on JAX 0.9.0.  So the port owes no backward
kernel either.  :class:`PlainGradient` runs the hand-written kernel in the
forward pass and, in the backward pass, recomputes the plain version under
``torch.enable_grad()`` on detached copies of the saved inputs and returns
``torch.autograd.grad`` of it: the same gradient as differentiating the
plain version directly, bit for bit when the forward is the plain version.

The forward is a parameter (``kernel``), so a CPU test can hand it the
plain version and hold the backward's mechanics against direct autograd.
Entry points go through it only when a gradient can flow (:func:`needs_grad`:
grad mode on and an input that requires one): under ``torch.inference_mode()`` or
``torch.no_grad()`` they launch the kernel as they always did, so serving
saves nothing and launches exactly what it launched before.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True iff autograd would record a call on these tensors."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


class PlainGradient(torch.autograd.Function):
    """``kernel(*inputs, **kw)`` forward; the gradient of ``plain(*inputs, **kw)``.

    ``inputs`` are tensors or None (an absent optional operand); the
    outputs are one tensor or a tuple of tensors.  An output whose
    gradient is not needed (a final state nobody reads) gets none: the
    backward differentiates only the outputs that received a gradient.
    """

    @staticmethod
    def forward(ctx, kernel: Callable, plain: Callable, kw: dict, *inputs):
        ctx.set_materialize_grads(False)
        ctx.plain, ctx.kw = plain, kw
        ctx.save_for_backward(*inputs)
        return kernel(*inputs, **kw)

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        wants = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(w)
                      for t, w in zip(inputs, wants)]
            outs = ctx.plain(*leaves, **ctx.kw)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            wrt = [t for t, w in zip(leaves, wants) if w]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                           allow_unused=True) if pairs and wrt else ())
        return (None, None, None, *(next(got, None) if w else None for w in wants))

