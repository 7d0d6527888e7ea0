"""PCCL on PyTorch and CUDA: the port of the JAX package ``repro``.

It keeps the reference's module layout and names — ``core`` (the planner,
copied), ``comm`` (the schedule engine and fusion seams), ``api`` (sessions
and communicators), ``configs`` (copied), ``models`` and ``serve`` (the
Zamba2 serving path) and ``kernels`` (hand-written Hopper kernels) — and
imports nothing of ``repro`` or JAX.  Collectives take the rank-stacked
global ``(axis_size, *local)`` tensor.  Entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""

from .api import Communicator, PcclSession, PlanRequest

__all__ = ["Communicator", "PcclSession", "PlanRequest"]
