"""A dense layer's tensor-parallel seams, in the order a layer meets them.

Each step, on rank-stacked operands (all ``n`` ranks on one card):

* ``ar_rmsnorm``: ``fusion.fused_all_reduce_rmsnorm`` (the engine's
  all-reduce, then K2 on its buffer) on the ranks' partial activations;
* ``mm_rs``: ``fusion.fused_matmul_reduce_scatter`` on a ring
  communicator (K1 tiles streamed into the reduce-scatter's rounds): the
  MLP's down-projection, each rank's ``intermediate_size / n`` columns;
* ``all_gather``: ``Communicator.all_gather`` of that shard.

The weights are made once from the seed, and ``operand_sets`` sets of the
ranks' activations beside them; step ``i`` runs on set ``i`` modulo their
number, so no two steps in a row see the same operands.  The seams run with
their own tile sizes, as users call them.  What is checked is the last
step's three results, against the set that step ran on.
"""

from __future__ import annotations

import sys

import torch

from pcclbench import arith
from pcclbench.harness import warm_up
from pcclbench.check import fp8, row_error


class Runner:
    def __init__(self, cell) -> None:
        self.cell = cell
        cfg, tr = cell.cfg, cell.traffic
        self.n = cfg["deployment"]["tensor_parallel"]
        self.T = tr["tokens_per_rank"]
        self.D = cfg["hidden_size"]
        self.K = cfg["intermediate_size"] // self.n
        self.eps = cfg["rms_norm_eps"]
        self.dtype = tr["dtype"]
        self.sets = tr["operand_sets"]
        self.cur = self.steps = 0
        self.out = {}

    def inputs(self) -> None:
        """The weights and each set of the ranks' activations, from the
        seed, on the device."""
        dev, n, T, D, K = self.cell.device, self.n, self.T, self.D, self.K
        dt = getattr(torch, self.dtype)
        gen = torch.Generator(device=dev).manual_seed(self.cell.seed)
        self.w = (torch.randn((K, D), generator=gen, device=dev) * K ** -0.5).to(dt)
        self.gamma = torch.randn((D,), generator=gen, device=dev) * 0.1 + 1.0
        self.xs = [torch.randn((n, T, D), generator=gen, device=dev, dtype=dt)
                   for _ in range(self.sets)]
        self.xms = [torch.randn((n, T, K), generator=gen, device=dev, dtype=dt)
                    for _ in range(self.sets)]

    @property
    def x(self) -> torch.Tensor:
        return self.xs[self.cur]

    @property
    def xm(self) -> torch.Tensor:
        return self.xms[self.cur]

    def setup(self) -> None:
        from repro_torch import PcclSession
        from repro_torch.core import cost_model as cm

        self.inputs()
        self.session = PcclSession(cm.H100_DGX, device=self.cell.device)
        self.comm = self.session.communicator("x", self.n)
        self.comm_ring = self.session.communicator("x", self.n, algorithm="ring")
        warm_up(self.step, self.cell.device)

    def step(self) -> dict:
        from repro_torch.comm import fusion

        call = self.cell.spans.call
        self.cur = self.steps % self.sets
        self.steps += 1
        with call("ar_rmsnorm"):
            y1 = fusion.fused_all_reduce_rmsnorm(self.comm, self.x, self.gamma, eps=self.eps)
        with call("mm_rs"):
            y2 = fusion.fused_matmul_reduce_scatter(self.comm_ring, self.xm, self.w)
        with call("all_gather"):
            y3 = self.comm.all_gather(y2)
        self.out = {"ar_rmsnorm": y1, "mm_rs": y2, "all_gather": y3}
        return self.work()

    def work(self) -> dict:
        """One step's counted work, from the shapes alone."""
        n, T, D, K, dt = self.n, self.T, self.D, self.K, self.dtype
        e = arith.ITEMSIZE[dt]
        act = n * T * D * e  # the (n, T, D) operand each of the three reduces or fills
        coll = (arith.collective_bytes("all_reduce", T * D * e, n)
                + arith.collective_bytes("reduce_scatter", T * D * e, n)
                + arith.collective_bytes("all_gather", T // n * D * e, n))
        k1_flops, k1_bytes = arith.k1(n * T, K, D, dt)
        k2_flops, k2_bytes = arith.k2(n * T, D, dt)
        return {"calls": 3, "coll_bytes": 3.0 * act,
                "coll_bound_s": coll / arith.PEAK_BYTES_PER_S,
                "k1_bound_s": arith.bound_s(k1_flops, k1_bytes, dt),
                "k2_bound_s": arith.bound_s(k2_flops, k2_bytes, dt),
                "model_flops": k1_flops}

    def answers(self) -> dict:
        return dict(self.out)

    def release(self) -> None:
        from repro_torch.comm.exec_engine import clear_exec_caches

        stats = self.session.exec_stats()
        print(f"exec stats: fused {stats.fused_dispatches}, fallback {stats.fallback_dispatches}, "
              f"compiled hits {stats.compiled_hits} misses {stats.compiled_misses}",
              file=sys.stderr)
        self.out = {}
        del self.session, self.comm, self.comm_ring
        clear_exec_caches()

    def reference(self, cast=None) -> dict:
        """The plain reference's three results; with ``cast``, computed from
        operands and into results rounded by ``cast`` (the control)."""
        c = cast or (lambda t: t)
        ref = self.cell.ref
        ar = c(ref.all_reduce_rmsnorm(c(self.x), c(self.gamma), self.eps))
        rs = c(ref.matmul_reduce_scatter(c(self.xm), c(self.w)))
        return {"ar_rmsnorm": ar, "mm_rs": rs, "all_gather": c(ref.all_gather(rs))}

    def control(self) -> dict:
        return self.reference(fp8)

    def numbers(self, answers: dict) -> dict:
        """Each result's worst row against the reference's."""
        want = self.reference()
        return {f"{k}.row_err": row_error(answers[k], want[k])
                for k in ("ar_rmsnorm", "mm_rs", "all_gather")}
