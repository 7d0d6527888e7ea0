"""Planned collectives alone, at a job's fixed bucket sizes.

Each step runs every (kind, buffer) pair of the mix once, in an order drawn
from the seed: the kinds are ``all_reduce``, ``reduce_scatter``,
``all_gather``, ``all_to_all`` and ``all_reduce_ef8`` (the all-reduce of a
communicator that declares the ``ring_ef8`` wire's error bound), the
buffers each rank's operand of ``buffer_mib`` MiB (for an all-gather, each
rank's result).  Every seed gets the same set of calls, in another order.
The plans are compiled in set-up, as a job's fixed buckets are.  The
operands are made from the seed in ``operand_sets`` sets; step ``i`` runs
on set ``i`` modulo their number, so no two steps in a row see the same
operands.  What is checked is the last step's result of each kind, at a
buffer size drawn from the seed, against the set that step ran on.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pcclbench import arith
from pcclbench.harness import warm_up
from pcclbench.check import fp8, max_difference, row_error

METHOD = {"all_reduce": "all_reduce", "reduce_scatter": "reduce_scatter",
          "all_gather": "all_gather", "all_to_all": "all_to_all",
          "all_reduce_ef8": "all_reduce"}


class Runner:
    def __init__(self, cell) -> None:
        self.cell = cell
        tr = cell.traffic
        self.n = cell.cfg["deployment"]["tensor_parallel"]
        self.dtype = tr["dtype"]
        self.cols = tr["columns"]
        self.mib = list(tr["buffer_mib"])
        self.kinds = list(tr["kinds"])
        self.sets = tr["operand_sets"]
        self.cur = self.steps = 0
        self.ef8_tol = (self.n - 1) / 127  # the ring_ef8 wire's stated bound, its declared tolerance
        rng = np.random.default_rng(cell.seed)
        self.rng = rng
        self.checked = {k: self.mib[int(rng.integers(len(self.mib)))] for k in self.kinds}
        self.pairs = [(k, m) for k in self.kinds for m in self.mib]
        self.kept = {}

    def rows(self, mib: int) -> int:
        return mib * 2 ** 20 // (arith.ITEMSIZE[self.dtype] * self.cols)

    def inputs(self) -> None:
        """In each set, per buffer size, the ranks' operand and (for
        all-gathers) shard."""
        dev, n, C = self.cell.device, self.n, self.cols
        dt = getattr(torch, self.dtype)
        gen = torch.Generator(device=dev).manual_seed(self.cell.seed)
        self.xs, self.shards = [], []
        for _ in range(self.sets):
            self.xs.append({m: torch.randn((n, self.rows(m), C), generator=gen, device=dev,
                                           dtype=dt) for m in self.mib})
            self.shards.append({m: torch.randn((n, self.rows(m) // n, C), generator=gen,
                                               device=dev, dtype=dt) for m in self.mib})

    def setup(self) -> None:
        from repro_torch import PcclSession
        from repro_torch.core import cost_model as cm

        self.inputs()
        self.session = PcclSession(cm.H100_DGX, device=self.cell.device)
        self.comm = {k: self.session.communicator("x", self.n) for k in self.kinds}
        if "all_reduce_ef8" in self.comm:
            self.comm["all_reduce_ef8"] = self.session.communicator(
                "x", self.n, rel_error_tol=self.ef8_tol)
        warm_up(lambda: self.run(self.pairs), self.cell.device)

    def operand(self, kind: str, mib: int) -> torch.Tensor:
        return (self.shards if kind == "all_gather" else self.xs)[self.cur][mib]

    def run(self, order) -> None:
        call = self.cell.spans.call
        self.cur = self.steps % self.sets
        self.steps += 1
        for kind, mib in order:
            with call(kind):
                out = getattr(self.comm[kind], METHOD[kind])(self.operand(kind, mib))
            if self.checked[kind] == mib:
                self.kept[kind] = out

    def step(self) -> dict:
        order = [self.pairs[i] for i in self.rng.permutation(len(self.pairs))]
        self.run(order)
        return self.work()

    def work(self) -> dict:
        n = self.n
        coll = bound = 0.0
        for kind, mib in self.pairs:
            buf = mib * 2 ** 20
            coll += n * buf  # the larger of the stacked operand and result
            local_in = buf // n if kind == "all_gather" else buf
            bound += arith.collective_bytes(METHOD[kind], local_in, n)
        return {"calls": len(self.pairs), "coll_bytes": coll,
                "coll_bound_s": bound / arith.PEAK_BYTES_PER_S}

    def answers(self) -> dict:
        return dict(self.kept)

    def release(self) -> None:
        from repro_torch.comm.exec_engine import clear_exec_caches

        ef8 = self.comm.get("all_reduce_ef8")
        if ef8 is not None:
            algs = {m: ef8.chosen_algorithm("all_reduce", m * 2 ** 20) for m in self.mib}
            print(f"all_reduce_ef8 algorithm by MiB: {algs}", file=sys.stderr)
        self.kept = {}
        del self.session, self.comm
        clear_exec_caches()

    def reference(self, kind: str, cast=None):
        c = cast or (lambda t: t)
        ref, a = self.cell.ref, c(self.operand(kind, self.checked[kind]))
        return c({"all_reduce": ref.all_reduce, "all_reduce_ef8": ref.all_reduce,
                  "reduce_scatter": ref.reduce_scatter, "all_gather": ref.all_gather,
                  "all_to_all": ref.all_to_all}[kind](a))

    def control(self) -> dict:
        return {k: self.reference(k, fp8) for k in self.kinds}

    def numbers(self, answers: dict) -> dict:
        """Per kind: the worst row where values are added; the largest
        difference where they are only moved (exact); for the ``ring_ef8``
        wire the largest error over n · max|x|, the measure of its stated
        bound."""
        out = {}
        for kind in self.kinds:
            got, want = answers[kind], self.reference(kind)
            if kind in ("all_gather", "all_to_all"):
                out[f"{kind}.max_diff"] = max_difference(got, want)
            elif kind == "all_reduce_ef8":
                scale = self.n * self.operand(kind, self.checked[kind]).abs().max().float().item()
                out[f"{kind}.err_over_nA"] = max_difference(got, want) / scale
            else:
                out[f"{kind}.row_err"] = row_error(got, want)
            del got, want
        return out
