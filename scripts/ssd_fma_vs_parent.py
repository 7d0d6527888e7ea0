#!/usr/bin/env python3
"""K4's CUDA-core route (``ssd.cu``, route ``fma``) against an earlier
commit's build of the same source, bit for bit, on one NVIDIA GPU.

    mkdir -p .proof/parent
    git archive <commit> src/repro_torch/kernels | tar -x -C .proof/parent
    PYTHONPATH=src python scripts/ssd_fma_vs_parent.py \\
        .proof/parent/src/repro_torch/kernels/ssd/csrc/ssd.cu

Builds the given ``ssd.cu`` (with the ``ssd_common.cuh`` beside it) with the
port's ``nvcc`` flags and calls it and this tree's ``ssd_cuda`` on the same
operands, with an fp32 initial state: at Zamba2's fp32 prefill X (4, 4096,
80, 64), N = 64, shared B and C; at the mLSTM's X (4, 4096, 4, 1024), N =
512, per-head B and C; and at a ragged bf16 shape that P = 80 keeps off the
tensor cores.  Both calls must take the ``fma`` route and give equal Y and
final states, bit for bit.  Each shape is then timed, both builds in turns
(parent, this, this, parent) by CUDA events, and each build's three passes
by ``torch.profiler``'s device time, with ``chip_smoke.py``'s own timers
(``time_ms``, the median of REPS calls; ``ssd_pass_times``).  Prints the
card's name and power limit, a line a shape, then one JSON line; exits
non-zero without a card or when a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py, at the root

from chip_smoke import nvidia_smi, ssd_pass_times, time_ms  # noqa: E402

# (B, S, H, P, N, chunk, per-head B/C, dtype)
SHAPES = ((4, 4096, 80, 64, 64, 64, False, "float32"),
          (4, 4096, 4, 1024, 512, 64, True, "float32"),
          (2, 1000, 3, 80, 48, 64, False, "bfloat16"))
REPS = 5  # timings a median is taken over


def _passes(ms: dict) -> str:
    return " / ".join(f"{ms.get(p, float('nan')):.3f}" for p in ("states", "recurrence", "outputs"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, help="an earlier commit's ssd.cu")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ssd_fma_vs_parent: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd.kernel import ssd_cuda, ssd_route

    smi = nvidia_smi()
    print(smi, flush=True)
    fn = ctypes.CDLL(str(build.build(args.parent.resolve()))).pccl_ssd
    fn.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 11, *[ctypes.c_int] * 7, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    record = {"device": smi, "shapes": []}
    for B, S, H, P, N, L, per_head, name in SHAPES:
        dt = getattr(torch, name)
        bc = (B, S, H, N) if per_head else (B, S, N)
        X = torch.randn(B, S, H, P, generator=gen, device="cuda").to(dt)
        la = -torch.rand(B, S, H, generator=gen, device="cuda") * 0.3
        Bm = (torch.randn(*bc, generator=gen, device="cuda") * 0.3).to(dt)
        Cm = (torch.randn(*bc, generator=gen, device="cuda") * 0.3).to(dt)
        init = torch.randn(B, H, P, N, generator=gen, device="cuda") * 0.1
        route = ssd_route(dt, P, N, L)
        nc = -(-S // L)
        # the parent's outputs and scratch: scores (B, H, nc, L, L) on every layout
        Y = torch.empty(B, S, H, P, dtype=dt, device="cuda")
        fin = torch.empty(B, H, P, N, dtype=dt, device="cuda")
        states = torch.empty(B, H, nc, P, N, device="cuda")
        before = torch.empty_like(states)
        totals = torch.empty(B, H, nc, device="cuda")
        scores = torch.empty(B, H, nc, L, L, device="cuda")

        def parent():
            return fn(0 if dt == torch.float32 else 1, X.data_ptr(), la.data_ptr(), Bm.data_ptr(),
                      Cm.data_ptr(), init.data_ptr(), Y.data_ptr(), fin.data_ptr(),
                      states.data_ptr(), totals.data_ptr(), before.data_ptr(), scores.data_ptr(),
                      B, S, H, P, N, L, int(per_head), torch.cuda.current_stream().cuda_stream)

        err = parent()
        this_Y, this_fin = ssd_cuda(X, la, Bm, Cm, chunk=L, initial_state=init)
        torch.cuda.synchronize()
        equal = err == 0 and bool(torch.equal(this_Y, Y)) and bool(torch.equal(this_fin, fin))
        row = {"shape": [B, S, H, P, N, L], "per_head": per_head, "dtype": name, "route": route,
               "parent_launch_error": err, "bit_identical": equal}
        del this_Y, this_fin
        if err == 0:
            def this():
                return ssd_cuda(X, la, Bm, Cm, chunk=L, initial_state=init)

            t = [time_ms(torch, f, REPS) for f in (parent, this, this, parent)]
            row["parent_ms"], row["this_ms"] = [t[0], t[3]], [t[1], t[2]]
            row["parent_pass_ms"] = ssd_pass_times(torch, parent)
            row["this_pass_ms"] = ssd_pass_times(torch, this)
        print(f"K4 {name} X {(B, S, H, P)} N {N} chunk {L} per_head={per_head}: route {route}, "
              f"parent's launch error {err}, Y and fin bit-identical {equal}"
              + (f"; parent {row['parent_ms'][0]:.3f} / {row['parent_ms'][1]:.3f} ms, this "
                 f"{row['this_ms'][0]:.3f} / {row['this_ms'][1]:.3f} ms; passes (states, "
                 f"recurrence, outputs) parent "
                 + _passes(row["parent_pass_ms"]) + " ms, this " + _passes(row["this_pass_ms"])
                 + " ms" if err == 0 else ""),
              flush=True)
        record["shapes"].append(row)
        del X, la, Bm, Cm, init, Y, fin, states, before, totals, scores
        torch.cuda.empty_cache()
    ok = all(r["route"] == "fma" and r["bit_identical"] for r in record["shapes"])
    record["ok"] = ok
    print(json.dumps(record))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
