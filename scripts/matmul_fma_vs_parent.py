#!/usr/bin/env python3
"""K1's CUDA-core route (``matmul.cu``, route ``fma``) against an earlier
commit's build of the same source, bit for bit, on one NVIDIA GPU.

    mkdir -p .proof/parent
    git archive <commit> src/repro_torch/kernels | tar -x -C .proof/parent
    PYTHONPATH=src python scripts/matmul_fma_vs_parent.py \\
        .proof/parent/src/repro_torch/kernels/matmul/csrc/matmul.cu

Builds the given ``matmul.cu`` with the port's ``nvcc`` flags and calls it
and this tree's ``matmul_cuda`` on the same operands: at the main path's
fp32 shape (32768x3584)@(3584x12288), and at (1000x3583)@(3583x520) in
bf16, whose odd K and N keep it off the tensor cores.  Both calls must take
the ``fma`` route and give equal outputs, bit for bit.  Prints the card's
name and power limit, a line a shape, then one JSON line; exits non-zero
without a card or when a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

SHAPES = (((32768, 3584, 12288), "float32"), ((1000, 3583, 520), "bfloat16"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, help="an earlier commit's matmul.cu")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("matmul_fma_vs_parent: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.matmul.kernel import matmul_cuda, matmul_route

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    fn = ctypes.CDLL(str(build.build(args.parent.resolve()))).pccl_matmul
    fn.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 3, *[ctypes.c_int] * 3, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    record = {"device": smi, "shapes": []}
    for (M, K, N), name in SHAPES:
        dt = getattr(torch, name)
        x = torch.randn(M, K, generator=gen, device="cuda").to(dt)
        w = (torch.randn(K, N, generator=gen, device="cuda") / math.sqrt(K)).to(dt)
        route = matmul_route(x.shape, w.shape, dt)
        parent = torch.empty(M, N, dtype=dt, device="cuda")
        err = fn(0 if dt == torch.float32 else 1, x.data_ptr(), w.data_ptr(), parent.data_ptr(),
                 M, N, K, torch.cuda.current_stream().cuda_stream)
        this = matmul_cuda(x, w)
        torch.cuda.synchronize()
        row = {"shape": [M, K, N], "dtype": name, "route": route, "parent_launch_error": err,
               "bit_identical": err == 0 and bool(torch.equal(this, parent))}
        print(f"K1 {name} ({M}x{K})@({K}x{N}): route {route}, parent's launch error {err}, "
              f"bit-identical {row['bit_identical']}", flush=True)
        record["shapes"].append(row)
        del x, w, parent, this
    ok = all(r["route"] == "fma" and r["bit_identical"] for r in record["shapes"])
    record["ok"] = ok
    print(json.dumps(record))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
