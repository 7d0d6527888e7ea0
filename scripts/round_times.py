"""Device time of each round of an all-reduce on the round kernel and on
PyTorch's indexing, at the benchmark's layer-cell shape.

    python scripts/round_times.py [--tokens 4096] [--width 12288] [--reps 20]

from the root of a checkout, on a card.  It compiles the bucket2d
all-reduce of 8 ranks (the plan the layer cell's AR+RMSNorm takes), makes
the rank-stacked ``(8, 8, tokens · width / 8)`` bf16 buffer the engine
runs it on, and times every round ``--reps`` times with CUDA events, on
the kernel (``repro_torch.kernels.rounds.stacked_round``) and on the plain
version (``round_reference``, the index path), each on a buffer of its
own.  One JSON line a round: its mode (reduce or store), chunks gathered,
bytes gathered C, the bytes bound (3C for a reduce, 2C for a store, at
3.35 TB/s), the median ms of each path and the kernel's share of the
bound; a last line names the card and its power limit.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PEAK_BYTES_PER_S = 3.35e12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=4096)
    ap.add_argument("--width", type=int, default=12288)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src")]
    import torch

    from repro_torch.comm import exec_engine as E
    from repro_torch.core import schedules as S
    from repro_torch.kernels.rounds import round_reference, stacked_round

    n = 8
    dev = torch.device("cuda")
    compiled = E.compile_schedule(S.bucket_all_reduce((2, 4), 1.0))
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, n, args.tokens * args.width // n), generator=g, device=dev,
                    dtype=torch.bfloat16)
    tables = E.device_tables(compiled, dev)
    chunk_bytes = E.chunk_bytes(x)

    def timed(fn, buf, rnd):
        fn(buf, tables.rows, rnd)  # warm: the build, the allocator
        ms = []
        for _ in range(args.reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn(buf, tables.rows, rnd)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        return statistics.median(ms)

    kernel_buf, plain_buf = x.clone(), x.clone()
    for i, rnd in enumerate(tables.rounds):
        gathered = rnd.src_ids.numel() * chunk_bytes
        bound_ms = (3 if rnd.reduce else 2) * gathered / PEAK_BYTES_PER_S * 1e3
        kernel_ms = timed(stacked_round, kernel_buf, rnd)
        plain_ms = timed(round_reference, plain_buf, rnd)
        print(json.dumps({"round": i, "mode": "reduce" if rnd.reduce else "store",
                          "staged": rnd.staged, "chunks": rnd.src_ids.numel(),
                          "gathered_bytes": gathered, "bound_ms": round(bound_ms, 4),
                          "kernel_ms": round(kernel_ms, 4), "index_path_ms": round(plain_ms, 4),
                          "kernel_share_of_bound": round(100 * bound_ms / kernel_ms, 2)}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
