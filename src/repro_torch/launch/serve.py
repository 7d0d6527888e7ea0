"""Serving CLI: ``python -m repro_torch.launch.serve --arch <id> [--no-reduced]``

The port of ``repro.launch.serve``, shaped like
:mod:`repro_torch.launch.train`: ``--device`` (CUDA by default; ``cpu`` to
run on the CPU).  Runs batched prefill + decode, greedily, on random
weights from seed 0 and reports tokens/s.  The reduced config is the
default, as in the reference; ``--no-reduced`` serves the published one
(the reference's ``--reduced`` cannot be turned off).  Before the
reference's two lines it prints the config and the device, and on CUDA,
after them, the peak device memory.  Examples:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --no-reduced
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine


def main(argv: Optional[Sequence[str]] = None) -> List[Request]:
    """Parse ``argv`` (the command line when ``None``), serve, print the
    result's lines and return the served requests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    eng = ServeEngine(cfg, EngineConfig(batch_size=args.batch,
                                        max_len=args.prompt_len + args.new_tokens),
                      device=args.device)
    print(f"[serve] {cfg.name} ({'reduced' if args.reduced else 'published'} config, "
          f"d_model {cfg.d_model}, {cfg.n_layers} layers) on {eng.device}")
    rng = np.random.default_rng(0)
    reqs = [
        Request(prompt=rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32),
                max_new_tokens=args.new_tokens)
        for _ in range(args.batch)
    ]
    t0 = time.perf_counter()
    out = eng.generate(reqs)
    dt = time.perf_counter() - t0
    total = sum(len(r.generated) for r in out)
    print(f"generated {total} tokens in {dt:.2f}s ({total/dt:.1f} tok/s, "
          f"batch={args.batch})")
    print("sample:", out[0].generated[:8])
    if eng.device.type == "cuda":
        print(f"peak device memory: {torch.cuda.max_memory_allocated(eng.device) / 2**30:.2f} GiB")
    return out


if __name__ == "__main__":
    main()
