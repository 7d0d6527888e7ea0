"""Batched serving demo on the PyTorch port: prefill + KV-cache decode on
any assigned arch (the port of ``examples/serve_decode.py``).

  PYTHONPATH=src python examples/serve_decode_torch.py --arch zamba2-2.7b               # on the card
  PYTHONPATH=src python examples/serve_decode_torch.py --arch deepseek-v2-lite-16b --device cpu

(reduced configs — the same code paths as the published ones, including
MLA absorbed decode and SSM state decode; random weights from seed 0)
"""

import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    eng = ServeEngine(cfg, EngineConfig(batch_size=args.batch,
                                        max_len=args.prompt_len + args.new_tokens),
                      device=args.device)
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
    print(f"[{args.arch}] generated {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s, batch={args.batch})")
    for i, r in enumerate(out[:2]):
        print(f"  seq {i}: {r.generated}")
    return out


if __name__ == "__main__":
    main()
