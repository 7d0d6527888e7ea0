"""Every DTensor op of a dry-run cell's count, one line each, for diffing
the placements two torch releases choose.

Each line is the op, its tensor inputs and outputs as global shape and
placements, and the FLOPs the count has reached after it.  Counting a cell
on two torch releases and diffing the files shows the first op where their
DTensor rules part (``PERF.md`` §6: torch 2.11 against 2.13).
Hybrid and ssm configs are counted at their first depth point
(``depth_points``), as the dry run counts them.

Usage:
  python -m repro_torch.launch.dryrun_trace --arch zamba2-2.7b --shape train_4k \\
      --mesh single --out trace.txt.gz
  python -m repro_torch.launch.dryrun_trace --arch zamba2-2.7b --shape train \\
      --reduced --out trace.txt.gz     # a reduced-sweep cell (``dryrun --reduced``)
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import math
from typing import Iterator, List

import torch
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.sharding import default_rules


def _describe(x) -> str:
    if isinstance(x, DTensor):
        return f"{tuple(x.shape)}{''.join(str(p) for p in x.placements)}"
    return str(tuple(x.shape))


@contextlib.contextmanager
def recording(lines: List[str]) -> Iterator[None]:
    """Append a line for every op the count's outer mode sees."""
    dispatch = R._Ops.__torch_dispatch__

    def traced(self, func, types, args=(), kwargs=None):
        out = dispatch(self, func, types, args, kwargs)
        ins = [_describe(a) for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        outs = [_describe(t) for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        lines.append(f"{func} {ins} -> {outs} flops={self.count.flops!r}")
        return out

    R._Ops.__torch_dispatch__ = traced
    try:
        yield
    finally:
        R._Ops.__torch_dispatch__ = dispatch


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, rules) -> List[str]:
    """The lines of one rank's count of the cell's step at ``cfg``'s depth."""
    lines: List[str] = []
    with recording(lines):
        D.count_cell(cfg, shape, mesh, rules)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", required=True, help="file to write (gzip if it ends in .gz)")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced sweep's cell: --shape is train, prefill or decode")
    args = ap.parse_args(argv)
    D._quiet()
    multi = args.mesh == "multi"
    if args.reduced:
        D.fake_world(math.prod(D.REDUCED_MESH))
        mesh = D.make_mesh(D.REDUCED_MESH, ("data", "model"), device_type="cpu")
        cfg = get_config(args.arch).reduced()
        shape = ShapeConfig(f"reduced_{args.shape}", D.REDUCED_SEQ, D.REDUCED_BATCH, args.shape)
    else:
        D.fake_world(512 if multi else 256)
        mesh = D.make_production_mesh(multi_pod=multi, device_type="cpu")
        cfg = get_config(args.arch)
        if D.use_depth_points(cfg, "auto"):
            points, _ = R.depth_points(cfg)
            cfg = points[min(points)]
        shape = SHAPES[args.shape]
    lines = trace_cell(cfg, shape, mesh, default_rules(multi_pod=multi))
    opener = gzip.open if args.out.endswith(".gz") else open
    with opener(args.out, "wt") as fh:
        fh.write("\n".join(lines) + "\n")
    where = f"reduced {D.REDUCED_MESH}" if args.reduced else args.mesh
    print(f"torch {torch.__version__}: {len(lines)} ops of {args.arch} x {args.shape} x "
          f"{where} at {cfg.n_layers} layers -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
