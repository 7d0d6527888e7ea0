"""Training CLI: ``python -m repro_torch.launch.train --arch <id> [--reduced] ...``

The port of ``repro.launch.train``, with ``--device`` (CUDA by default;
``cpu`` to run on the CPU).  Examples:

  # a reduced config (any arch) on the card:
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b --reduced \\
      --steps 20 --batch 4 --seq 64

  # with checkpointing + injected failure to demonstrate restart, on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b --reduced \\
      --steps 30 --ckpt-dir ./ck --fail-at 12 --device cpu
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

from repro_torch.ckpt.checkpoint import CheckpointConfig
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.runtime.fault import FailureInjector
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Parse ``argv`` (the command line when ``None``), train, print the
    result's two lines and return the trainer's output."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    trainer = Trainer(
        model_cfg=cfg,
        data_cfg=DataConfig(global_batch=args.batch, seq_len=args.seq),
        opt_cfg=OptimizerConfig(lr=args.lr, total_steps=args.steps, warmup_steps=max(args.steps // 10, 1)),
        trainer_cfg=TrainerConfig(
            total_steps=args.steps,
            ckpt_every=args.ckpt_every,
            microbatches=args.microbatches,
        ),
        ckpt_cfg=CheckpointConfig(args.ckpt_dir) if args.ckpt_dir else None,
        failure_injector=FailureInjector(fail_at_steps=args.fail_at),
        device=args.device,
    )
    print(f"[train] {cfg.name} on {trainer.device}")
    out = trainer.run()
    print(f"final: {out['final_metrics']}")
    print(f"DP gradient all-reduce algorithm chosen by PCCL: "
          f"{out['grad_allreduce_algorithm']}")
    return out


if __name__ == "__main__":
    main()
