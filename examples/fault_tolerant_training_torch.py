"""Fault-tolerant training demo on the PyTorch port: checkpoints, injected
node failures, and exact resume (the port of
``examples/fault_tolerant_training.py``).

  PYTHONPATH=src python examples/fault_tolerant_training_torch.py              # on the card
  PYTHONPATH=src python examples/fault_tolerant_training_torch.py --device cpu
"""

import argparse
import tempfile

from repro_torch.ckpt.checkpoint import CheckpointConfig
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.runtime.fault import FailureInjector
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config("olmoe-1b-7b").reduced()  # tiny MoE, same code paths
    steps = 24
    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(
            model_cfg=cfg,
            data_cfg=DataConfig(global_batch=4, seq_len=32),
            opt_cfg=OptimizerConfig(lr=1e-3, total_steps=steps, warmup_steps=2),
            trainer_cfg=TrainerConfig(total_steps=steps, ckpt_every=6, log_every=6),
            ckpt_cfg=CheckpointConfig(d, keep=2, async_write=True),
            failure_injector=FailureInjector(fail_at_steps=(10, 17)),
            device=args.device,
        )
        out = trainer.run()
        print(f"\nsurvived 2 injected failures; final loss "
              f"{out['final_metrics']['loss']:.4f}")
        print(f"PCCL planned '{out['grad_allreduce_algorithm']}' for the "
              f"gradient all-reduce")
        print(f"straggler report: {out['stragglers'] or 'none flagged'}")
    return out


if __name__ == "__main__":
    main()
