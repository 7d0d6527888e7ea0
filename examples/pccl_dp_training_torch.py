"""End-to-end example, PyTorch port of ``examples/pccl_dp_training.py``:
data-parallel training where the gradient all-reduce is executed by PCCL's
schedule-driven collectives instead of a library all-reduce.

The 8 data-parallel ranks are stacked on one device, as every collective of
the port runs them: each rank differentiates its shard of the batch, each
parameter's gradients form a rank-stacked ``(8, *shape)`` operand, and the
communicator all-reduces it (``--backend interp``: the planned rounds;
``native``: one sum, the baseline for A/B runs), leaf by leaf as the JAX
example does.  It runs the example's dense transformer (a widened
``chatglm3-6b``, ~63 M parameters at the defaults), on the card unless
asked for the CPU:

  PYTHONPATH=src python examples/pccl_dp_training_torch.py --steps 300 --hw h100_dgx
  PYTHONPATH=src python examples/pccl_dp_training_torch.py --device cpu --steps 4 \\
      --batch 8 --seq 32 --d-model 128 --layers 2

A single ``PcclSession`` plans everything and reports which algorithm the
planner chose for the gradient buffer size (paper §2.2); by default it
prices the fabric of the JAX example (``tpu_v5e_photonic``).
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.api import PcclSession
from repro_torch.configs import get_config
from repro_torch.core import cost_model as cm
from repro_torch.data import DataConfig, SyntheticLMData, to_device
from repro_torch.device import resolve_device
from repro_torch.models import build_model, param_count
from repro_torch.train import OptimizerConfig, init_opt_state, make_dp_train_step

RANKS = 8
HARDWARE = {"tpu_v5e_photonic": cm.TPU_V5E_PHOTONIC, "h100_dgx": cm.H100_DGX}


def dp_config(d_model: int, layers: int):
    """The JAX example's model: ``chatglm3-6b`` reduced, then widened."""
    return dataclasses.replace(
        get_config("chatglm3-6b").reduced(),
        n_layers=layers, d_model=d_model, n_heads=8, n_kv_heads=2,
        head_dim=64, d_ff=4 * d_model, vocab=32000, dtype="float32",
    )


def parser() -> argparse.ArgumentParser:
    """The JAX example's flags and defaults, and the port's ``--hw`` and
    ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--backend", default="interp", choices=["interp", "native"],
                    help="interp = PCCL's planned rounds; native = one sum (baseline)")
    ap.add_argument("--hw", default="tpu_v5e_photonic", choices=sorted(HARDWARE),
                    help="the fabric the planner prices")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main():
    args = parser().parse_args()

    device = resolve_device(args.device)
    cfg = dp_config(args.d_model, args.layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    n_params = param_count(params)
    print(f"model: {n_params/1e6:.1f} M params, {RANKS} ranks stacked on {device} (pure DP)")

    grad_bytes = 4.0 * n_params
    session = PcclSession(HARDWARE[args.hw], device=device)
    comm = session.communicator("data", RANKS, backend=args.backend)
    print(f"PCCL chose '{comm.chosen_algorithm('all_reduce', grad_bytes)}' "
          f"for the {grad_bytes/1e6:.0f} MB gradient all-reduce "
          f"(backend={args.backend}, fabric {args.hw})")

    opt_cfg = OptimizerConfig(lr=1e-3, total_steps=args.steps, warmup_steps=10)
    opt_state = init_opt_state(params)
    data = SyntheticLMData(cfg, DataConfig(global_batch=args.batch, seq_len=args.seq))
    step_fn = make_dp_train_step(model, opt_cfg, comm, RANKS)

    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = to_device(data.global_batch(step), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(metrics['loss']):.4f}")
    dt = time.perf_counter() - t0
    toks = args.steps * args.batch * args.seq
    moved_by = ("PCCL schedule-driven rounds" if args.backend == "interp"
                else "one native sum (baseline)")
    print(f"trained {args.steps} steps in {dt:.1f}s ({toks/dt:.0f} tok/s) — "
          f"gradients moved by {moved_by}")


if __name__ == "__main__":
    main()
