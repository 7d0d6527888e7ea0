"""Quickstart on the PyTorch port (the port of ``examples/quickstart.py``):
the PcclSession front door — plan collectives, see why reconfiguration
wins, and watch the session amortize it.

``PcclSession`` is the library's single entry point: it owns the hardware
model, a plan cache, and the fabric state.  Every ``session.plan(...)`` call
starts from the topology the *previous* collective left programmed on the
photonic fabric, so back-to-back collectives stop re-paying reconfigurations
(something the stateless ``plan_collective`` facade could never express).

Planning is numpy and runs on the host; the sessions are made on the
device their communicators would run on, CUDA unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

from repro_torch.api import PcclSession
from repro_torch.core import cost_model as cm
from repro_torch.core import topology as T

MB = 1024.0 ** 2


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    dev = ap.parse_args(argv).device
    n = 128
    hw = cm.H100_DGX  # α=3µs, β=1/450 GB/s, reconfig r=5µs (paper §5)

    print("=== PCCL quickstart: ReduceScatter of 256 MB on 128 GPUs ===\n")
    for topo_name in ["ring", "torus2d", "grid2d"]:
        g0 = T.standard_topologies(n)[topo_name]
        session = PcclSession(hw, g0=g0, thread_fabric=False, device=dev)
        plan = session.plan("reduce_scatter", 256 * MB, algorithm="auto")
        ring = session.baseline("reduce_scatter", "ring", 256 * MB).total
        rhd = session.baseline("reduce_scatter", "rhd", 256 * MB).total
        print(f"starting topology: {topo_name}")
        print(f"  ring  on fixed fabric : {ring*1e6:9.1f} us")
        print(f"  RHD   on fixed fabric : {rhd*1e6:9.1f} us")
        print(f"  PCCL ({plan.algorithm} schedule, {plan.num_reconfigs} reconfigs)"
              f" : {plan.cost*1e6:9.1f} us")
        b = plan.breakdown()
        print(f"    breakdown: alpha={b['alpha']*1e6:.1f}us beta={b['beta']*1e6:.1f}us "
              f"dilation={b['dilation']*1e6:.1f}us congestion={b['congestion']*1e6:.1f}us "
              f"reconfig={b['reconfig']*1e6:.1f}us\n")

    print("=== Sessions thread fabric state across collectives ===\n")
    session = PcclSession(hw, g0=T.grid2d(*T.square_dims2(n)), device=dev)
    cold = session.plan("reduce_scatter", 256 * MB, algorithm="ring")
    warm = session.plan("reduce_scatter", 256 * MB, algorithm="ring")
    again = session.plan("reduce_scatter", 256 * MB, algorithm="ring")
    print(f"cold start : {cold.cost*1e6:9.1f} us ({cold.num_reconfigs} reconfigs)")
    print(f"warm start : {warm.cost*1e6:9.1f} us ({warm.num_reconfigs} reconfigs)"
          f" — fabric already holds the ring circuits")
    print(f"cached     : {again.cost*1e6:9.1f} us "
          f"(cache {session.stats.hits} hit / {session.stats.misses} miss)\n")

    print("=== When NOT to reconfigure: 1 GB buffer, 1 ms (MEMS-class) switch ===\n")
    slow = PcclSession(cm.H100_DGX_R1MS, g0=T.ring(n), device=dev)
    plan = slow.plan("reduce_scatter", 1024 * MB)
    print(f"PCCL reconfigures only {plan.num_reconfigs}×/7 rounds "
          f"(trades congestion for reconfig delay, paper Fig. 9)\n")

    print("=== MoE AllToAll (paper Fig. 10a): DEX schedule, 32 MB, 128 GPUs ===\n")
    for topo_name in ["ring", "torus3d"]:
        g0 = T.standard_topologies(n)[topo_name]
        session = PcclSession(hw, g0=g0, thread_fabric=False, device=dev)
        dex_fixed = session.baseline("all_to_all", "dex", 32 * MB).total
        plan = session.plan("all_to_all", 32 * MB)
        print(f"  {topo_name}: DEX fixed {dex_fixed*1e6:.1f} us → PCCL "
              f"{plan.cost*1e6:.1f} us ({dex_fixed/plan.cost:.2f}x)")

    print("\n=== Executable collectives hang off the same session ===\n")
    tpu = PcclSession(cm.TPU_V5E_PHOTONIC, device=dev)
    comm = tpu.communicator("data", 8, backend="interp")
    print(f"comm.all_reduce on a rank-stacked (8, …) tensor on {comm.device} runs "
          f"'{comm.chosen_algorithm('all_reduce', 4 * MB)}' rounds; "
          f"split([r % 2 ...]) gives DP×TP sub-groups "
          f"(see examples/pccl_dp_training_torch.py)")


if __name__ == "__main__":
    main()
