"""PCCL pricing of a cell's collectives, and the variant sweep
(``repro.launch.perf``).

:func:`pccl_pricing` takes the per-rank wire bytes by collective of one
sharded step (the dry run's ``bytes_by_op``) and prices them on PCCL's
planner against a fixed-ring fabric: the repo's route from the planner to
an end-to-end step.  It plans on the host only (the session executes
nothing), so it runs on any machine.

The sweep re-runs the dry run of three cells with one change each
(``VARIANTS``), chosen in the reference from its 32-cell baseline table:

* olmoe-1b-7b × train_4k         — the MoE all-to-all cell (paper Fig. 10a);
* mistral-large-123b × train_4k  — the biggest model, memory-dominated;
* chatglm3-6b × decode_32k       — the most collective-bound relative to
                                   compute.

Usage: ``python -m repro_torch.launch.perf [--only <variant-prefix>] [--force]``
(records under ``results/torch_perf/``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import traceback

from repro_torch.api import PcclSession
from repro_torch.core import cost_model as cm

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "torch_perf"

# collective op → PCCL primitive (collective-permute priced as a direct
# circuit below; it is a p2p under PCCL, not a planned collective).
_COLLECTIVE_OF_OP = {
    "all-reduce": "all_reduce",
    "all-gather": "all_gather",
    "reduce-scatter": "reduce_scatter",
    "all-to-all": "all_to_all",
}


def pccl_pricing(bytes_by_op, chips, hw=cm.TPU_V5E_PHOTONIC):
    """Re-price a cell's collective traffic with PCCL.

    One session per cell: fabric state threads across the step's collective
    types, exactly as a PCCL-scheduled job would run them back-to-back.  The
    per-device wire bytes stand in for the collective buffer size (a lower
    bound; good enough for the A/B ratio against the fixed-ring fabric the
    roofline's LINK_BW model assumes).
    """
    session = PcclSession(hw, device="cpu")
    pccl_s = 0.0
    fixed_s = 0.0
    by_op = {}
    for op, nbytes in sorted(bytes_by_op.items()):
        if nbytes <= 0:
            continue
        if op in _COLLECTIVE_OF_OP and chips >= 2:
            coll = _COLLECTIVE_OF_OP[op]
            planned = session.plan(coll, float(nbytes), n=chips).cost
            fixed = session.baseline(coll, "ring" if coll != "all_to_all" else "direct",
                                     float(nbytes), n=chips).total
        else:  # collective-permute / unknown: direct circuit vs 1-hop fixed
            planned = hw.reconfig_delay + hw.alpha + hw.beta * nbytes
            fixed = hw.alpha + hw.beta * nbytes
        pccl_s += planned
        fixed_s += fixed
        by_op[op] = {"bytes": float(nbytes), "pccl_s": planned, "fixed_s": fixed}
    return {
        "hw": hw.name,
        "pccl_comm_s": pccl_s,
        "fixed_comm_s": fixed_s,
        "speedup": (fixed_s / pccl_s) if pccl_s else None,
        "by_op": by_op,
        "plan_cache": dataclasses.asdict(session.stats),
    }


def _moe_dispatch(mode):
    def t(cfg):
        return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch=mode))
    t.knob = ("moe", "dispatch")
    return t


def _remat(policy):
    def t(cfg):
        return dataclasses.replace(cfg, remat=policy)
    t.knob = ("remat",)
    return t


def _attn(impl):
    def t(cfg):
        return dataclasses.replace(cfg, attention_impl=impl)
    t.knob = ("attention_impl",)
    return t


def _compose(*ts):
    def t(cfg):
        for f in ts:
            cfg = f(cfg)
        return cfg
    t.knobs = [f.knob for f in ts]
    return t


# (name, arch, shape, cfg_transform, fsdp)
VARIANTS = [
    # --- cell 1: olmoe train_4k ------------------------------------------
    ("olmoe_train/base_global_dispatch", "olmoe-1b-7b", "train_4k",
     _moe_dispatch("global"), True),
    ("olmoe_train/opt1_grouped_dispatch", "olmoe-1b-7b", "train_4k",
     _moe_dispatch("grouped"), True),
    ("olmoe_train/opt2_grouped_local_scatter_a2a", "olmoe-1b-7b", "train_4k",
     _moe_dispatch("grouped"), True),
    ("olmoe_train/opt3_plus_remat_dots", "olmoe-1b-7b", "train_4k",
     _compose(_moe_dispatch("grouped"), _remat("dots")), True),
    # --- cell 2: mistral-large train_4k ----------------------------------
    ("mistral_train/base_remat_full", "mistral-large-123b", "train_4k",
     None, True),
    ("mistral_train/opt1_remat_dots", "mistral-large-123b", "train_4k",
     _remat("dots"), True),
    ("mistral_train/opt2_remat_none", "mistral-large-123b", "train_4k",
     _remat("none"), True),
    # --- cell 3: chatglm3 decode_32k --------------------------------------
    ("chatglm_decode/base_fsdp_params", "chatglm3-6b", "decode_32k",
     None, True),
    ("chatglm_decode/opt1_serve_sharding_no_fsdp", "chatglm3-6b", "decode_32k",
     None, False),
    ("chatglm_decode/opt2_replicated_decode_q", "chatglm3-6b", "decode_32k",
     None, False),
    # --- bonus cell 4: chatglm3 prefill_32k (memory-bound: S² scores) ------
    ("chatglm_prefill/base_full_attention", "chatglm3-6b", "prefill_32k",
     _attn("full"), True),
    ("chatglm_prefill/opt1_blocked_attention", "chatglm3-6b", "prefill_32k",
     _attn("blocked"), True),
]


def missing_knob(arch: str, transform) -> str:
    """Why the port's config cannot take ``transform`` ('' if it can)."""
    from repro_torch.configs import get_config

    if transform is None:
        return ""
    cfg = get_config(arch)
    for knob in getattr(transform, "knobs", [getattr(transform, "knob", ())]):
        node = cfg
        for name in knob:
            if node is None or not hasattr(node, name):
                return f"the port's config has no {'.'.join(knob)}"
            node = getattr(node, name)
    return ""


def main(argv=None):
    from repro_torch.launch.dryrun import run_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    RESULTS.mkdir(parents=True, exist_ok=True)
    for name, arch, shape, transform, fsdp in VARIANTS:
        if args.only and not name.startswith(args.only):
            continue
        path = RESULTS / (name.replace("/", "__") + ".json")
        if path.exists() and not args.force:
            continue
        why = missing_knob(arch, transform)
        if why:
            rec = {"variant": name, "status": "skipped", "reason": why}
            print(f"[{name}] SKIPPED: {why}")
            path.write_text(json.dumps(rec, indent=2))
            continue
        try:
            rec = run_cell(arch, shape, "single", cfg_transform=transform, fsdp=fsdp,
                           verbose=False)
            rec["variant"] = name
            rl = rec.get("roofline", {})
            pccl = rec.get("pccl_pricing", {})
            if rec.get("status") == "ok":
                print(f"[{name}] compute={rl['compute_s']*1e3:.1f}ms "
                      f"memory={rl['memory_s']*1e3:.1f}ms "
                      f"collective={rl['collective_s']*1e3:.1f}ms "
                      f"dominant={rl['dominant']} useful={rec['useful_ratio']:.3f} "
                      f"pccl_comm={pccl.get('pccl_comm_s', 0.0)*1e3:.1f}ms")
        except Exception as e:
            rec = {"variant": name, "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()[-3000:]}
            print(f"[{name}] FAILED: {e}")
        path.write_text(json.dumps(rec, indent=2))


if __name__ == "__main__":
    main()
