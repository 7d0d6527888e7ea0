"""Multi-pod dry run: per-rank FLOPs, collective bytes and memory of every
(architecture × applicable input shape × mesh) cell, on no device
(``repro.launch.dryrun``).

Each cell runs its step function eagerly — ``train_step`` for train shapes,
``prefill`` for prefill shapes, ``decode_step`` for decode shapes — on
DTensors of the cell's global shapes, placed by the sharding rules on a
16 × 16 (``single``, 256 ranks) or 2 × 16 × 16 (``multi``, 512 ranks)
mesh over a fake process group, with each rank's shards on the meta
device: nothing is allocated and no byte moves
(:mod:`repro_torch.launch.specs`).  :func:`repro_torch.launch.roofline.count_step`
counts one rank's FLOPs, HBM bytes (an estimate) and collective wire bytes
by op.  Each record holds:

* the roofline (H100 SXM constants) and MODEL_FLOPS;
* collective bytes and counts by op, and their PCCL pricing
  (:func:`repro_torch.launch.perf.pccl_pricing`);
* the reference's ``memory_analysis`` fields per rank, from the live
  bytes of the rank's local tensors over the step
  (:class:`repro_torch.launch.roofline.LiveBytes`): arguments, outputs,
  temporaries (the peak less the arguments) and outputs aliased to
  arguments; whether arguments and temporaries fit an 80 GB card; and
  beside them the bytes of the parameters, their gradients, AdamW's two
  fp32 moments and the decode state, from the placements.  The lifetimes
  are eager execution's, not XLA's buffer assignment after fusion.

Families whose full depth is slow to count eagerly (the SSD scan's and the
sLSTM's loops: hybrid and ssm) and configs of more than 32 layers are
counted at two depths and extrapolated linearly (the reference's
``depth_points``; :func:`count_full` counts every layer on request).  The
sLSTM's loop body is counted once, plus ``_slstm_correction_flops``, as
the reference counts its scan.

Records go to ``results/torch_dryrun/<arch>__<shape>__<mesh>.json``, or
under ``--out`` (existing ones are skipped unless ``--force``).

Usage:
  python -m repro_torch.launch.dryrun --arch zamba2-2.7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --reduced [--arch ARCH]
  python -m repro_torch.launch.dryrun --all
  python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import pathlib
import time
import traceback
from dataclasses import replace
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import (
    init_fake_world,
    make_mesh,
    make_production_mesh,
    production_shape,
)
from repro_torch.launch.perf import pccl_pricing
from repro_torch.launch.specs import (
    batch_specs,
    decode_specs,
    decode_state_specs,
    local_numel,
    param_specs,
    state_specs,
    whole_shapes,
)
from repro_torch.models import build_model
from repro_torch.models import ssm as SSM
from repro_torch.models.module import ParamSpec, children, param_count
from repro_torch.sharding import default_rules, use_partitioning
from repro_torch.sharding.rules import clear_caches
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "torch_dryrun"
CARD_BYTES = 80e9            # one H100's HBM
MAX_FULL_DEPTH_LAYERS = 32   # deeper configs are counted at two depths


def _quiet() -> None:
    """DTensor warns once per suboptimal redistribution it plans; the
    counts record them all."""
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)


def fake_world(n: int) -> None:
    """Make the default process group a fake one of ``n`` ranks.  DTensor's
    caches of placements are emptied with the old group: a mesh of the new
    one compares equal to an old mesh of the same shape, and a cached
    placement would carry the old mesh's (destroyed) process groups."""
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    clear_caches()
    init_fake_world(n)


@contextlib.contextmanager
def _slstm_body_once():
    """The sLSTM's step loop dispatches one cell a layer: each later step of
    a layer returns the first step's output without running (the reference's
    HLO count sees a scan body once; ``_slstm_correction_flops`` adds the
    rest).  The first step is kept for one call of ``apply_slstm`` only: the
    backward's recompute of a layer (``_remat``) runs its own first cell and
    saves what the forward saved, and nothing outlives the layer."""
    cell, apply = SSM._slstm_cell, SSM.apply_slstm
    first: list = []

    def once(p, pre_x, st):
        if not first:
            first.append(cell(p, pre_x, st))
        return first[0]

    def layer(*args, **kw):
        first.clear()
        try:
            return apply(*args, **kw)
        finally:
            first.clear()

    SSM._slstm_cell, SSM.apply_slstm = once, layer
    try:
        yield
    finally:
        SSM._slstm_cell, SSM.apply_slstm = cell, apply


def _placed_states(model, mesh, rules) -> None:
    """Make ``model``'s prefill build its cache (and an encoder-decoder's
    self-attention cache) as placed meta DTensors: only each rank's part is
    made, as the count's live bytes should see it, not a whole state first."""
    fresh = build_model(model.cfg)
    model.init_decode_state = (
        lambda b, t, device=None: decode_state_specs(fresh, b, t, mesh, rules))
    if hasattr(fresh, "_self_cache"):
        axes = fresh.decode_state_axes()["self"]

        def self_cache(b, t, device=None):
            with whole_shapes():
                whole = fresh._self_cache(b, t, "meta")
            return state_specs(whole, axes, mesh, rules)

        model._self_cache = self_cache


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, rules, *,
               microbatches: int = 1, max_len: Optional[int] = None) -> R.StepCount:
    """One rank's count of the cell's step at ``cfg``'s depth (a train
    step in ``microbatches``; a prefill with a cache of ``max_len``)."""
    model = build_model(cfg)
    slstm = _slstm_body_once() if cfg.xlstm else contextlib.nullcontext()
    with use_partitioning(mesh, rules), implicit_replication(), slstm:
        params, _ = param_specs(cfg, mesh, rules)
        if shape.kind == "train":
            step = make_train_step(model, OptimizerConfig(), microbatches=microbatches)
            opt_state = init_opt_state(params)
            batch = batch_specs(cfg, shape, mesh, rules)
            with R.count_step(params, opt_state, batch) as count:
                count.memory.returned(step(params, opt_state, batch))
        elif shape.kind == "prefill":
            batch = batch_specs(cfg, shape, mesh, rules)
            _placed_states(model, mesh, rules)
            with torch.no_grad(), R.count_step(params, batch) as count:
                count.memory.returned(model.prefill(params, batch, max_len=max_len))
        else:  # decode
            tokens, state = decode_specs(cfg, shape, mesh, rules)
            with torch.no_grad(), R.count_step(params, state, tokens) as count:
                count.memory.returned(model.decode_step(params, state, tokens))
    return count


def _extrapolate(m1: float, m2: float, v1: int, v2: int, v: int) -> float:
    b = (m2 - m1) / (v2 - v1)
    return m1 - b * v1 + b * v


def use_depth_points(cfg: ModelConfig, depth: str) -> bool:
    if depth == "full":
        return False
    if depth == "points":
        return True
    return bool(cfg.hybrid or cfg.xlstm) or cfg.n_layers > MAX_FULL_DEPTH_LAYERS


def _fields(c: R.StepCount) -> Dict:
    return {"flops": c.flops, "hbm_bytes": c.hbm_bytes, **c.memory.analysis(),
            "peak_bytes": c.memory.peak}


def _peak_by_op(c: R.StepCount) -> Dict[str, int]:
    return dict(c.memory.peak_by_op)


def count_full(cfg: ModelConfig, shape: ShapeConfig, mesh, rules, depth: str = "auto",
               **step) -> Dict:
    """The cell's per-rank count at full depth: counted, or extrapolated
    from two depths (``depth_points``), the memory fields as the FLOPs.
    ``step`` goes to :func:`count_cell`."""
    if not use_depth_points(cfg, depth):
        c = count_cell(cfg, shape, mesh, rules, **step)
        return {"depth": {"full": cfg.n_layers}, **_fields(c),
                "bytes_by_op": dict(c.stats.bytes_by_op), "count_by_op": dict(c.stats.count_by_op),
                "fallbacks": c.fallbacks, "fallback_ops": dict(c.fallback_ops),
                "peak_by_op": _peak_by_op(c)}
    points, v_full = R.depth_points(cfg)
    v1, v2 = sorted(points)
    c1, c2 = (count_cell(points[v], shape, mesh, rules, **step) for v in (v1, v2))

    def by(name):
        d1, d2 = getattr(c1.stats, name), getattr(c2.stats, name)
        return {k: _extrapolate(d1.get(k, 0), d2.get(k, 0), v1, v2, v_full)
                for k in sorted(set(d1) | set(d2))}

    f1, f2 = _fields(c1), _fields(c2)
    return {
        "depth": {"points": [v1, v2], "v_full": v_full},
        **{k: _extrapolate(f1[k], f2[k], v1, v2, v_full) for k in f1},
        "bytes_by_op": by("bytes_by_op"),
        "count_by_op": by("count_by_op"),
        "fallbacks": c1.fallbacks + c2.fallbacks,
        "fallback_ops": {k: c1.fallback_ops.get(k, 0) + c2.fallback_ops.get(k, 0)
                         for k in set(c1.fallback_ops) | set(c2.fallback_ops)},
        # the deeper point's: extrapolated bytes have no op
        "peak_by_op": _peak_by_op(c2),
    }


def _state_bytes(state_shapes, axes, mesh, rules) -> int:
    if isinstance(state_shapes, torch.Tensor):
        return local_numel(state_shapes.shape, axes, mesh, rules) * state_shapes.element_size()
    if isinstance(state_shapes, dict):
        return sum(_state_bytes(v, axes[k], mesh, rules) for k, v in state_shapes.items())
    return sum(_state_bytes(v, a, mesh, rules) for v, a in zip(state_shapes, axes))


MEMORY_FIELDS = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                 "alias_size_in_bytes")


def memory_per_rank(cfg: ModelConfig, shape: ShapeConfig, mesh, rules, counted: Dict) -> Dict:
    """Bytes rank 0 holds: the reference's ``memory_analysis`` fields from
    the count (``counted``, :func:`count_full`'s record), and whether the
    arguments and the peak of temporaries fit an 80 GB card; beside them,
    from the placements, the parameters (fp32), their gradients (the
    port's step keeps them until the update), AdamW's two fp32 moments and,
    for decode cells, the decode state."""
    model = build_model(cfg)
    specs = model.specs()

    def leaves(node):
        for _, v in children(node):
            if isinstance(v, ParamSpec):
                yield v
            else:
                yield from leaves(v)

    params = 4 * sum(local_numel(s.full_shape, s.full_axes, mesh, rules) for s in leaves(specs))
    out = {"params": params}
    if shape.kind == "train":
        out["grads"] = params
        out["adam_moments"] = 2 * params
    if shape.kind == "decode":
        state = model.init_decode_state(shape.global_batch, shape.seq_len, device="meta")
        out["decode_state"] = _state_bytes(state, model.decode_state_axes(), mesh, rules)
    out.update({k: counted[k] for k in MEMORY_FIELDS})
    if "peak_by_op" in counted:
        out["peak_by_op"] = counted["peak_by_op"]
    total = counted["argument_size_in_bytes"] + counted["temp_size_in_bytes"]
    out.update(total=total, card_bytes=CARD_BYTES, fits=total <= CARD_BYTES)
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, verbose: bool = True,
             cfg_transform=None, fsdp: bool = True) -> Dict:
    cfg = get_config(arch)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}

    multi = mesh_kind == "multi"
    chips = math.prod(production_shape(multi)[0])
    fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    rules = default_rules(multi_pod=multi, fsdp=fsdp)

    t0 = time.time()
    per_rank = count_full(cfg, shape, mesh, rules)
    per_rank["flops"] += R._slstm_correction_flops(cfg, shape) / chips
    elapsed = time.time() - t0

    n_params = param_count(build_model(cfg).specs())
    n_active = R._active_params(cfg, n_params)
    mf = R.model_flops(cfg, shape, n_params, n_active)
    coll = float(sum(per_rank["bytes_by_op"].values()))
    rl = R.Roofline(flops=per_rank["flops"] * chips, hbm_bytes=per_rank["hbm_bytes"] * chips,
                    collective_bytes=coll * chips, chips=chips)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "chips": chips,
        "status": "ok",
        "n_params": n_params,
        "n_active_params": n_active,
        "count_s": round(elapsed, 2),
        "depth": per_rank["depth"],
        "slstm_body_once": bool(cfg.xlstm),
        "per_rank": {"flops": per_rank["flops"], "hbm_bytes": per_rank["hbm_bytes"],
                     "collective_bytes": coll},
        "roofline": rl.as_dict(),
        "model_flops": mf,
        "useful_ratio": mf / rl.flops if rl.flops else None,
        "collectives": {"bytes_by_op": per_rank["bytes_by_op"],
                        "count_by_op": per_rank["count_by_op"]},
        "fallbacks": {"count": per_rank["fallbacks"], "ops": per_rank["fallback_ops"]},
        "memory_per_rank": memory_per_rank(cfg, shape, mesh, rules, per_rank),
        "pccl_pricing": pccl_pricing(per_rank["bytes_by_op"], chips),
    }
    if verbose:
        by_op = " ".join(f"{k}={v:.4g}" for k, v in sorted(per_rank["bytes_by_op"].items()))
        print(
            f"[{arch} × {shape_name} × {mesh_kind}] OK count={elapsed:.1f}s "
            f"flops/rank={per_rank['flops']:.4g} hbm/rank={per_rank['hbm_bytes']:.4g}B "
            f"bytes/rank by op: {by_op} mem/rank={rec['memory_per_rank']['total']:.4g}B "
            f"fits={rec['memory_per_rank']['fits']} dominant={rl.dominant} "
            f"pccl_speedup={rec['pccl_pricing']['speedup']}"
        )
    return rec


def one_rank_roofline(cfg: ModelConfig, kind: str, batch: int, seq: int, *,
                      microbatches: int = 1, max_len: Optional[int] = None,
                      depth: str = "auto") -> Dict:
    """The roofline of one step of ``cfg`` on one card — a mesh of one
    rank, so every tensor is whole — for a measured time to stand beside:
    ``kind`` "train" (``microbatches``) or "prefill" (a cache of
    ``max_len``) at ``batch`` × ``seq`` tokens, with its ``memory_analysis``
    fields and the peak of live bytes, for a measured peak to stand beside.
    Counts the plain path (the kernels' ``ops`` never see a meta tensor)."""
    _quiet()
    fake_world(1)
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
    rules = default_rules()
    cfg = replace(cfg, use_pallas=False)
    shape = ShapeConfig(f"one_rank_{kind}", seq, batch, kind)
    t0 = time.time()
    c = count_full(cfg, shape, mesh, rules, depth, microbatches=microbatches, max_len=max_len)
    c["flops"] += R._slstm_correction_flops(cfg, shape)
    rl = R.Roofline(flops=c["flops"], hbm_bytes=c["hbm_bytes"], collective_bytes=0.0, chips=1)
    return {"arch": cfg.name, "kind": kind, "batch": batch, "seq": seq,
            "microbatches": microbatches, "max_len": max_len, "depth": c["depth"],
            "flops": c["flops"], "hbm_bytes": c["hbm_bytes"], "compute_s": rl.compute_s,
            "memory_s": rl.memory_s, "peak_bytes": c["peak_bytes"],
            **{k: c[k] for k in MEMORY_FIELDS}, "count_s": round(time.time() - t0, 2)}


REDUCED_MESH = (2, 2)               # ("data", "model") of the reduced sweep
REDUCED_BATCH, REDUCED_SEQ = 4, 32  # its cells' rows and tokens (decode: the cache's length)


def reduced_cell(arch: str, kind: str) -> Dict:
    """One cell of the reduced sweep: ``arch``'s reduced config, one
    ``kind`` step ("train", "prefill" or "decode") of ``REDUCED_BATCH`` ×
    ``REDUCED_SEQ`` on a fake ``REDUCED_MESH`` mesh.  Its status, FLOPs,
    bytes by op, temporaries and the ops that fell back; an error is
    recorded, not raised."""
    cfg = get_config(arch).reduced()
    shape = ShapeConfig(f"reduced_{kind}", REDUCED_SEQ, REDUCED_BATCH, kind)
    fake_world(math.prod(REDUCED_MESH))
    mesh = make_mesh(REDUCED_MESH, ("data", "model"), device_type="cpu")
    t0 = time.time()
    try:
        c = count_cell(cfg, shape, mesh, default_rules())
    except Exception as e:  # the record says what failed; the sweep goes on
        return {"arch": arch, "kind": kind, "status": "error", "error": repr(e)[:2000]}
    return {"arch": arch, "kind": kind, "status": "ok", "flops": c.flops,
            "bytes_by_op": dict(c.stats.bytes_by_op),
            "temp_size_in_bytes": c.memory.analysis()["temp_size_in_bytes"],
            "fallbacks": c.fallbacks, "fallback_ops": dict(c.fallback_ops),
            "count_s": round(time.time() - t0, 2)}


def reduced_sweep(archs=None, kinds=("train", "prefill", "decode")) -> list:
    """Every architecture's reduced config × ``kinds`` (:func:`reduced_cell`),
    one ``REDUCED {json}`` line printed a cell."""
    out = []
    for arch in archs or ARCH_IDS:
        for kind in kinds:
            rec = reduced_cell(arch, kind)
            print("REDUCED " + json.dumps(rec), flush=True)
            out.append(rec)
    return out


def cell_path(arch, shape_name, mesh_kind, out: pathlib.Path = RESULTS) -> pathlib.Path:
    return out / f"{arch}__{shape_name}__{mesh_kind}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=str(RESULTS), help="directory of the cells' records")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced sweep: every arch's reduced config x train, prefill and "
                         f"decode on a {REDUCED_MESH} mesh, a REDUCED json line a cell")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    if args.reduced:
        _quiet()
        try:
            recs = reduced_sweep([args.arch] if args.arch else None)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        bad = [r for r in recs if r["status"] != "ok" or r["fallbacks"]]
        print(f"reduced sweep: {len(recs)} cells, {len(bad)} failed or fell back")
        return 1 if bad else 0

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]

    if args.list:
        for a in archs:
            cfg = get_config(a)
            for s in shapes:
                ok, why = shape_applicable(cfg, SHAPES[s])
                print(f"{a:24s} {s:12s} {'RUN' if ok else 'SKIP: ' + why}")
        return 0

    _quiet()
    out.mkdir(parents=True, exist_ok=True)
    n_fail = 0
    try:
        for a in archs:
            for s in shapes:
                for m in meshes:
                    path = cell_path(a, s, m, out)
                    if path.exists() and not args.force:
                        continue
                    try:
                        rec = run_cell(a, s, m)
                    except Exception as e:  # record the failure; keep going
                        rec = {
                            "arch": a, "shape": s, "mesh": m, "status": "error",
                            "error": repr(e),
                            "traceback": traceback.format_exc()[-4000:],
                        }
                        n_fail += 1
                        print(f"[{a} × {s} × {m}] FAILED: {e}")
                    path.write_text(json.dumps(rec, indent=2))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    # the dry run touches no card: this stays 0 where there is one
    on_card = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0
    print(f"dry-run sweep complete; failures={n_fail}; "
          f"device memory allocated: {on_card} bytes")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
