"""A world of several processes on one host, one rank each, and the rank
programs the multi-process tests and the chip smoke run in it.

:func:`spawn` starts ``world`` processes with the ``spawn`` method (each
imports ``repro_torch`` afresh, never the caller's module), joins them into
one ``torch.distributed`` world on a :class:`~torch.distributed.FileStore`
under ``store_dir`` (no TCP port, so concurrent worlds never collide),
runs ``program(*args)`` in every rank and returns the ranks' results in
rank order.  A rank that raises fails the whole call with its traceback;
when ``timeout_s`` passes first, every child is killed and the call
raises, so a hung rank costs at most the timeout.

Programs are module-level functions (a child imports them by name) that
read their rank from ``torch.distributed`` and return something
picklable.  Those below build their inputs from a seed with numpy, the
same in every process, so the caller can hold each rank's result against
an oracle it computes itself.
"""

from __future__ import annotations

import faulthandler
import logging
import os
import queue
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device


def _child(program: Callable, rank: int, world: int, store_path: str, backend: str,
           args: Tuple, kwargs: Dict, results, threads: Optional[int]) -> None:
    faulthandler.enable()  # a rank that crashes prints where
    try:
        if threads:
            torch.set_num_threads(threads)
        if backend == "nccl" or os.environ.get("CUDA_VISIBLE_DEVICES", None) != "":
            if torch.cuda.is_available():
                torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, rank=rank, world_size=world, store=store)
        try:
            results.put((rank, True, program(*args, **kwargs)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))


def spawn(program: Callable, world: int, args: Sequence = (), kwargs: Optional[Dict] = None,
          *, store_dir: str, backend: str = "gloo", timeout_s: float = 300.0,
          threads: Optional[int] = 1) -> List[Any]:
    """``program(*args, **kwargs)`` in each of ``world`` fresh processes joined into
    one world (``backend``); returns the results in rank order.  ``threads``
    caps each child's intra-op threads (``None`` keeps torch's default)."""
    os.makedirs(store_dir, exist_ok=True)
    store_path = os.path.join(store_dir, f"store_{os.getpid()}_{time.monotonic_ns()}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(program, r, world, store_path, backend,
                                              tuple(args), dict(kwargs or {}), results, threads),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, Tuple[bool, Any]] = {}
    deadline = time.monotonic() + timeout_s
    try:
        # drain before joining: a child blocks on a full queue until read
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(got)} of {world} ranks did not finish in "
                                   f"{timeout_s:.0f} s (ranks {sorted(set(range(world)) - set(got))})")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive() and p.exitcode != 0]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited with codes "
                                       f"{[procs[r].exitcode for r in dead]} and no result")
                continue
            got[rank] = (ok, value)
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()) or 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
        if os.path.exists(store_path):
            os.remove(store_path)
    return [got[r][1] for r in range(world)]


# ------------------------------------------------------------ rank programs


def loaded_modules() -> List[str]:
    """The names of the modules this rank has imported."""
    import sys

    return sorted(sys.modules)


def local_input(case: Dict, rank: int) -> np.ndarray:
    """Rank ``rank``'s fp32 operand of a collective case, from the case's
    seed and the rank (each rank draws only its own)."""
    rng = np.random.default_rng((case["seed"], rank))
    return rng.standard_normal(size=tuple(case["local"]), dtype=np.float32)


def side_input(case: Dict) -> np.ndarray:
    """A fused case's replicated second operand (``w`` or ``gamma``)."""
    rng = np.random.default_rng((case["seed"], 2**31 - 1))  # no rank draws this stream
    return rng.standard_normal(size=tuple(case["side"]), dtype=np.float32)


def stacked_input(case: Dict) -> np.ndarray:
    """The rank-stacked operand: row ``r`` is :func:`local_input` of rank ``r``."""
    return np.stack([local_input(case, r) for r in range(case["n"])])


def case_schedule(case: Dict, schedules):
    """The case's schedule, built by ``schedules`` (this package's module or
    the reference's, for the oracle): ``case["build"]`` names a generator
    and its arguments after ``n``, with ``"nbytes"`` for the local bytes."""
    name, *rest = case["build"]
    nbytes = float(np.prod(case["local"])) * 4
    return getattr(schedules, name)(*[nbytes if a == "nbytes" else a for a in rest])


def collectives_program(cases: Sequence[Dict], device: Optional[str] = None, reps: int = 0,
                        digest: bool = False) -> Dict[str, Any]:
    """Each case on this rank's :func:`local_input`.

    A case names its ``path``: ``"prim"`` runs
    ``primitives.<collective>(x, schedule, group)`` on :func:`case_schedule`
    (``"reference"``: ``primitives.run_reference``); ``"schedule"`` runs
    ``primitives.execute_schedule`` on :func:`hand_schedule`; ``"comm"``
    runs a communicator of a session bound to the world (``backend``,
    ``algorithm``, optional split ``colors``); ``"ef8"`` runs
    ``compressed_all_reduce_ef`` for ``case["steps"]`` steps (the sums, then
    the last residual); ``"fused_mm_rs"`` and ``"fused_ar_rms"`` run the two
    fused seams and their unfused compositions on the communicator (``w``
    and ``gamma`` from ``seed + 1``; ``dtype`` casts the operands).

    Returns ``{"cases": [...], "route_rounds", "staged_bytes"}``: per case
    its output as numpy, or with ``digest`` its shape, dtype and the
    SHA-256 of its bytes (fused cases: ``(fused, unfused)``), or the
    ``ScheduleExecutionError`` text it raised; the kernels' launches of its
    first call, by route; and with ``reps`` (or the case's own ``reps``)
    the mean ms of that many more calls, each ending in a device sync.  The
    routes and staged bytes count every call, the timed ones too.  On the
    rank's CUDA device unless ``device`` names another."""
    from repro_torch.api import PcclSession
    from repro_torch.comm import exec_engine
    from repro_torch.comm import primitives as P
    from repro_torch.comm.errors import ScheduleExecutionError
    from repro_torch.comm.fusion import fused_all_reduce_rmsnorm, fused_matmul_reduce_scatter
    from repro_torch.comm.pccl_collectives import ErrorFeedbackState, compressed_all_reduce_ef
    from repro_torch.core import cost_model as cm
    from repro_torch.core import schedules as S
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    group = dist.group.WORLD
    me = dist.get_rank()
    device = resolve_device(device)
    exec_engine.clear_exec_caches()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    results: List[Dict[str, Any]] = []
    for case in cases:
        dtype = getattr(torch, case.get("dtype", "float32"))
        x = torch.as_tensor(local_input(case, me), device=device).to(dtype)
        comm = None
        if case["path"] in ("comm", "fused_mm_rs", "fused_ar_rms"):
            session = PcclSession(getattr(cm, case.get("hw", "TPU_V5E_PHOTONIC")), device=device)
            comm = session.communicator(group, backend=case.get("backend", "interp"),
                                        algorithm=case.get("algorithm", "auto"),
                                        rel_error_tol=case.get("rel_error_tol"))
            if case.get("colors"):
                comm = comm.split(case["colors"])
        if case["path"] in ("fused_mm_rs", "fused_ar_rms"):
            side = torch.as_tensor(side_input(case), device=device).to(dtype)

        def run():
            path = case["path"]
            if path == "prim":
                return getattr(P, case["collective"])(x, case_schedule(case, S), group)
            if path == "reference":
                return P.run_reference(case["collective"], x, case_schedule(case, S), group)
            if path == "schedule":
                return P.execute_schedule(x.clone(), hand_schedule(case, S), group)
            if path == "comm":
                return getattr(comm, case["collective"])(x)
            if path == "ef8":
                ef = ErrorFeedbackState.init(x.shape, device=device)
                sums = []
                for _ in range(case["steps"]):
                    red, ef = compressed_all_reduce_ef(x, ef, case["n"], group)
                    sums.append(red)
                return torch.stack(sums + [ef.residual])
            if path == "fused_mm_rs":
                return fused_matmul_reduce_scatter(comm, x, side)
            if path == "fused_ar_rms":
                return fused_all_reduce_rmsnorm(comm, x, side)
            raise ValueError(path)

        def unfused():
            if case["path"] == "fused_mm_rs":
                from repro_torch.kernels.matmul.ops import matmul

                return comm.reduce_scatter(matmul(x, side))
            return rmsnorm(comm.all_reduce(x), side)

        entry: Dict[str, Any] = {}
        keep = digest_of if digest else _host
        try:
            before = _launches(LAUNCHES)
            got = run()
            after = _launches(LAUNCHES)
            entry["launches"] = {k: {r: after[k][r] - before[k][r] for r in after[k]} for k in after}
            if case["path"].startswith("fused"):
                entry["out"] = (keep(got), keep(unfused()))
            else:
                entry["out"] = keep(got)
            if comm is not None:
                entry["algorithm"] = comm.chosen_algorithm(
                    "reduce_scatter" if case["path"] == "fused_mm_rs" else
                    "all_reduce" if case["path"] == "fused_ar_rms" else case["collective"],
                    float(x.numel() * x.element_size()
                          * (comm.n if case.get("collective") == "all_gather" else 1)))
            timed = case.get("reps", reps)
            if timed:
                sync()
                t0 = time.perf_counter()
                for _ in range(timed):
                    run()
                sync()
                entry["ms"] = (time.perf_counter() - t0) * 1e3 / timed
        except ScheduleExecutionError as e:
            entry["out"] = f"ScheduleExecutionError: {e}"
        results.append(entry)
    stats = exec_engine.exec_stats()
    return {"cases": results, "route_rounds": dict(stats.route_rounds),
            "staged_bytes": stats.staged_bytes}


def _launches(counts) -> Dict[str, Dict[str, int]]:
    return {k: counts.by_route(k) for k in counts.totals()}


def digest_of(t: torch.Tensor) -> Tuple[Tuple[int, ...], str, str]:
    """``t``'s shape, dtype and the SHA-256 of its bytes: equal digests are
    equal bits."""
    import hashlib

    t = t.detach().contiguous().cpu()
    raw = t.view(torch.uint8) if t.dtype != torch.bool else t.to(torch.uint8)
    return tuple(t.shape), str(t.dtype), hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def _host(t: torch.Tensor) -> np.ndarray:
    """A result as numpy, bf16 as fp32 (numpy holds no bf16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def hand_schedule(case: Dict, schedules):
    """A schedule from ``case["rounds"]``: each round a list of ``(src, dst,
    chunk)`` transfers and a reduce flag, one chunk a transfer."""
    rounds = []
    for transfers, reduce in case["rounds"]:
        rounds.append(schedules.Round(tuple(
            schedules.Transfer(src, dst, chunks=(c,), reduce=reduce)
            for src, dst, c in transfers), 1.0))
    return schedules.Schedule(case["collective"], "hand", case["n"], 1.0, tuple(rounds))


def gloo_cuda_program(what: str) -> List[float]:
    """What gloo does with a CUDA tensor of 4 values ``rank + 1`` in this
    torch build: ``"p2p"`` sends it to the next rank with
    ``dist.batch_isend_irecv`` (the call the process-group executor stages
    instead); ``"dtensor_gather"`` all-gathers it as a DTensor sharded over
    a one-axis mesh; ``"dtensor_gather_staged"`` the same inside
    :func:`~repro_torch.comm.exec_engine.staged_functional_collectives`.
    Returns what this rank got."""
    import contextlib

    from repro_torch.comm import exec_engine

    me, n = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(me + 1), device="cuda")
    if what == "p2p":
        recv = torch.empty_like(x)
        for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, (me + 1) % n),
                                            dist.P2POp(dist.irecv, recv, (me - 1) % n)]):
            work.wait()
        out = recv
    else:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Shard

        mesh = init_device_mesh("cuda", (n,))
        staged = (exec_engine.staged_functional_collectives() if what.endswith("_staged")
                  else contextlib.nullcontext())
        with staged:
            out = DTensor.from_local(x, mesh, [Shard(0)]).full_tensor()
    torch.cuda.synchronize()
    return out.cpu().tolist()


def elastic_program(device: Optional[str] = None) -> Dict[str, Any]:
    """``tests/elastic_check.py`` on 8 ranks: a ``(4, 2)`` ``("data",
    "model")`` mesh loses data slice 2, :func:`~repro_torch.runtime.fault.shrink_mesh`
    gives ``(3, 2)``, :func:`~repro_torch.runtime.fault.reshard_tree` moves
    ``w`` (8 × 8, split over both axes) and ``b`` (4 × 8, over "model"),
    and a step (× 2) runs on the survivors (on the rank's CUDA device unless
    ``device`` names another).  Returns what a survivor sees (``None``
    values on a failed rank)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.runtime.fault import reshard_tree, shrink_mesh
    from repro_torch.sharding.partition import Sharding, placements

    device = resolve_device(device)
    mesh = init_device_mesh(device.type, (4, 2), mesh_dim_names=("data", "model"))
    sh = {"w": Sharding(mesh, (("data",), ("model",))), "b": Sharding(mesh, (None, ("model",)))}
    whole = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones(4, 8)}
    tree = {k: distribute_tensor(v.to(device), mesh, placements(sh[k].spec, v.ndim, mesh),
                                 src_data_rank=None) for k, v in whole.items()}
    failed = mesh.mesh[2].flatten().tolist()
    new_mesh = shrink_mesh(mesh, failed, ("data", "model"), shrink_axis="data")
    new_tree = reshard_tree(tree, sh, new_mesh)
    out: Dict[str, Any] = {"shape": dict(zip(new_mesh.mesh_dim_names, new_mesh.mesh.shape)),
                           "failed": dist.get_rank() in failed}
    if out["failed"]:
        return out
    stepped = {k: v * 2.0 for k, v in new_tree.items()}  # training continues
    out["w"] = new_tree["w"].full_tensor().cpu().numpy()
    # per mesh dimension: the tensor dimension it splits, None where replicated
    out["w_split"] = [getattr(p, "dim", None) for p in new_tree["w"].placements]
    out["b_stepped"] = stepped["b"].full_tensor().cpu().numpy()
    return out


def trainer_program(cfg, data_cfg, opt_cfg, trainer_cfg, *, mesh_shape: Tuple[int, ...],
                    rules, device: Optional[str] = None, ckpt_dir: Optional[str] = None,
                    fail_at: Sequence[int] = (), shrink: bool = False) -> Dict[str, Any]:
    """The :class:`~repro_torch.train.Trainer` on a ``("data", "model")``
    mesh of ``mesh_shape`` over the world (checkpoints under ``ckpt_dir``,
    failures injected at ``fail_at``), on the rank's CUDA device unless
    ``device`` names another.  Returns each step's loss and wall,
    the kernels' launches by route in this process, and on CUDA its peak
    memory.  With ``shrink``, data slice 1 then "fails": the mesh shrinks
    (:func:`~repro_torch.runtime.fault.shrink_mesh`), the parameters and
    moments are re-sharded onto it, and the survivors run one more step;
    the result then also says whether every re-sharded value is
    bit-identical and gives that step's loss."""
    from repro_torch.ckpt import CheckpointConfig
    from repro_torch.comm import exec_engine
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.fault import FailureInjector
    from repro_torch.train import Trainer

    # DTensor warns at every two-axis reduction it plans (each rank, each
    # step); the rank's log keeps its errors
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    device = resolve_device(device)
    mesh = make_mesh(tuple(mesh_shape), ("data", "model")[:len(mesh_shape)],
                     device_type=device.type)
    ckpt = CheckpointConfig(ckpt_dir, async_write=True) if ckpt_dir else None
    trainer = Trainer(cfg, data_cfg, opt_cfg, trainer_cfg, ckpt_cfg=ckpt, mesh=mesh, rules=rules,
                      failure_injector=FailureInjector(tuple(fail_at)), device=device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    LAUNCHES.reset()
    exec_engine.clear_exec_caches()
    t0 = time.perf_counter()
    run = trainer.run()
    stats = exec_engine.exec_stats()
    out: Dict[str, Any] = {
        "wall_s": time.perf_counter() - t0,
        "steps": [h["step"] for h in run["history"]],
        "losses": [h["loss"] for h in run["history"]],
        "step_time_s": [h["step_time_s"] for h in run["history"]],
        "launches": {k: LAUNCHES.by_route(k) for k in LAUNCHES.totals()},
        "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
        "ckpt_steps": trainer.ckpt.steps() if trainer.ckpt is not None else [],
        "resumed_from": list(trainer.resumed_from),
        "route_rounds": dict(stats.route_rounds),
        "staged_bytes": stats.staged_bytes,
    }
    if shrink:
        with trainer._wire():
            out.update(_shrink_and_step(trainer, mesh, run["params"], run["opt_state"]))
    return out


def serve_inputs(cfg, batch: int, prompt: int, seed: int) -> Dict[str, np.ndarray]:
    """A prefill's inputs from ``seed``: prompt tokens, and an
    encoder-decoder's frames or a VLM's image embeddings (fp32)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(batch, prompt)).astype(np.int64)}
    if cfg.enc_dec:
        out["enc_frames"] = rng.standard_normal(
            (batch, cfg.enc_dec.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.vlm:
        out["img_embeds"] = rng.standard_normal(
            (batch, cfg.vlm.n_img_tokens, cfg.d_model)).astype(np.float32)
    return out


def serve_program(cfg, *, batch: int, prompt: int, steps: int, max_len: int, seed: int = 0,
                  mesh_shape: Optional[Tuple[int, ...]] = None, rules=None,
                  device: Optional[str] = None) -> Dict[str, Any]:
    """The model's own ``prefill`` of :func:`serve_inputs` and ``steps``
    greedy ``decode_step`` s, with the weights the ``Trainer`` draws from
    ``seed``; on a ``("data", "model")`` mesh of ``mesh_shape`` over the
    world (parameters, inputs and the decode state placed by ``rules``), or
    with ``mesh_shape`` None in this process alone.  Returns every step's
    logits and the last decode state's leaves, whole, as numpy (bf16 as
    fp32), the greedy tokens, the kernels' launches by route and the wall.
    On the rank's CUDA device unless ``device`` names another."""
    import contextlib

    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.comm import exec_engine
    from repro_torch.kernels.build import LAUNCHES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.module import axes_of, shapes_of
    from repro_torch.sharding import partition
    from repro_torch.train.trainer import _place

    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    device = resolve_device(device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed), device)
    act = cfg.act_dtype()
    inputs = {k: torch.as_tensor(v, device=device).to(torch.int64 if k == "tokens" else act)
              for k, v in serve_inputs(cfg, batch, prompt, seed).items()}
    ctx = contextlib.ExitStack()
    place = lambda t: t  # noqa: E731
    if mesh_shape is not None:
        mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device_type=device.type)
        specs = model.specs()
        _place(params, partition.param_sharding(axes_of(specs), mesh, rules,
                                                shapes_tree=shapes_of(specs)), mesh)

        def place(t):
            with partition.use_partitioning(mesh, rules):
                spec = partition.spec_for(("batch",) + (None,) * (t.ndim - 1), tuple(t.shape))
            return distribute_tensor(t, mesh, partition.placements(spec, t.ndim, mesh),
                                     src_data_rank=None)

        ctx.enter_context(partition.use_partitioning(mesh, rules))
        ctx.enter_context(implicit_replication())
        if device.type == "cuda" and str(dist.get_backend(mesh.get_group(0))) == "gloo":
            ctx.enter_context(exec_engine.staged_functional_collectives())
    whole = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t).detach()  # noqa: E731
    LAUNCHES.reset()
    logits, tokens = [], []
    t0 = time.perf_counter()
    with ctx, torch.no_grad():
        out, state = model.prefill(params, {k: place(v) for k, v in inputs.items()},
                                   max_len=max_len)
        for i in range(steps + 1):
            last = whole(out)[:, -1].float()
            logits.append(_host(last))
            nxt = last.argmax(-1, keepdim=True)
            tokens.append(nxt[:, 0].tolist())
            if i < steps:
                out, state = model.decode_step(params, state, place(nxt))
        leaves = [_host(whole(t)) for t in _leaves(state)]
    return {"logits": logits, "tokens": tokens, "state": leaves,
            "launches": {k: LAUNCHES.by_route(k) for k in LAUNCHES.totals()},
            "wall_s": time.perf_counter() - t0}


def loss_program(cfg, *, batch: int, seq: int, seed: int = 0,
                 mesh_shape: Optional[Tuple[int, ...]] = None, rules=None,
                 device: Optional[str] = None) -> Dict[str, Any]:
    """``model.loss`` and every parameter's gradient on a batch of
    :func:`serve_inputs` (``batch`` rows of ``seq`` tokens), with the
    weights the ``Trainer`` draws from ``seed``, placed as
    :func:`serve_program` places them (``mesh_shape`` None: this process
    alone).  Returns the loss and the gradients, whole, as numpy."""
    import contextlib

    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.module import axes_of, shapes_of
    from repro_torch.sharding import partition
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.trainer import _place

    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    device = resolve_device(device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed), device)
    act = cfg.act_dtype()
    inputs = {k: torch.as_tensor(v, device=device).to(torch.int64 if k == "tokens" else act)
              for k, v in serve_inputs(cfg, batch, seq, seed).items()}
    ctx = contextlib.ExitStack()
    if mesh_shape is not None:
        mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device_type=device.type)
        specs = model.specs()
        _place(params, partition.param_sharding(axes_of(specs), mesh, rules,
                                                shapes_tree=shapes_of(specs)), mesh)
        with partition.use_partitioning(mesh, rules):
            inputs = {k: distribute_tensor(v, mesh, partition.placements(partition.spec_for(
                ("batch",) + (None,) * (v.ndim - 1), tuple(v.shape)), v.ndim, mesh),
                src_data_rank=None) for k, v in inputs.items()}
        ctx.enter_context(partition.use_partitioning(mesh, rules))
        ctx.enter_context(implicit_replication())
    p = leaves(params)
    for t in p.values():
        t.requires_grad_(True)
    with ctx:
        loss, _ = model.loss(params, inputs)
        loss.backward()
    whole = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t).detach()  # noqa: E731
    return {"loss": float(whole(loss)), "grads": {k: _host(whole(t.grad)) for k, t in p.items()}}


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        for v in tree:
            yield from _leaves(v)


def _shrink_and_step(trainer, mesh, params, opt_state) -> Dict[str, Any]:
    """Data slice 1 fails: shrink, re-shard, and one step on the survivors."""
    from torch import nn
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.runtime.fault import reshard_tree, shrink_mesh
    from repro_torch.sharding import partition
    from repro_torch.train.optimizer import OptState
    from repro_torch.train.train_step import make_train_step

    names = [n for n, _ in params.named_parameters()]
    tree = {"params": dict(params.named_parameters()), "mu": dict(opt_state.mu),
            "nu": dict(opt_state.nu)}
    placed = {k: {n: trainer._shardings[n] for n in names} for k in tree}
    before = {k: {n: t.full_tensor() for n, t in v.items()} for k, v in tree.items()}
    failed = mesh.mesh[1].flatten().tolist()
    new_mesh = shrink_mesh(mesh, failed, mesh.mesh_dim_names, shrink_axis="data")
    moved = reshard_tree(tree, placed, new_mesh)
    out: Dict[str, Any] = {"shrunk_shape": tuple(new_mesh.mesh.shape),
                           "failed": dist.get_rank() in failed}
    if out["failed"]:
        return out
    out["reshard_exact"] = all(torch.equal(moved[k][n].full_tensor(), before[k][n])
                               for k in tree for n in names)
    for n in names:
        owner, _, leaf = n.rpartition(".")
        module = params.get_submodule(owner) if owner else params
        module._parameters[leaf] = nn.Parameter(moved["params"][n], requires_grad=False)
    state = OptState(opt_state.step, moved["mu"], moved["nu"])
    trainer.mesh = new_mesh
    step = make_train_step(trainer.model, trainer.opt_cfg, microbatches=trainer.tcfg.microbatches)
    with partition.use_partitioning(new_mesh, trainer.rules), implicit_replication():
        batch = trainer._batch(trainer.tcfg.total_steps)
        _, _, metrics = step(params, state, batch)
        out["survivor_loss"] = float(metrics["loss"].full_tensor())
    return out
