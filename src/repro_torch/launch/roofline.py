"""Roofline terms of one step on a sharded mesh, counted per rank.

The port of ``repro.launch.roofline`` and of ``repro.launch.hlo_analysis``'s
``Roofline`` and ``model_flops``.  The reference lowers each cell with XLA
and reads the per-partition ``cost_analysis`` and the collectives of the
partitioned HLO.  Here the step runs eagerly on DTensors whose local shards
are meta tensors (nothing is allocated), under two dispatch modes
(:func:`count_step`):

* the outer mode sees each DTensor op with its *global* shapes.  Its FLOPs
  (``torch.utils.flop_counter``'s formulas: matmuls, convolutions,
  attention) are divided by the product of the mesh dimensions on which its
  output is ``Shard`` or ``Partial``; replicated compute stays whole on
  every rank, as XLA's per-partition count keeps it.  Its HBM bytes are an
  estimate: every non-view op reads each input's local shard once and
  writes its output's once (no fusion);
* the inner mode sees the functional collectives DTensor issues to
  redistribute, on their local tensors, and turns each result size R and
  group size S into per-rank wire bytes with the reference's ring factors
  (``_WIRE_FACTOR``);
* the inner mode also sees every local tensor an op makes, and
  :class:`LiveBytes` holds the bytes of their storages (each once, so a
  view adds nothing) until the storage dies: the rank's live bytes as the
  caching allocator would see them, and their peak over the step.  With the
  step's arguments (held on entry) and what it returns, they give the
  reference's ``memory_analysis`` fields (:meth:`LiveBytes.analysis`).

Where DTensor's sharding propagation has no rule for an op on its inputs'
placements (an uneven unflatten, say), the outer mode replicates those
inputs and runs the op again, and where even that fails, runs it on the
whole local tensors; the op's output is then split again as its first
input was, where the shapes allow (:func:`_split_like`).
:attr:`StepCount.fallbacks` counts such ops.
The XLA SPMD partitioner and DTensor choose different collectives, so the
bytes by op are not the reference's.

Hardware constants are the H100 SXM's: 989 TFLOP/s dense bf16, 3.35 TB/s
HBM, and the H100 DGX NVLink β of the cost model (450 GB/s a link).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import cost_model as cm
from repro_torch.sharding.partition import _settled

PEAK_FLOPS = 989e12                  # bf16 FLOP/s per H100 SXM (dense)
HBM_BW = 3.35e12                     # bytes/s per H100 SXM
LINK_BW = 1.0 / cm.H100_DGX.beta     # bytes/s per NVLink (450 GB/s)

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# the functional collectives DTensor issues → the reference's op names
FUNCOL_OPS = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}

_WIRE_FACTOR = {
    "all-gather": lambda S: (S - 1) / S,
    "all-reduce": lambda S: 2 * (S - 1) / S,
    "reduce-scatter": lambda S: (S - 1),
    "all-to-all": lambda S: (S - 1) / S,
    "collective-permute": lambda S: 1.0,
}


@dataclass
class CollectiveStats:
    """Per-rank *wire* bytes by collective type: from the result size R
    and the group size S, all-gather (S-1)/S·R, all-reduce 2(S-1)/S·R,
    reduce-scatter (S-1)·R, all-to-all (S-1)/S·R."""

    bytes_by_op: Dict[str, int] = field(default_factory=dict)
    count_by_op: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    def add(self, op: str, result_bytes: int, group: int) -> None:
        wire = int(result_bytes * _WIRE_FACTOR[op](group))
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) + wire
        self.count_by_op[op] = self.count_by_op.get(op, 0) + 1


@dataclass
class Roofline:
    flops: float                  # total flops (all chips)
    hbm_bytes: float              # total bytes accessed (all chips)
    collective_bytes: float       # wire bytes (all chips)
    chips: int

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def model_flops(cfg, shape, n_params: int, n_active: Optional[int] = None) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE); D = tokens."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = shape.global_batch * 1
        mult = 2.0
    n = n_active if n_active is not None else n_params
    return mult * n * tokens


def depth_points(cfg: ModelConfig) -> Tuple[Dict[int, ModelConfig], int]:
    """{v: cfg_at_depth_v}, v_full — the linear depth variable per family."""
    if cfg.xlstm:
        u = cfg.xlstm.slstm_every
        mk = lambda v: dataclasses.replace(cfg, n_layers=v * u, scan_layers=False)
        return {1: mk(1), 2: mk(2)}, cfg.n_layers // u
    if cfg.hybrid:
        u = cfg.hybrid.shared_attn_every
        mk = lambda v: dataclasses.replace(cfg, n_layers=v * u, scan_layers=False)
        return {1: mk(1), 2: mk(2)}, cfg.n_layers // u
    if cfg.enc_dec:
        mk = lambda v: dataclasses.replace(
            cfg,
            n_layers=v,
            scan_layers=False,
            enc_dec=dataclasses.replace(cfg.enc_dec, n_enc_layers=v),
        )
        return {2: mk(2), 4: mk(4)}, cfg.n_layers
    if cfg.moe and cfg.moe.first_dense:
        mk = lambda v: dataclasses.replace(
            cfg, n_layers=cfg.moe.first_dense + v, scan_layers=False
        )
        return {2: mk(2), 4: mk(4)}, cfg.n_layers - cfg.moe.first_dense
    mk = lambda v: dataclasses.replace(cfg, n_layers=v, scan_layers=False)
    return {2: mk(2), 4: mk(4)}, cfg.n_layers


def _slstm_correction_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """sLSTM time-scan body counted once: add the recurrent FLOPs
    analytically: per token ≈ 2·(4d² input proj + 4·d·dh recurrence),
    ×3 for backward in train."""
    if not cfg.xlstm or shape.kind == "decode":
        return 0.0
    d = cfg.d_model
    dh = d // cfg.n_heads
    n_slstm = cfg.n_layers // cfg.xlstm.slstm_every
    tokens = shape.global_batch * shape.seq_len
    per_tok = 2 * (4 * d * d + 4 * d * dh)
    mult = 3.0 if shape.kind == "train" else 1.0
    return mult * n_slstm * tokens * per_tok


def _active_params(cfg: ModelConfig, n_params: int) -> Optional[int]:
    if not cfg.moe:
        return None
    m = cfg.moe
    n_moe_layers = cfg.n_layers - m.first_dense
    per_expert = 3 * cfg.d_model * m.d_expert  # swiglu gate/up/down
    inactive = (m.n_experts - m.top_k) * per_expert * n_moe_layers
    return n_params - inactive


# ------------------------------------------------------------- counting


class LiveBytes:
    """The bytes of the distinct tensor storages one rank holds, each from
    the op that made it until it dies, and their peak.

    A storage is counted once, whatever views of it exist, and dropped by a
    ``weakref.finalize`` when it is freed: the lifetimes eager execution
    gives, as the caching allocator sees them (its rounding of each block
    to 512 bytes aside).  Meta storages count their bytes as real ones do.
    The step's arguments are held on entry (:meth:`hold_arguments`), what
    it returns at its end (:meth:`returned`)."""

    def __init__(self) -> None:
        self.live = 0
        self.peak = 0
        self.argument = 0
        self.output = 0
        self.alias = 0
        self._held: Dict[int, int] = {}
        self._made_by: Dict[int, str] = {}
        self._arguments: set = set()
        self._snapshot = 0
        self.peak_by_op: Dict[str, int] = {}

    def hold(self, t, op: str = "argument") -> None:
        """Count ``t``'s storage from now on, if it is not counted yet;
        ``op`` names what made it."""
        if isinstance(t, DTensor):
            t = t._local_tensor
        if not isinstance(t, torch.Tensor) or isinstance(t, FakeTensor):
            return  # DTensor's own shape inference, on a cache miss
        s = t.untyped_storage()
        key, n = s._cdata, s.nbytes()
        old = self._held.get(key)
        if old is None:
            weakref.finalize(s, self._drop, key)
        elif old == n:
            return
        self._held[key] = n
        self._made_by.setdefault(key, op)
        self.live += n - (old or 0)
        if self.live > self.peak:
            self.peak = self.live
            if self.peak > 1.01 * self._snapshot:  # a new peak, 1 % past the last kept
                self._snapshot = self.peak
                by: Dict[str, int] = {}
                for k, b in self._held.items():
                    name = "argument" if k in self._arguments else self._made_by.get(k, "?")
                    by[name] = by.get(name, 0) + b
                self.peak_by_op = dict(sorted(by.items(), key=lambda kv: -kv[1])[:6])

    def _drop(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)
        self._made_by.pop(key, None)
        self._arguments.discard(key)

    def hold_arguments(self, *trees) -> None:
        for t in _tensor_leaves(trees):
            self.hold(t)
        self._arguments = set(self._held)
        self.argument = self.live

    def returned(self, tree) -> None:
        """What the step returned and is live at its end; the part of it
        whose storage is an argument's (updated in place) is the alias."""
        keys = {}
        for t in _tensor_leaves(tree):
            t = t._local_tensor if isinstance(t, DTensor) else t
            s = t.untyped_storage()
            keys[s._cdata] = self._held.get(s._cdata, s.nbytes())
        self.output = sum(keys.values())
        self.alias = sum(n for k, n in keys.items() if k in self._arguments)

    def analysis(self) -> Dict[str, int]:
        """The reference's ``memory_analysis`` fields: arguments, outputs,
        the peak of live bytes less the arguments, and the outputs that are
        arguments updated in place."""
        return {"argument_size_in_bytes": self.argument,
                "output_size_in_bytes": self.output,
                "temp_size_in_bytes": self.peak - self.argument,
                "alias_size_in_bytes": self.alias}


def _tensor_leaves(tree):
    """The tensors of a tree of dicts, lists, tuples and modules."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)


@dataclass
class StepCount:
    """What one rank does in the counted region: FLOPs, HBM bytes (an
    estimate), collective wire bytes by op, the ops DTensor could not
    place without replicating their inputs first, and the live bytes of
    its local tensors."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    stats: CollectiveStats = field(default_factory=CollectiveStats)
    fallbacks: int = 0
    fallback_ops: Dict[str, int] = field(default_factory=dict)
    memory: LiveBytes = field(default_factory=LiveBytes)


def shard_factor(t: DTensor) -> int:
    """Product of the mesh dimensions on which ``t`` is not ``Replicate``
    (a ``Shard`` or a ``Partial``): the ways its op's work is split across
    ranks."""
    mesh = t.device_mesh
    return math.prod(
        mesh.size(i) for i, p in enumerate(t.placements) if not isinstance(p, Replicate)
    )


def _local_bytes(t) -> int:
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _replicated(x):
    if isinstance(x, DTensor) and any(not isinstance(p, Replicate) for p in x.placements):
        return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    return x


def _split_like(func, out, given):
    """What a fallen-back op hands on: an in-place op the DTensor it was
    given; otherwise its (replicated) output split again as its first
    DTensor input was — a local slice, no collective — so one op with no
    rule does not leave every later op replicated.  A dimension split in
    the input maps to the output dimension that starts at the same element
    (the same product of the sizes in front of it: a reshape keeps it) and
    divides evenly; a split with no such dimension is dropped."""
    first = next((t for t in tree_flatten(given)[0] if isinstance(t, DTensor)), None)
    if func._schema.is_mutable and isinstance(given[0], DTensor):
        return given[0]

    def split(t):
        if not isinstance(t, DTensor) or first is None or t.device_mesh != first.device_mesh:
            return t
        if any(not isinstance(p, Replicate) for p in t.placements):
            return t
        mesh = t.device_mesh
        starts = {math.prod(t.shape[:d]): d for d in range(t.ndim)}
        sizes = list(t.shape)
        place = []
        for i, p in enumerate(first.placements):
            d = starts.get(math.prod(first.shape[:p.dim])) if isinstance(p, Shard) else None
            if d is not None and sizes[d] % mesh.size(i) == 0:
                sizes[d] //= mesh.size(i)
                place.append(Shard(d))
            else:
                place.append(Replicate())
        if all(isinstance(p, Replicate) for p in place):
            return t
        return t.redistribute(mesh, place)

    return tree_map(split, out)


def _on_whole_tensors(func, given, args, kwargs):
    """The last resort, where DTensor has no rule even for replicated
    inputs (a rule's bug in some torch releases): the op on the whole
    (replicated) local tensors, its result replicated; an in-place op hands
    back the DTensor it was given."""
    mesh = next(t for t in tree_flatten((args, kwargs))[0] if isinstance(t, DTensor)).device_mesh
    local = tree_map(lambda t: t._local_tensor if isinstance(t, DTensor) else t, (args, kwargs))
    out = func(*local[0], **local[1])
    if func._schema.is_mutable and isinstance(given[0], DTensor):
        return given[0]
    whole = [Replicate()] * mesh.ndim
    return tree_map(lambda t: DTensor.from_local(t, mesh, whole, run_check=False)
                    if isinstance(t, torch.Tensor) else t, out)


_NO_BYTES = ("aten.empty", "aten.detach", "aten.alias", "aten.lift_fresh")


class _Ops(TorchDispatchMode):
    """Outer mode: one entry per op as the program issues it."""

    counts_issued_ops = True  # ``sharding.rules`` sets it aside for DTensor's own ops

    def __init__(self, count: StepCount):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fell_back = False
        try:
            out = func(*args, **kwargs)
        except Exception:
            if not any(issubclass(t, DTensor) for t in types):
                raise
            given = args
            args, kwargs = tree_map(_replicated, (args, kwargs))
            try:
                out = func(*args, **kwargs)
            except Exception:
                out = _on_whole_tensors(func, given, args, kwargs)
            fell_back = True
        out = tree_map(_settled, out)
        returned = _split_like(func, out, given) if fell_back else out
        c = self.count
        if fell_back:
            name = str(func)
            c.fallbacks += 1
            c.fallback_ops[name] = c.fallback_ops.get(name, 0) + 1
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            first = next((t for t in outs if isinstance(t, DTensor)), None)
            c.flops += flops / (shard_factor(first) if first is not None else 1)
        if not func.is_view and not str(func).startswith(_NO_BYTES):
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            c.hbm_bytes += sum(_local_bytes(t) for t in ins) + sum(_local_bytes(t) for t in outs)
        return returned


class _Collectives(TorchDispatchMode):
    """Inner mode: the functional collectives, and the storage of every
    tensor made, on their local tensors."""

    def __init__(self, count: StepCount):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor desugars it into local ops first
        out = func(*args, **kwargs)
        for t in tree_flatten(out)[0]:
            self.count.memory.hold(t, func._overloadpacket.__name__)
        op = FUNCOL_OPS.get(func._overloadpacket.__name__)
        if op is not None and func.namespace in ("_c10d_functional", "_dtensor"):
            self.count.stats.add(op, _local_bytes(out), _group_size(func, args, kwargs))
        return out


def _group_size(func, args, kwargs) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    schema = func._schema
    names = [a.name for a in schema.arguments]
    bound = dict(zip(names, args))
    bound.update(kwargs)
    if "group_size" in bound:
        return int(bound["group_size"])
    return _resolve_process_group(bound["group_name"]).size()


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's Shard(i) → Shard(j) all-to-all as a mesh of cards issues
    it.  On a mesh of CPU ranks DTensor swaps in an all-gather and a chunk
    (gloo has no all-to-all); the dry run's mesh is a fake group of CPU
    ranks that stands for cards."""
    group = mesh.get_group(mesh_dim)
    return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim, group.group_name)


@contextlib.contextmanager
def count_step(*arguments) -> Iterator[StepCount]:
    """Count what one rank does in the block (see the module docstring);
    ``arguments`` are the step's (held from the start), and the block hands
    what the step returns to ``count.memory.returned``."""
    from torch.distributed.tensor import placement_types

    count = StepCount()
    count.memory.hold_arguments(*arguments)
    saved = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = _shard_dim_alltoall
    try:
        with _Collectives(count), _Ops(count):
            yield count
    finally:
        placement_types.shard_dim_alltoall = saved
