"""Sharded checkpointing: npz shards + manifest, async writes, keep-k GC.

A port of ``repro.ckpt.checkpoint`` with the same layout on disk::

    <dir>/step_000123/
        manifest.json          # leaf names, shapes, dtypes, step, extra
        shard_00000.npz        # the leaves in order (chunked by byte budget)
        ...
        COMMIT                 # written last → atomic validity marker

A write goes to ``.tmp_step_%09d`` and is renamed into place, so restore
picks the newest step with a COMMIT marker and a crash mid-write is never
resumed from.  Async mode hands host copies of the leaves to a writer
thread so the train loop keeps going; ``wait()`` joins before the next save
or a restore and raises the writer's error, if it had one.

A tree is tensors in nested dicts, lists, tuples and named tuples, or a
:class:`~repro_torch.models.module.ParamTree` — a train state is
``(params, opt_state)``.  Its leaves go in the order ``jax.tree.flatten``
gives the same tree (dict keys sorted, sequences and named-tuple fields in
order), named by their paths joined with ``.``; the manifest holds those
``names`` where the reference writes JAX's treedef string.

The host copy is explicit: the reference gets one from ``np.asarray`` of
an immutable array, while a CPU tensor's ``.cpu()`` is the same storage,
which AdamW then updates in place under the writer's feet.  Each leaf is
copied to the host with a blocking copy before the writer starts.

On a mesh of several processes (``group``), a tree's DTensor leaves are
gathered whole by every rank, rank 0 of the group alone writes, in the
same layout, and :meth:`CheckpointManager.wait` ends with a barrier, so
no rank looks for the newest step before the writer has committed it;
:meth:`CheckpointManager.restore` reads the whole arrays on every rank and
keeps each rank's part of a DTensor leaf.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.module import ParamTree

# torch dtypes numpy can hold; anything else (bfloat16 first) raises at save
NUMPY_DTYPES = frozenset({
    torch.float64, torch.float32, torch.float16, torch.int64, torch.int32, torch.int16,
    torch.int8, torch.uint8, torch.bool, torch.complex64, torch.complex128,
})


@dataclass
class CheckpointConfig:
    directory: str
    keep: int = 3
    async_write: bool = True
    shard_bytes: int = 1 << 30  # 1 GiB per npz shard


def flatten(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of every leaf of ``tree``, in ``jax.tree.flatten``'s
    order for the same tree."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, ParamTree):
        keys = tree.keys() if tree.is_list else sorted(tree.keys())
        items = [(k, tree[k]) for k in keys]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif isinstance(tree, Mapping):
        items = [(k, tree[k]) for k in sorted(tree)]
    else:
        raise TypeError(f"checkpoint leaf {prefix!r} is a {type(tree).__name__}, not a tensor")
    out: List[Tuple[str, torch.Tensor]] = []
    for k, v in items:
        out.extend(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _host_copy(name: str, t: torch.Tensor) -> np.ndarray:
    """A numpy array of ``t``'s values that no later in-place update reaches."""
    if t.dtype not in NUMPY_DTYPES:
        raise ValueError(f"checkpoint leaf {name!r} is {t.dtype}, which numpy cannot hold")
    if isinstance(t, DTensor):
        t = t.full_tensor()  # a collective: every rank of the mesh gathers
    return t.detach().to("cpu", copy=True).numpy()


class CheckpointManager:
    """Saves and restores trees under ``cfg.directory``.  ``group`` is the
    process group of a mesh of several ranks, every one of which calls each
    method in the same order; rank 0 of it writes."""

    def __init__(self, cfg: CheckpointConfig, group: Optional[dist.ProcessGroup] = None):
        self.cfg = cfg
        self.group = group
        self.writes = group is None or dist.get_rank(group) == 0
        self.dir = pathlib.Path(cfg.directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        self.wait()
        named = flatten(tree)
        names = [n for n, _ in named]
        host_leaves = [_host_copy(n, t) for n, t in named]  # device→host before async
        if not self.writes:
            return
        if self.cfg.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_leaves, names, extra), daemon=True,
            )
            self._thread.start()
        else:
            self._write(step, host_leaves, names, extra)

    def _write(self, step: int, leaves: List[np.ndarray], names: List[str],
               extra: Optional[Dict]) -> None:
        try:
            d = self.dir / f"step_{step:09d}"
            tmp = self.dir / f".tmp_step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            shards: List[List[int]] = [[]]
            size = 0
            for i, leaf in enumerate(leaves):
                if size > self.cfg.shard_bytes and shards[-1]:
                    shards.append([])
                    size = 0
                shards[-1].append(i)
                size += leaf.nbytes
            for si, idxs in enumerate(shards):
                np.savez(tmp / f"shard_{si:05d}.npz", **{str(i): leaves[i] for i in idxs})
            manifest = {
                "step": step,
                "n_leaves": len(leaves),
                "n_shards": len(shards),
                "names": names,
                "shapes": [list(l.shape) for l in leaves],
                "dtypes": [str(l.dtype) for l in leaves],
                "extra": extra or {},
                "time": time.time(),
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            (tmp / "COMMIT").write_text("ok")
            if d.exists():
                shutil.rmtree(d)
            tmp.rename(d)  # atomic publish
            self._gc()
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.group is not None:
            dist.barrier(group=self.group)  # the writer's step is committed for all
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # -------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMIT").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Any, step: Optional[int] = None) -> Tuple[Any, int, Dict]:
        """Restore into ``template``: its leaves' names and shapes are checked
        against the checkpoint's, and the stored values are copied into its
        tensors (cast to each one's dtype, on its device).  Returns
        ``(template, step, extra)``."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        named = flatten(template)
        if len(named) != manifest["n_leaves"]:
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, template {len(named)}"
            )
        names = [n for n, _ in named]
        if names != manifest["names"]:
            diff = sorted(set(names) ^ set(manifest["names"])) or "the same names in another order"
            raise ValueError(f"checkpoint leaf names differ from the template's: {diff}")
        loaded: Dict[int, np.ndarray] = {}
        for si in range(manifest["n_shards"]):
            with np.load(d / f"shard_{si:05d}.npz") as z:
                for k in z.files:
                    loaded[int(k)] = z[k]
        for i, (name, tmpl) in enumerate(named):
            arr = loaded[i]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"leaf {i} ({name}): ckpt shape {arr.shape} != {tuple(tmpl.shape)}")
        with torch.no_grad():
            for i, (_, tmpl) in enumerate(named):
                whole = torch.from_numpy(loaded.pop(i))
                if isinstance(tmpl, DTensor):
                    whole = whole.to(tmpl.device)
                    mine = distribute_tensor(whole, tmpl.device_mesh, tmpl.placements,
                                             src_data_rank=None)
                    tmpl.to_local().copy_(mine.to_local())
                else:
                    tmpl.copy_(whole)
        return template, step, manifest.get("extra", {})

    # ------------------------------------------------------------------- gc
    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.cfg.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)
