"""Common layers: norms, embeddings, RoPE variants, MLPs.

A port of ``repro.models.layers``.  Matmuls run in the activation dtype
(bf16 by default) with fp32 parameters cast at use; norms accumulate in
fp32.  Two numeric traps of the reference are kept on purpose:
``jax.nn.gelu`` defaults to the tanh approximation, and ``jnp.take``
clamps out-of-range ids (token ids on the serving path are in range, so a
plain index is the same).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding import shard
from repro_torch.sharding.partition import local_part

from .module import ParamSpec, normal_init, ones_init, zeros_init

# ------------------------------------------------------------------- norms


def init_norm(d: int, norm_type: str) -> Dict[str, ParamSpec]:
    p = {"scale": ones_init((d,), ("embed",))}
    if norm_type == "layernorm":
        p["bias"] = zeros_init((d,), ("embed",))
    return p


def apply_norm(p, x: torch.Tensor, *, eps: float, norm_type: str) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    if norm_type == "rmsnorm":
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps) * p["scale"]
    elif norm_type == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        y = (x32 - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        raise ValueError(norm_type)
    return y.to(dt)


# -------------------------------------------------------------- embeddings


def init_embedding(vocab: int, d: int) -> ParamSpec:
    return normal_init((vocab, d), ("vocab", "embed"), scale=0.02)


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``, on DTensors by each rank from its own shards.

    DTensor's rule for the backward's indexed add fails in some torch
    releases (on a replicated table and on a vocabulary-sharded one), so
    on a mesh every rank gathers its ids' rows from its part of the table:
    the whole table (other splits made whole first), or, where one mesh
    dimension splits the vocabulary, its slice of rows, with zeros for
    ids outside it, the result then a partial sum over that dimension (the
    masked gather DTensor does itself).  The table's gradient is a
    partial sum over the mesh dimensions that split ``ids``."""
    if not isinstance(table, DTensor) or not isinstance(ids, DTensor):
        return table[ids]
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements)
             if isinstance(p, Shard) and p.dim == 0 and mesh.size(i) > 1]
    split_ids = [i for i, p in enumerate(ids.placements) if isinstance(p, Shard)]
    if len(vocab) > 1 or set(vocab) & set(split_ids):
        return table[ids]
    keep = [Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim)]
    grad = [Partial() if i in split_ids else keep[i] for i in range(mesh.ndim)]
    local_table = table.redistribute(mesh, keep).to_local(grad_placements=grad)
    local_ids = ids.to_local()
    out_place = list(ids.placements)
    if vocab:
        (v,) = vocab
        rows = -(-table.shape[0] // mesh.size(v))  # torch.chunk's split
        lo = mesh.get_local_rank(v) * rows
        mine = (local_ids >= lo) & (local_ids < lo + local_table.shape[0])
        got = local_table[(local_ids - lo).clamp(0, max(local_table.shape[0] - 1, 0))]
        local = torch.where(mine[..., None], got, torch.zeros((), dtype=got.dtype,
                                                              device=got.device))
        out_place[v] = Partial()
    else:
        local = local_table[local_ids]
    shape = tuple(ids.shape) + (table.shape[1],)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, out_place, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def pick_targets(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``logits.gather(-1, targets[..., None])[..., 0]``: each position's
    logit of its target, on DTensors by each rank from its own shards.

    DTensor's gather backward makes a zero gradient of the logits' global
    shape, replicated, on every rank (``new_zeros`` keeps the global size)
    before it scatters into it.  Here each rank gathers from its local
    logits (partial sums reduced first): where one mesh dimension splits
    the vocabulary, the targets in its slice, with zeros for the others,
    the result summed over that dimension (the masked gather DTensor does
    itself); the backward scatters into a local zero."""
    ids = targets.long().unsqueeze(-1)
    if not isinstance(logits, DTensor) or not isinstance(targets, DTensor):
        return logits.gather(-1, ids).squeeze(-1)
    mesh, last = logits.device_mesh, logits.ndim - 1
    vocab = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == last and mesh.size(i) > 1]
    if len(vocab) > 1:
        return logits.gather(-1, ids).squeeze(-1)
    keep = [Replicate() if p.is_partial() else p for p in logits.placements]
    rows = [Replicate() if i in vocab else p for i, p in enumerate(keep)]
    local_logits = local_part(logits, keep)
    local_ids = targets.redistribute(mesh, rows).to_local().long()
    out_place = list(rows)
    if vocab:
        (v,) = vocab
        width = -(-logits.shape[-1] // mesh.size(v))  # torch.chunk's split
        lo = mesh.get_local_rank(v) * width
        n = local_logits.shape[-1]
        mine = (local_ids >= lo) & (local_ids < lo + n)
        got = local_logits.gather(-1, (local_ids - lo).clamp(0, max(n - 1, 0)).unsqueeze(-1))
        local = torch.where(mine, got.squeeze(-1), torch.zeros((), dtype=got.dtype,
                                                                device=got.device))
        out_place[v] = Partial()
    else:
        local = local_logits.gather(-1, local_ids.unsqueeze(-1)).squeeze(-1)
    shape = tuple(targets.shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    gold = DTensor.from_local(local, mesh, out_place, run_check=False,
                              shape=torch.Size(shape), stride=stride)
    return gold.redistribute(mesh, rows)  # the partial sum reduced at once, as ``_settled``


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, dtype) -> torch.Tensor:
    # gather, then cast: the same values as casting the whole table first
    return shard(_rows(table, ids).to(dtype), ("batch", "seq", "act_embed"))


def logits_projection(table_or_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel logits in fp32, for a stable softmax-xent."""
    return shard(x.float() @ table_or_w.float().t(), ("batch", "seq", "vocab"))


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    inv = torch.exp(-math.log(10000.0) * 2 * dim / d)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)  # (n, d)


# -------------------------------------------------------------------- RoPE


def rope_tables(positions: torch.Tensor, dim: int, base: float = 10000.0):
    """cos/sin tables for the given positions. positions: (...,S)."""
    exps = torch.arange(0, dim, 2, device=positions.device).float() / dim
    inv = 1.0 / (base ** exps)
    ang = positions[..., None].float() * inv  # (...,S,dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, style: str = "full",
               base: float = 10000.0) -> torch.Tensor:
    """x: (B,S,H,D). ``full`` rotates all D dims (llama half-split pairing);
    ``chatglm_2d`` rotates only the first half of D with interleaved pairing."""
    if style == "none" or style == "sinusoidal":
        return x
    B, S, H, D = x.shape
    dt = x.dtype
    xf = x.float()
    if style == "full":
        cos, sin = rope_tables(positions, D, base)           # (B,S,D/2)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
        x1, x2 = xf.chunk(2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
        return out.to(dt)
    if style == "chatglm_2d":
        half = D // 2
        cos, sin = rope_tables(positions, half, base)        # (B,S,half/2)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
        rot, passth = xf[..., :half], xf[..., half:]
        x1 = rot[..., 0::2]
        x2 = rot[..., 1::2]
        r1 = x1 * cos - x2 * sin
        r2 = x2 * cos + x1 * sin
        rot_out = torch.stack([r1, r2], dim=-1).reshape(rot.shape)
        return torch.cat([rot_out, passth], dim=-1).to(dt)
    raise ValueError(f"unknown rope style {style}")


# --------------------------------------------------------------------- MLP


def init_mlp(d: int, f: int, mlp_type: str) -> Dict[str, ParamSpec]:
    if mlp_type == "swiglu":
        return {
            "wi_gate": normal_init((d, f), ("embed", "mlp")),
            "wi_up": normal_init((d, f), ("embed", "mlp")),
            "wo": normal_init((f, d), ("mlp", "embed")),
        }
    return {"wi": normal_init((d, f), ("embed", "mlp")), "wo": normal_init((f, d), ("mlp", "embed"))}


def apply_mlp(p, x: torch.Tensor, *, mlp_type: str) -> torch.Tensor:
    dt = x.dtype
    if mlp_type == "swiglu":
        g = x @ p["wi_gate"].to(dt)
        u = x @ p["wi_up"].to(dt)
        h = F.silu(g) * u
    elif mlp_type == "gelu":
        h = F.gelu(x @ p["wi"].to(dt), approximate="tanh")  # jax.nn.gelu's default
    elif mlp_type == "relu2":
        h = torch.relu(x @ p["wi"].to(dt)).square()
    else:
        raise ValueError(mlp_type)
    h = shard(h, ("batch", "seq", "mlp"))
    return h @ p["wo"].to(dt)
