"""Mixture-of-Experts layer: token-choice top-k with capacity (``repro.models.moe``).

Dispatch is scatter/gather based (no (T, E, C) one-hot blow-up): each of
a token's K copies gets the slot ``expert·C + position_in_expert`` of an
``(E·C + 1, D)`` buffer; copies past an expert's capacity C go to the
extra trash row ``E·C``, which several copies write in any order and
which is discarded.  On a sharded mesh the buffer's expert axis is where
expert parallelism reshards (the EP all-to-all the paper studies); on one
device there is nothing to reshard.

Shared experts (DeepSeek) are plain always-on MLPs added to the routed
output, in order.  The load-balancing auxiliary loss follows
Switch/OLMoE: ``E · Σ_e f_e · p_e`` (fraction routed × mean router prob).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import shard

from .layers import apply_mlp, init_mlp
from .module import normal_init


def init_moe(cfg: ModelConfig) -> Dict:
    moe = cfg.moe
    assert moe is not None
    d, E, Fe = cfg.d_model, moe.n_experts, moe.d_expert
    p: Dict = {
        "router": normal_init((d, E), ("embed", "experts"), scale=0.02),
        "wi_gate": normal_init((E, d, Fe), ("experts", "embed", "expert_mlp"), fan_in=d),
        "wi_up": normal_init((E, d, Fe), ("experts", "embed", "expert_mlp"), fan_in=d),
        "wo": normal_init((E, Fe, d), ("experts", "expert_mlp", "embed"), fan_in=Fe),
    }
    if moe.n_shared:
        p["shared"] = [init_mlp(d, moe.d_expert, cfg.mlp_type) for _ in range(moe.n_shared)]
    return p


class Routing(NamedTuple):
    gates: torch.Tensor       # (G, N, K) fp32, renormalized top-k probabilities
    experts: torch.Tensor     # (G, N, K) int64, descending by probability
    keep: torch.Tensor        # (G, N·K) bool: the copy got a slot within capacity
    slot: torch.Tensor        # (G, N·K) int64: expert·C + position, or E·C (trash)
    capacity: int             # C
    aux: torch.Tensor         # () fp32 load-balance loss


def route(p, cfg: ModelConfig, x: torch.Tensor) -> Routing:
    """Top-k routing and slot assignment for ``x`` (G, N, D): each of the G
    groups has its own capacity ``C = max(1, ceil(N·K/E·capacity_factor))``.
    Slots are handed out in the flat (N·K) order, a token's K picks from
    the most to the least probable, so an overflowing expert drops its
    latest copies."""
    moe = cfg.moe
    G, N, _ = x.shape
    E, K = moe.n_experts, moe.top_k

    # fp32 for a stable softmax; topk sorts descending, as jax.lax.top_k
    logits = x.float() @ p["router"].float()                            # (G,N,E)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, K, dim=-1)                        # (G,N,K)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)

    # the one-hot, expert-major (G, E, N·K) so the running count below scans
    # its innermost axis (a scan over an outer axis of the reference's
    # (G, N·K, E) layout took 12.7 ms a layer on an H100 at OLMoE's serving
    # prefill); by comparison, as F.one_hot checks its range on the host
    flat = experts.reshape(G, N * K)
    onehot = flat[:, None, :] == torch.arange(E, device=x.device)[:, None]

    # aux loss: fraction of tokens per expert × mean router prob per expert
    frac = onehot.sum((0, 2)).float() / (G * N) / K
    aux = E * (frac * probs.mean((0, 1))).sum()

    C = max(1, int(math.ceil(N * K / E * moe.capacity_factor)))
    pos = onehot.cumsum(-1, dtype=torch.int32) - 1
    pos = pos.gather(1, flat[:, None, :])[:, 0].long()
    keep = pos < C
    slot = torch.where(keep, flat * C + pos, E * C)
    return Routing(gates, experts, keep, slot, C, aux)


def apply_moe(p, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (output (B,S,D), aux load-balance loss ()).

    GROUPED dispatch: each batch row is a dispatch group with its own
    capacity.  ``cfg.moe.dispatch == "global"`` pools all B·S tokens
    under one capacity instead (:func:`_apply_moe_global`)."""
    if cfg.moe.dispatch == "global":
        return _apply_moe_global(p, cfg, x)
    return _dispatch(p, cfg, x, grouped=True)


def _dispatch(p, cfg: ModelConfig, x: torch.Tensor, *, grouped: bool):
    """Route, dispatch, the experts' FFN and combine over ``x`` (G, N, D),
    each of the G rows a dispatch group.  ``grouped`` places the reference's
    grouped-dispatch constraints (the buffers data-sharded, the expert axis
    model-sharded: the EP all-to-all); a global pool (G = 1) places only
    its two expert-axis constraints."""
    B, S, D = x.shape
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    dt = x.dtype
    r = route(p, cfg, x)
    C = r.capacity

    # dispatch: per-group scatter of every copy into (B, E·C + 1, D), along
    # the slot axis only (the reference's vmap'd scatter): a sharded batch
    # axis stays local
    tok_ids = torch.arange(S, device=x.device).repeat_interleave(K)     # (S·K,)
    slot = r.slot[..., None].expand(B, S * K, D)
    buf = x.new_zeros((B, E * C + 1, D))
    if grouped:
        buf = shard(buf, ("batch", None, "act_embed"))
    buf.scatter_(1, slot, x[:, tok_ids, :])
    if grouped:
        buf = shard(buf, ("batch", None, "act_embed"))
    group = "batch" if grouped else None
    expert_in = shard(buf[:, :E * C].reshape(B, E, C, D), (group, "experts", None, "act_embed"))

    # expert FFN (SwiGLU), every expert padded to its capacity
    g = torch.einsum("gecd,edf->gecf", expert_in, p["wi_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", expert_in, p["wi_up"].to(dt))
    h = F.silu(g) * u
    expert_out = torch.einsum("gecf,efd->gecd", h, p["wo"].to(dt))
    expert_out = shard(expert_out, (group, "experts", None, "act_embed"))

    # combine: gather each copy's output (trash → zeros), weight by its gate
    out_flat = torch.cat([expert_out.reshape(B, E * C, D), x.new_zeros((B, 1, D))], dim=1)
    if grouped:
        out_flat = shard(out_flat, ("batch", None, "act_embed"))
    per_copy = out_flat.gather(1, slot)                                  # (B,S·K,D)
    w = (r.gates.reshape(B, S * K) * r.keep).to(dt)[..., None]
    y = (per_copy * w).reshape(B, S, K, D).sum(dim=2)

    if cfg.moe.n_shared:
        for sp in p["shared"]:
            y = y + apply_mlp(sp, x, mlp_type=cfg.mlp_type)
    return y, r.aux


def _apply_moe_global(p, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global dispatch: one capacity pool over all B·S tokens.  That is the
    grouped dispatch of the tokens as one group, ``(1, B·S, D)``: the
    routing, capacity, slot order and aux loss are the reference's
    ``_apply_moe_global`` term for term."""
    B, S, D = x.shape
    y, aux = _dispatch(p, cfg, x.reshape(1, B * S, D), grouped=False)
    return y.reshape(B, S, D), aux
