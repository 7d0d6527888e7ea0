"""Attention: GQA/MQA with a KV cache, MLA (DeepSeek-V2) and cross-attention,
from ``repro.models.attention``.

Four execution modes per GQA layer:

* train   — full causal attention, no cache (K3 when ``cfg.use_pallas``);
* prefill — causal attention that also fills the KV cache (K3 likewise);
* decode  — one query token against a fixed-capacity cache;
* bidir   — non-causal self-attention (encoders).

MLA has train, prefill and decode.  Train and prefill expand the latent
``c_kv`` into per-head keys and values and attend with plain einsums
(never K3, as in the reference); decode uses the *absorbed* form: the
query is projected into the KV-LoRA space (``q_nope·w_uk``) and scored
against the cached ``c_kv`` directly, so the cache holds only
``(c_kv, k_rope)``: a :class:`KVCache` with ``k = c_kv (B, T, kv_lora)``
and ``v = k_rope (B, T, rope_dim)``.

Decode writes the new key and value into the cache **in place** at the
cache's length and returns the same cache with its length advanced.  A
plain cache takes them with ``index_copy_`` (the reference's one-hot
``where`` costs a pass over the cache per step); a DTensor cache split along
its length takes the one-hot ``where`` (:func:`_write_at`), which stays
local on every rank, and the step attends each rank's part of the cache
(:func:`_attend_split_kv`).  Cross-attention (Whisper's decoder) is
plain ``_attend`` over the encoder's keys and values, with no rope and no
mask, as in the reference; serving computes those keys and values once, at
prefill (``apply_cross_attn_cached``).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.sharding import shard
from repro_torch.sharding.partition import local_part, unflattenable
from repro_torch.sharding.rules import einsum as sharded_einsum

from .layers import apply_rope
from .module import ParamSpec, normal_init

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor        # (B, T, K, Dh)  [MLA: (B, T, kv_lora)]
    v: torch.Tensor        # (B, T, K, Dv)  [MLA: (B, T, rope_dim) = k_rope]
    length: torch.Tensor   # () int32 — valid prefix


def init_cache(batch: int, max_len: int, n_kv: int, dh: int, dv: int, dtype,
               device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, max_len, n_kv, dh), dtype=dtype, device=device),
        v=torch.zeros((batch, max_len, n_kv, dv), dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def init_mla_cache(batch: int, max_len: int, mla: MLAConfig, dtype, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, max_len, mla.kv_lora), dtype=dtype, device=device),
        v=torch.zeros((batch, max_len, mla.qk_rope_dim), dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def _resharded(cache: KVCache, k: torch.Tensor, v: torch.Tensor) -> KVCache:
    """The cache written in place, with ``k`` / ``v`` as :func:`shard`
    gave them back: the same cache unless they were redistributed."""
    return cache if (k is cache.k and v is cache.v) else KVCache(k, v, cache.length)


def _local_writable(buf: DTensor, new: torch.Tensor):
    """This rank's part of the cache ``buf``, where its length starts, and
    ``new`` placed as the cache but whole along the length, as local
    tensors: a write into the cache is then the rank's own."""
    place = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in buf.placements]
    new_l = new.to(buf.dtype).redistribute(buf.device_mesh, place).to_local()
    return buf.to_local(), _global_offset(buf, buf.placements, 1), new_l


def _write_prefix(buf: torch.Tensor, new: torch.Tensor) -> None:
    """A prefill's keys ``new`` (B, S, ...) into the cache ``buf`` (B, T,
    ...) at positions [0, S), in place; a DTensor cache split along its
    length takes on each rank the positions that rank holds."""
    S = new.shape[1]
    if not isinstance(buf, DTensor):
        buf[:, :S] = new
        return
    local, start, new_l = _local_writable(buf, new)
    n = max(0, min(S - start, local.shape[1]))
    local[:, :n] = new_l[:, start:start + n]


def _write_at(buf: torch.Tensor, new: torch.Tensor, at: torch.Tensor) -> None:
    """Write ``new`` (B, 1, ...) into the cache ``buf`` (B, T, ...) at
    position ``at``, in place.  A plain cache takes it with ``index_copy_``.
    A DTensor cache, split along its length over the mesh, takes it as the
    reference writes: a one-hot ``where`` over the whole length, which is
    elementwise and so runs on each rank's part with no collective (an
    indexed write into a split dimension is not local, and DTensor relabels
    the cache it returns)."""
    if not isinstance(buf, DTensor):
        buf.index_copy_(1, at.long().reshape(1), new.to(buf.dtype))
        return
    local, start, new_l = _local_writable(buf, new)
    at = at.to_local() if isinstance(at, DTensor) else at
    pos = start + torch.arange(local.shape[1], device=local.device)
    sel = (pos == at).reshape(1, -1, *(1,) * (local.ndim - 2))
    torch.where(sel, new_l, local, out=local)


# ------------------------------------------------------------------- GQA


def init_gqa(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "wq": normal_init((d, H, Dh), ("embed", "heads", None)),
        "wk": normal_init((d, K, Dh), ("embed", "kv_heads", None)),
        "wv": normal_init((d, K, Dh), ("embed", "kv_heads", None)),
        "wo": normal_init((H, Dh, d), ("heads", None, "embed"), fan_in=H * Dh),
    }


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
            q_positions: torch.Tensor, kv_valid_len: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (B,S,H,D); k/v: (B,T,K,D). Grouped (GQA) softmax attention, fp32
    softmax. q_positions: (B,S) absolute positions for causal masking.
    kv_valid_len limits attention to the cache's valid prefix."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores / math.sqrt(D)
    kv_pos = torch.arange(T, device=q.device)[None, None, None, None, :]
    mask = torch.ones((B, 1, 1, S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kv_pos <= q_positions[:, None, None, :, None])
    if kv_valid_len is not None:
        mask = mask & (kv_pos < kv_valid_len)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, D)


def _kept(place, shape, mesh, dims) -> list:
    """``place`` with a ``Shard`` kept only along ``dims`` and only where
    the tensor dimension splits evenly over the mesh dimensions that shard
    it (a batch of 1 over "data" is whole on every rank)."""
    ways = {}
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            ways[p.dim] = ways.get(p.dim, 1) * mesh.size(i)
    return [p if isinstance(p, Shard) and p.dim in dims and shape[p.dim] % ways[p.dim] == 0
            else Replicate() for p in place]


def _kv_heads_of(first: int, count: int, group: int):
    """The KV heads that query heads ``[first, first + count)`` read (query
    head h reads KV head h // group): a slice ``(lo, hi)`` where the local
    call is still grouped attention over it (the heads span whole groups or
    lie in one), else the KV head of each query head."""
    lo, hi = first // group, (first + count - 1) // group + 1
    if count % (hi - lo) == 0:
        g = count // (hi - lo)
        if all((first + j) // group - lo == j // g for j in range(count)):
            return lo, hi
    return [(first + j) // group for j in range(count)]


def _on_shards(attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **kw) -> torch.Tensor:
    """``attend(q, k, v, **kw)``, on each rank's shards when ``q`` is a DTensor.

    Attention is independent per batch row and per query head, so each rank
    attends its own rows and, where the query heads split evenly over the
    mesh dimensions that shard them, its own query heads, and the result is
    placed as ``q``.  Its keys and values are the KV heads those query
    heads read (:func:`_kv_heads_of`): the rank's chunk where the KV heads
    split alike, else a slice of them whole (their gradient then sums over
    the ranks that read them).  Keys and values split along
    their length (a decode step's cache) stay split where ``q`` is whole:
    each rank scores its part of the cache and the softmax is combined
    across ranks (:func:`_attend_split_kv`).  DTensor's own propagation
    through the einsums flattens sharded dimensions, which some torch
    releases refuse, and K3 launches only on a rank's local tensors.
    ``q_positions`` is cut to the rank's rows."""
    if not isinstance(q, DTensor):
        return attend(q, k, v, **kw)
    mesh = q.device_mesh
    B, S, H = q.shape[:3]
    K = k.shape[2]
    place = _kept(q.placements, q.shape, mesh, (0, 2))
    head_dims = [i for i, p in enumerate(place) if isinstance(p, Shard) and p.dim == 2]
    m = math.prod(mesh.size(i) for i in head_dims)
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in place]
    kv_place, heads = list(place), None
    if m > 1 and K % m:
        # the rank reads a slice of the KV heads, whole on the mesh
        kv_place = list(rows)
        heads = _kv_heads_of(_global_offset(q, place, 2), H // m, H // K)
    seq_dims = []
    if isinstance(k, DTensor) and attend is _attend:
        kv_split = _kept(k.placements, k.shape, mesh, (1,))
        seq_dims = [i for i, p in enumerate(kv_split)
                    if isinstance(p, Shard) and isinstance(place[i], Replicate)]
        for i in seq_dims:
            kv_place[i] = Shard(1)

    def local(t, pl, grad=None):
        if isinstance(t, DTensor):
            return local_part(t, pl, grad)
        return distribute_tensor(t, mesh, pl, src_data_rank=None).to_local()

    q_l = local(q, place)
    # where each rank reads part of the whole KV heads, their gradients are
    # summed over the ranks: the slices overlap or are each one rank's
    summed = [Partial() if i in head_dims else p for i, p in enumerate(kv_place)]
    k_l, v_l = (local(t, kv_place, summed if heads is not None else None) for t in (k, v))
    if isinstance(heads, tuple):
        k_l, v_l = k_l[:, :, heads[0]:heads[1]], v_l[:, :, heads[0]:heads[1]]
    elif heads is not None:
        idx = torch.tensor(heads, device=k_l.device)
        k_l, v_l = k_l.index_select(2, idx), v_l.index_select(2, idx)
    if kw.get("q_positions") is not None:
        kw["q_positions"] = local(kw["q_positions"], rows)
    if isinstance(kw.get("kv_valid_len"), DTensor):
        kw["kv_valid_len"] = kw["kv_valid_len"].full_tensor()
    if seq_dims:
        offset = _global_offset(k, kv_place, 1)
        out = _attend_split_kv(q_l, k_l, v_l, mesh, place, seq_dims, offset, B, **kw)
    else:
        out = attend(q_l, k_l, v_l, **kw)
    out = out.contiguous()  # the strides given below
    shape = (B, S, H, v.shape[3])
    return DTensor.from_local(out, mesh, place, run_check=False, shape=torch.Size(shape),
                              stride=(S * H * shape[3], H * shape[3], shape[3], 1))


def _global_offset(t: DTensor, place, dim: int) -> int:
    """Where this rank's part of ``t`` under ``place`` starts along ``dim``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return int(compute_local_shape_and_global_offset(t.shape, t.device_mesh, place)[1][dim])


def _attend_split_kv(q, k, v, mesh, place, seq_dims, offset: int, B: int, *, causal: bool,
                     q_positions: torch.Tensor, kv_valid_len: Optional[torch.Tensor]):
    """:func:`_attend` of a rank's queries against its part of the keys and
    values, which start at ``offset`` of a cache split along its length over
    the mesh dimensions ``seq_dims``: each rank scores its part, and the
    softmax's maximum, its sum and the weighted values are combined over
    those dimensions (a max and two sums of per-query values, the
    flash-decoding split): the rank's share of the work, as the reference's
    partitioner splits the contractions over the sharded cache."""
    Bl, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(Bl, S, K, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(D)
    kv_pos = offset + torch.arange(T, device=q.device)[None, None, None, None, :]
    mask = torch.ones((Bl, 1, 1, S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kv_pos <= q_positions[:, None, None, :, None])
    if kv_valid_len is not None:
        mask = mask & (kv_pos < kv_valid_len)
    scores = torch.where(mask, scores, NEG_INF)
    top = _combined(scores.amax(dim=-1, keepdim=True), "max", mesh, place, seq_dims, B)
    probs = torch.exp(scores - top)
    total = _combined(probs.sum(dim=-1, keepdim=True), "sum", mesh, place, seq_dims, B)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(q.dtype), v).float()
    out = _combined(out, "sum", mesh, place, seq_dims, B)
    out = out / total.permute(0, 3, 1, 2, 4)
    return out.to(q.dtype).reshape(Bl, S, H, D)


def _combined(t: torch.Tensor, op: str, mesh, place, seq_dims, B: int) -> torch.Tensor:
    """``t``, a rank's ``op`` ("max" or "sum") over its part of the cache,
    reduced over the mesh dimensions ``seq_dims``: the whole ``op``."""
    rows = [Partial(op) if i in seq_dims
            else (Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate())
            for i, p in enumerate(place)]
    shape = (B, *t.shape[1:])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    whole = [Replicate() if i in seq_dims else p for i, p in enumerate(rows)]
    return DTensor.from_local(t.contiguous(), mesh, rows, run_check=False,
                              shape=torch.Size(shape), stride=stride
                              ).redistribute(mesh, whole).to_local()


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one contiguous matmul (gathered along the
    heads × width where DTensor splits it in a way no placement of the
    heads describes, :func:`~repro_torch.sharding.partition.unflattenable`)."""
    d, h, k = w.shape
    w2 = w.reshape(d, h * k)
    if isinstance(w2, DTensor) and isinstance(x, DTensor):
        # a weight whole along its heads (too few for "model") has its
        # columns split where both operands are whole, as DTensor may split
        # them at no cost: the same product on every mesh and release
        w2 = w2.redistribute(w2.device_mesh, [
            Shard(1) if isinstance(px, Replicate) and isinstance(pw, Replicate)
            and not any(isinstance(p, Shard) and p.dim == 1 for p in w.placements) else pw
            for px, pw in zip(x.placements, w2.placements)])
    return unflattenable(x @ w2, h).reshape(*x.shape[:-1], h, k)


def _out_project(ctx: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"): the heads' outputs through ``wo``.  A
    DTensor ``wo`` whole along its heads (too few to split over "model":
    12 over 16 ranks) takes each rank's rows of the outputs whole
    (:func:`_rows_matmul`): DTensor would split the product's gradient
    along the flattened heads × width, which no placement of the heads
    describes."""
    H, Dv = ctx.shape[2], ctx.shape[3]
    flat, w = ctx.reshape(*ctx.shape[:2], H * Dv), wo.reshape(H * Dv, -1)
    if isinstance(wo, DTensor) and isinstance(ctx, DTensor) and not any(
            isinstance(p, Shard) and p.dim == 0 for p in wo.placements):
        return _rows_matmul(flat, w)
    return flat @ w


def _rows_matmul(x: DTensor, w: DTensor) -> DTensor:
    """``x @ w`` on each rank's rows of ``x`` (split as ``x`` is along its
    leading dimensions, whole along the last) and the whole ``w``: the
    result is placed as those rows, and ``w``'s gradient sums over the
    ranks that split them."""
    mesh = x.device_mesh
    place = [p if isinstance(p, Shard) and p.dim < x.ndim - 1 else Replicate()
             for p in x.placements]
    x_l = local_part(x, place)
    w_l = local_part(w, [Replicate()] * mesh.ndim,
                     [Partial() if isinstance(p, Shard) else Replicate() for p in place])
    shape = (*x.shape[:-1], w.shape[-1])
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(x_l @ w_l, mesh, place, run_check=False, shape=torch.Size(shape),
                              stride=stride)


def apply_gqa(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache: Optional[KVCache] = None,
    mode: str = "train",            # train | prefill | decode | bidir
    rope_style: Optional[str] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    dt = x.dtype
    B, S, _ = x.shape
    style = rope_style if rope_style is not None else cfg.rope_style
    q = _project(x, p["wq"].to(dt))
    k = _project(x, p["wk"].to(dt))
    v = _project(x, p["wv"].to(dt))
    q = apply_rope(q, positions, style=style)
    k = apply_rope(k, positions, style=style)
    if mode == "decode":
        # decode queries replicate over the model axis: the KV cache is
        # seq-sharded, and a heads-sharded q would re-shard the whole cache
        q = shard(q, ("batch", None, None, None))
    else:
        q = shard(q, ("batch", "seq", "heads", None))
    k = shard(k, ("batch", "seq", "kv_heads", None))
    v = shard(v, ("batch", "seq", "kv_heads", None))

    new_cache = None
    if mode == "bidir":  # encoder self-attention
        ctx = _on_shards(_attend, q, k, v, causal=False, q_positions=positions, kv_valid_len=None)
    elif mode in ("train", "prefill"):
        if mode == "prefill":
            assert cache is not None
            _write_prefix(cache.k, k)
            _write_prefix(cache.v, v)
            cache.length.fill_(S)
            new_cache = cache
        if cfg.use_pallas:
            ctx = _on_shards(flash_ops.flash_attention, q, k, v, causal=True)
        elif cfg.attention_impl == "blocked":
            ctx = _on_shards(_attend_blocked, q, k, v, causal=True)
        else:
            ctx = _on_shards(_attend, q, k, v, causal=True, q_positions=positions,
                             kv_valid_len=None)
    elif mode == "decode":
        assert cache is not None and S == 1
        _write_at(cache.k, k, cache.length)
        _write_at(cache.v, v, cache.length)
        cache.length.add_(1)
        ck = shard(cache.k, ("batch", "kv_seq", "kv_heads", None))
        cv = shard(cache.v, ("batch", "kv_seq", "kv_heads", None))
        new_cache = _resharded(cache, ck, cv)
        ctx = _on_shards(_attend, q, ck, cv, causal=False, q_positions=positions,
                         kv_valid_len=cache.length)
    else:
        raise ValueError(mode)
    return shard(_out_project(ctx, p["wo"].to(dt)), ("batch", "seq", "act_embed")), new_cache


def _attend_blocked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    block_q: int = 1024, block_k: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over KV blocks (the flash decomposition in
    plain torch), skipping KV blocks strictly above the causal diagonal.
    Assumes aligned q/kv windows (q position i attends kv ≤ i)."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    bq, bk = min(block_q, S), min(block_k, T)
    assert S % bq == 0 and T % bk == 0, (S, T, bq, bk)
    scale = 1.0 / math.sqrt(D)

    outs = []
    for i in range(S // bq):
        qi = q[:, i * bq:(i + 1) * bq].reshape(B, bq, K, G, D).float() * scale
        m = torch.full((B, K, G, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, K, G, bq, 1), device=q.device)
        acc = torch.zeros((B, K, G, bq, D), device=q.device)
        q_hi = (i + 1) * bq - 1
        for j in range(T // bk):
            if causal and j * bk > q_hi:
                break  # fully masked block: skipped
            kj = k[:, j * bk:(j + 1) * bk].float()
            vj = v[:, j * bk:(j + 1) * bk].float()
            s = torch.einsum("bqkgd,btkd->bkgqt", qi, kj)
            if causal and (j + 1) * bk - 1 > i * bq:  # diagonal block
                qpos = i * bq + torch.arange(bq, device=q.device)[:, None]
                kpos = j * bk + torch.arange(bk, device=q.device)[None, :]
                s = torch.where(kpos <= qpos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            pbl = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + pbl.sum(dim=-1, keepdim=True)
            acc = alpha * acc + torch.einsum("bkgqt,btkd->bkgqd", pbl, vj)
            m = m_new
        o = (acc / torch.clamp(l, min=1e-30)).permute(0, 3, 1, 2, 4)  # (B,bq,K,G,D)
        outs.append(o.reshape(B, bq, H, D))
    return torch.cat(outs, dim=1).to(q.dtype)


# ------------------------------------------------------------------- MLA


def init_mla(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m = cfg.mla
    assert m is not None
    d, H = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq": normal_init((d, H, qd), ("embed", "heads", None)),
        "w_dkv": normal_init((d, m.kv_lora), ("embed", "kv_lora")),
        "w_kr": normal_init((d, m.qk_rope_dim), ("embed", None)),
        "w_uk": normal_init((m.kv_lora, H, m.qk_nope_dim), ("kv_lora", "heads", None)),
        "w_uv": normal_init((m.kv_lora, H, m.v_dim), ("kv_lora", "heads", None)),
        "wo": normal_init((H, m.v_dim, d), ("heads", None, "embed"), fan_in=H * m.v_dim),
    }


def _mla_softmax(s_nope: torch.Tensor, s_rope: torch.Tensor, scale: float,
                 mask: torch.Tensor, dt) -> torch.Tensor:
    """softmax(((s_nope + s_rope)·scale) in fp32, masked), cast to ``dt``.
    The sum and scale round in the activation dtype, as the reference's;
    they run in place on ``s_nope``: the (B, H, S, T) scores are the
    largest tensors of an MLA prefill."""
    scores = s_nope.add_(s_rope).mul_(scale).float()
    return torch.softmax(scores.masked_fill_(~mask, NEG_INF), dim=-1).to(dt)


def apply_mla(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache: Optional[KVCache] = None,
    mode: str = "train",            # train | prefill | decode
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    m = cfg.mla
    dt = x.dtype
    B, S, _ = x.shape
    dn = m.qk_nope_dim
    scale = 1.0 / math.sqrt(dn + m.qk_rope_dim)

    q = _project(x, p["wq"].to(dt))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, style="full")
    c_kv = x @ p["w_dkv"].to(dt)                                # (B,S,kv_lora)
    k_rope = (x @ p["w_kr"].to(dt))[:, :, None, :]              # (B,S,1,dr)
    k_rope = apply_rope(k_rope, positions, style="full")[:, :, 0, :]

    new_cache = None
    if mode in ("train", "prefill"):
        if mode == "prefill":
            assert cache is not None
            _write_prefix(cache.k, c_kv)
            _write_prefix(cache.v, k_rope)
            cache.length.fill_(S)
            new_cache = cache
        # expanded attention: per-head keys and values from the latent
        k_nope = _project(c_kv, p["w_uk"].to(dt))              # (B,T,H,dn)
        v = _project(c_kv, p["w_uv"].to(dt))                   # (B,T,H,dv)
        s_nope = sharded_einsum("bshk,bthk->bhst", q_nope, k_nope)
        # the rope part is per-head in q; the one shared k_rope broadcasts
        s_rope = torch.einsum("bshk,btk->bhst", q_rope, k_rope)
        kv_pos = torch.arange(S, device=x.device)[None, None, None, :]
        mask = kv_pos <= positions[:, None, :, None]
        probs = _mla_softmax(s_nope, s_rope, scale, mask, dt)
        ctx = sharded_einsum("bhst,bthk->bshk", probs, v)
    elif mode == "decode":
        assert cache is not None and S == 1
        _write_at(cache.k, c_kv, cache.length)
        _write_at(cache.v, k_rope, cache.length)
        cache.length.add_(1)
        ck = shard(cache.k, ("batch", "kv_seq", None))
        cr = shard(cache.v, ("batch", "kv_seq", None))
        new_cache = _resharded(cache, ck, cr)
        # absorbed decode: q_c = q_nope · w_uk, scored against c_kv directly;
        # decode queries replicate over the model axis (see apply_gqa)
        q_c = torch.einsum("bshk,lhk->bshl", q_nope, p["w_uk"].to(dt))
        q_c = shard(q_c, ("batch", None, None, None))
        q_rope = shard(q_rope, ("batch", None, None, None))
        s_nope = torch.einsum("bshl,btl->bhst", q_c, ck)
        s_rope = torch.einsum("bshk,btk->bhst", q_rope, cr)
        kv_pos = torch.arange(ck.shape[1], device=x.device)[None, None, None, :]
        probs = _mla_softmax(s_nope, s_rope, scale, kv_pos < cache.length, dt)
        ctx_c = torch.einsum("bhst,btl->bshl", probs, ck)      # (B,1,H,kv_lora)
        ctx = torch.einsum("bshl,lhk->bshk", ctx_c, p["w_uv"].to(dt))
    else:
        raise ValueError(mode)
    return shard(_out_project(ctx, p["wo"].to(dt)), ("batch", "seq", "act_embed")), new_cache


# --------------------------------------------------------- cross-attention


def init_cross_attn(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return init_gqa(cfg)


def apply_cross_attn(p, cfg: ModelConfig, x: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
    """Decoder query over encoder memory (Whisper). No causal mask, no rope."""
    dt = x.dtype
    kv = {"k": _project(enc, p["wk"].to(dt)), "v": _project(enc, p["wv"].to(dt))}
    return apply_cross_attn_cached(p, cfg, x, kv)


def apply_cross_attn_cached(p, cfg: ModelConfig, x: torch.Tensor, kv) -> torch.Tensor:
    """Cross-attention against precomputed encoder K/V (the serving path)."""
    dt = x.dtype
    q = _project(x, p["wq"].to(dt))
    B, S = q.shape[:2]
    pos = torch.arange(S, device=x.device)[None].expand(B, S)
    ctx = _on_shards(_attend, q, kv["k"], kv["v"], causal=False, q_positions=pos,
                     kv_valid_len=None)
    return shard(_out_project(ctx, p["wo"].to(dt)), ("batch", "seq", "act_embed"))
