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
cache's length (the reference writes through a one-hot ``where``, which on
one device only costs a copy of the cache per step) and returns the same
cache with its length advanced.  Cross-attention (Whisper's decoder) is
plain ``_attend`` over the encoder's keys and values, with no rope and no
mask, as in the reference; serving computes those keys and values once, at
prefill (``apply_cross_attn_cached``).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.sharding import shard
from repro_torch.sharding.partition import local_part

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


def _on_shards(attend, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **kw) -> torch.Tensor:
    """``attend(q, k, v, **kw)``, on each rank's shards when ``q`` is a DTensor.

    Attention is independent per batch row and per KV-head group, so with
    ``q``, ``k`` and ``v`` split alike along the batch (dim 0) and, where
    the KV heads divide, the heads (dim 2), and whole along the sequences,
    each rank attends its own shards and the result is placed as ``q``.
    DTensor's own propagation through the einsums flattens sharded
    dimensions, which some torch releases refuse, and K3 launches only on
    a rank's local tensors.  ``q_positions`` is cut to the rank's rows."""
    if not isinstance(q, DTensor):
        return attend(q, k, v, **kw)
    mesh = q.device_mesh
    heads = math.prod(mesh.size(i) for i, p in enumerate(q.placements)
                      if isinstance(p, Shard) and p.dim == 2)
    place = [p if isinstance(p, Shard) and (p.dim == 0 or (p.dim == 2 and k.shape[2] % heads == 0))
             else Replicate() for p in q.placements]

    def local(t, pl):
        if isinstance(t, DTensor):
            return local_part(t, pl)
        return distribute_tensor(t, mesh, pl, src_data_rank=None).to_local()

    q_l, k_l, v_l = (local(t, place) for t in (q, k, v))
    if kw.get("q_positions") is not None:
        rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in place]
        kw["q_positions"] = local(kw["q_positions"], rows)
    if isinstance(kw.get("kv_valid_len"), DTensor):
        kw["kv_valid_len"] = kw["kv_valid_len"].full_tensor()
    out = attend(q_l, k_l, v_l, **kw).contiguous()  # the strides given below
    B, S, H = q.shape[:3]
    shape = (B, S, H, v.shape[3])
    return DTensor.from_local(out, mesh, place, run_check=False, shape=torch.Size(shape),
                              stride=(S * H * shape[3], H * shape[3], shape[3], 1))


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one contiguous matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


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
            cache.k[:, :S] = k
            cache.v[:, :S] = v
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
        idx = cache.length.long().reshape(1)
        cache.k.index_copy_(1, idx, k.to(cache.k.dtype))
        cache.v.index_copy_(1, idx, v.to(cache.v.dtype))
        cache.length.add_(1)
        ck = shard(cache.k, ("batch", "kv_seq", "kv_heads", None))
        cv = shard(cache.v, ("batch", "kv_seq", "kv_heads", None))
        new_cache = _resharded(cache, ck, cv)
        ctx = _on_shards(_attend, q, ck, cv, causal=False, q_positions=positions,
                         kv_valid_len=cache.length)
    else:
        raise ValueError(mode)
    H, Dh = ctx.shape[2], ctx.shape[3]
    out = ctx.reshape(B, S, H * Dh) @ p["wo"].to(dt).reshape(H * Dh, -1)
    return shard(out, ("batch", "seq", "act_embed")), new_cache


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
            cache.k[:, :S] = c_kv
            cache.v[:, :S] = k_rope
            cache.length.fill_(S)
            new_cache = cache
        # expanded attention: per-head keys and values from the latent
        k_nope = _project(c_kv, p["w_uk"].to(dt))              # (B,T,H,dn)
        v = _project(c_kv, p["w_uv"].to(dt))                   # (B,T,H,dv)
        s_nope = torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
        # the rope part is per-head in q; the one shared k_rope broadcasts
        s_rope = torch.einsum("bshk,btk->bhst", q_rope, k_rope)
        kv_pos = torch.arange(S, device=x.device)[None, None, None, :]
        mask = kv_pos <= positions[:, None, :, None]
        probs = _mla_softmax(s_nope, s_rope, scale, mask, dt)
        ctx = torch.einsum("bhst,bthk->bshk", probs, v)
    elif mode == "decode":
        assert cache is not None and S == 1
        idx = cache.length.long().reshape(1)
        cache.k.index_copy_(1, idx, c_kv.to(cache.k.dtype))
        cache.v.index_copy_(1, idx, k_rope.to(cache.v.dtype))
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
    H, Dv = ctx.shape[2], ctx.shape[3]
    out = ctx.reshape(B, S, H * Dv) @ p["wo"].to(dt).reshape(H * Dv, -1)
    return shard(out, ("batch", "seq", "act_embed")), new_cache


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
    B, S, H, Dh = q.shape
    pos = torch.arange(S, device=x.device)[None].expand(B, S)
    ctx = _on_shards(_attend, q, kv["k"], kv["v"], causal=False, q_positions=pos,
                     kv_valid_len=None)
    out = ctx.reshape(B, S, H * Dh) @ p["wo"].to(dt).reshape(H * Dh, -1)
    return shard(out, ("batch", "seq", "act_embed"))
