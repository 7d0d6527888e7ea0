"""Model builders: the ``Model`` interface, ``DecoderLM``, Zamba2's ``HybridLM``,
``XLSTMLM`` and Whisper's ``EncDecLM``.

A port of ``repro.models.lm`` for every family it defines: dense, MoE, VLM,
hybrid, ssm (xLSTM) and audio (encoder–decoder).  ``build_model(cfg)``
returns a :class:`Model` exposing:

* ``init(generator, device=None)``          → :class:`ParamTree` (an ``nn.Module``)
* ``loss(params, batch)``                   → (scalar loss, metrics)
* ``prefill(params, batch, max_len=None)``  → (last-position logits, decode state)
* ``decode_step(params, state, tokens)``    → (logits, new state)
* ``init_decode_state(batch, max_len, device)`` → zeroed cache/state tree

Parameters are fp32 (``param_dtype``) and cast to the activation dtype at
use.  The layer stack is a Python loop over the stacked ``(L, …)``
parameters (the reference's ``lax.scan``), taken apart by
:func:`~repro_torch.models.module.unstack`.  Entry points run on CUDA unless
the caller asks for the CPU, and raise without CUDA.  ``loss`` runs the
train mode of every layer (zero recurrent states, no cache) and wraps the
bodies the reference wraps in ``jax.checkpoint`` in :func:`_remat`.  The
modality frontends are stubs, as in the reference: batches carry
precomputed ``img_embeds`` (VLM) or ``enc_frames`` (audio) at ``d_model``
width.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.sharding import active_mesh, active_rules, placed, shard, use_partitioning

from . import attention as A
from . import moe as M
from . import ssm as SSM
from .layers import (
    apply_mlp,
    apply_norm,
    embed_lookup,
    init_embedding,
    init_mlp,
    init_norm,
    logits_projection,
    pick_targets,
    sinusoidal_positions,
)
from .module import ParamTree, init_tree, normal_init, shapes_of, stack_init, unstack

Batch = Dict[str, torch.Tensor]


def _positions(B: int, S: int, device=None) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of fp32 ``logits`` against token ids."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = pick_targets(logits, targets)
    return (lse - gold).mean()


# the products JAX's ``dots_with_no_batch_dims_saveable`` keeps: the 2-D
# matmuls (a projection of (B, S, d) activations folds into one); batched
# products (the attention einsums) are recomputed, as everything else
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` recomputed in the backward pass, as the reference's ``_remat``:
    ``"full"`` saves only its inputs, ``"dots"`` also the outputs of its
    matmuls, ``"none"`` does not wrap.  Non-reentrant
    ``torch.utils.checkpoint``; without grad mode ``fn`` runs as it is.
    The loss and gradients are the same in every mode.  The recompute runs
    on the autograd engine's thread, which for CUDA tensors is not the
    caller's: DTensor's implicit replication and the active mesh and
    sharding rules (thread-local, set in a sharded step) are carried over
    to it, so that it places every tensor as the forward did."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        extra = {"context_fn": functools.partial(create_selective_checkpoint_contexts, _save_dots)}
    elif cfg.remat == "full":
        extra = {}
    else:
        raise ValueError(f"remat {cfg.remat!r}: need full, dots or none")

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        carried = DTensor._op_dispatcher._allow_implicit_replication
        mesh, rules = active_mesh(), active_rules()

        def body(*a, **k):
            with contextlib.ExitStack() as ctx:
                if carried and not DTensor._op_dispatcher._allow_implicit_replication:
                    ctx.enter_context(implicit_replication())
                if mesh is not None and active_mesh() is None:
                    ctx.enter_context(use_partitioning(mesh, rules))
                return fn(*a, **k)

        return checkpoint(body, *args, use_reentrant=False, **extra, **kwargs)

    return wrapped


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- to be provided by subclasses ------------------------------------
    def specs(self):  # pragma: no cover - interface
        """The parameter tree as :class:`~repro_torch.models.module.ParamSpec` s."""
        raise NotImplementedError

    def loss(self, params, batch: Batch):
        """(scalar fp32 loss, metrics ``{"xent", …}``) of next-token prediction."""
        raise NotImplementedError

    def prefill(self, params, batch: Batch, max_len: Optional[int] = None):
        raise NotImplementedError

    def decode_step(self, params, state, tokens: torch.Tensor):
        raise NotImplementedError

    def init_decode_state(self, batch: int, max_len: int, device=None):
        raise NotImplementedError

    def decode_state_axes(self):
        """Logical-axis tree matching init_decode_state's structure (used by
        the launcher to build decode-state shardings; fit-or-drop handles
        non-divisible dims like batch=1 or kv_heads < TP degree)."""
        raise NotImplementedError

    # -- conveniences ------------------------------------------------------
    def init(self, generator: torch.Generator, device=None) -> ParamTree:
        """Random parameters from ``generator`` (on ``device``; CUDA by default)."""
        return init_tree(self.specs(), generator, resolve_device(device))

    def param_shapes(self) -> Dict[str, tuple]:
        """``state_dict`` name → shape, without drawing any parameter."""
        return shapes_of(self.specs())

    def cache_dtype(self):
        return self.cfg.act_dtype()


_KV_AXES = A.KVCache(
    k=(None, "batch", "kv_seq", "kv_heads", None),
    v=(None, "batch", "kv_seq", "kv_heads", None),
    length=(None,),
)
_MLA_KV_AXES = A.KVCache(
    k=(None, "batch", "kv_seq", None),
    v=(None, "batch", "kv_seq", None),
    length=(None,),
)


def _with_norm(init_fn, cfg):
    return {"ln": init_norm(cfg.d_model, cfg.norm_type), "p": init_fn(cfg)}


# ===========================================================================
# Transformer decoder layer (dense / moe / vlm / audio decoder)
# ===========================================================================


def _init_decoder_layer(cfg: ModelConfig, *, kind: str, cross: bool = False):
    p = {"ln1": init_norm(cfg.d_model, cfg.norm_type),
         "attn": A.init_mla(cfg) if cfg.mla else A.init_gqa(cfg)}
    if cross:
        p["ln_x"] = init_norm(cfg.d_model, cfg.norm_type)
        p["xattn"] = A.init_cross_attn(cfg)
    p["ln2"] = init_norm(cfg.d_model, cfg.norm_type)
    if kind == "moe":
        p["ffn"] = M.init_moe(cfg)
    elif kind == "dense_wide":  # DeepSeek's first dense layers
        p["ffn"] = init_mlp(cfg.d_model, cfg.moe.d_first_dense_ff, cfg.mlp_type)
    else:
        p["ffn"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_type)
    return p


def _apply_decoder_layer(p, cfg: ModelConfig, x, *, positions, cache, mode, kind: str,
                         enc: Optional[torch.Tensor] = None, cross_kv=None):
    """One pre-norm block → (output, MoE aux loss or None); the cache views
    are written in place.  A layer with ``xattn`` attends to the encoder's
    output ``enc``, or to its precomputed keys and values ``cross_kv``."""
    h = apply_norm(p["ln1"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
    attn_fn = A.apply_mla if cfg.mla else A.apply_gqa
    a_out, _ = attn_fn(p["attn"], cfg, h, positions=positions, cache=cache, mode=mode)
    x = x + a_out
    if "xattn" in p:
        h = apply_norm(p["ln_x"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        if cross_kv is not None:
            xa = A.apply_cross_attn_cached(p["xattn"], cfg, h, cross_kv)
        else:
            xa = A.apply_cross_attn(p["xattn"], cfg, h, enc)
        x = x + xa
    h = apply_norm(p["ln2"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
    if kind == "moe":
        f_out, aux = M.apply_moe(p["ffn"], cfg, h)
    else:
        f_out, aux = apply_mlp(p["ffn"], h, mlp_type=cfg.mlp_type), None
    return x + f_out, aux


# ===========================================================================
# Decoder-only LM (dense / moe / vlm)
# ===========================================================================


class DecoderLM(Model):
    """``front_{i}`` dense-wide layers (DeepSeek: 1), then ``layers``: the
    stacked ``(L, …)`` dense or MoE layers.  The decode state is one
    :class:`~repro_torch.models.attention.KVCache` whose tensors (and
    ``length``) carry a leading ``(n_layers,)`` axis, front layers first."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        moe = cfg.moe
        self.n_front = moe.first_dense if moe else 0
        self.n_scan = cfg.n_layers - self.n_front
        self.kind = "moe" if moe else "dense"

    def specs(self):
        cfg = self.cfg
        p = {
            "embed": init_embedding(cfg.vocab, cfg.d_model),
            "ln_f": init_norm(cfg.d_model, cfg.norm_type),
            "lm_head": normal_init((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=0.02),
        }
        for i in range(self.n_front):
            p[f"front_{i}"] = _init_decoder_layer(cfg, kind="dense_wide")
        p["layers"] = stack_init(_init_decoder_layer(cfg, kind=self.kind), self.n_scan)
        if cfg.vlm:
            p["img_proj"] = normal_init((cfg.d_model, cfg.d_model), ("embed", "embed"))
        return p

    def _embed_inputs(self, params, batch: Batch) -> torch.Tensor:
        cfg = self.cfg
        dt = cfg.act_dtype()
        x = embed_lookup(params["embed"], batch["tokens"], dt)
        if cfg.vlm:
            img = batch["img_embeds"].to(dt) @ params["img_proj"].to(dt)
            x = torch.cat([img, x], dim=1)
        return shard(x, ("batch", "seq", "act_embed"))

    def _stack(self, params, x, positions, caches: Optional[A.KVCache], mode: str):
        """Every layer in order → (output, the layers' summed MoE aux loss,
        None when serving).  Serving: layer i reads and writes cache row i.
        Training (``caches`` None): each stacked layer under :func:`_remat`,
        the front layers not, as in the reference."""
        cfg = self.cfg
        front = [params[f"front_{i}"] for i in range(self.n_front)]
        train = mode == "train"
        body = _remat(_apply_decoder_layer, cfg) if train else _apply_decoder_layer
        aux = torch.zeros((), dtype=torch.float32, device=x.device) if train else None
        for i, lp in enumerate(front + unstack(params["layers"])):
            is_front = i < self.n_front
            cache = None if caches is None else A.KVCache(caches.k[i], caches.v[i], caches.length[i])
            x, a = (_apply_decoder_layer if is_front else body)(
                lp, cfg, x, positions=positions, cache=cache, mode=mode,
                kind="dense_wide" if is_front else self.kind)
            if train and a is not None:
                aux = aux + a
        return x, aux

    def loss(self, params, batch: Batch):
        """Next-token cross-entropy over the text positions (a VLM's image
        tokens are context only), plus ``0.01 · aux / n_scan`` for MoE, as
        the reference (whose ``xent`` metric is that sum too)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        B, S = x.shape[:2]
        x, aux = self._stack(params, x, _positions(B, S, device=x.device), None, "train")
        x = apply_norm(params["ln_f"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        n_img = cfg.vlm.n_img_tokens if cfg.vlm else 0
        logits = logits_projection(params["lm_head"], x[:, n_img:-1])
        loss = _xent(logits, batch["tokens"][:, 1:])
        if cfg.moe:
            loss = loss + 0.01 * aux / max(self.n_scan, 1)
        return loss, {"xent": loss, "aux": aux}

    def init_decode_state(self, batch: int, max_len: int, device=None) -> A.KVCache:
        cfg = self.cfg
        device = resolve_device(device)
        if cfg.mla:
            one = A.init_mla_cache(batch, max_len, cfg.mla, self.cache_dtype(), device)
        else:
            one = A.init_cache(batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim,
                               cfg.resolved_head_dim, self.cache_dtype(), device)
        return A.KVCache(*(a.new_zeros((cfg.n_layers, *a.shape)) for a in one))

    def decode_state_axes(self):
        return _MLA_KV_AXES if self.cfg.mla else _KV_AXES

    def prefill(self, params, batch: Batch, max_len: Optional[int] = None):
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        B, S = x.shape[:2]
        # cache headroom: decode appends after the prompt (and the image tokens)
        caches = placed(self.init_decode_state(B, max_len or S + 64, x.device),
                        self.decode_state_axes())
        x, _ = self._stack(params, x, _positions(B, S, device=x.device), caches, "prefill")
        x = apply_norm(params["ln_f"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        return logits_projection(params["lm_head"], x[:, -1:]), caches

    def decode_step(self, params, state: A.KVCache, tokens: torch.Tensor):
        """One token per row; the KV caches in ``state`` advance in place."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens, cfg.act_dtype())
        B = x.shape[0]
        # a copy: the caches' lengths advance in place during the step
        positions = state.length[0].clone().expand(B, 1)
        x, _ = self._stack(params, x, positions, state, "decode")
        x = apply_norm(params["ln_f"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        return logits_projection(params["lm_head"], x), state


# ===========================================================================
# Zamba2 hybrid: Mamba2 stack + one shared attention block with LoRA
# ===========================================================================


class HybridLM(Model):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        hc = cfg.hybrid
        assert cfg.n_layers % hc.shared_attn_every == 0
        self.n_groups = cfg.n_layers // hc.shared_attn_every
        self.per_group = hc.shared_attn_every

    def specs(self):
        cfg = self.cfg
        r = cfg.hybrid.lora_rank
        d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        lora = {
            name: {
                "a": normal_init((d, r), ("embed", None), scale=0.02),
                "b": normal_init((r, heads, Dh), (None, ax, None), scale=0.02),
            }
            for name, heads, ax in [("q", H, "heads"), ("k", K, "kv_heads"), ("v", K, "kv_heads")]
        }
        shared = {
            "ln1": init_norm(d, cfg.norm_type),
            "attn": A.init_gqa(cfg),
            "ln2": init_norm(d, cfg.norm_type),
            "ffn": init_mlp(d, cfg.d_ff, cfg.mlp_type),
        }
        return {
            "embed": init_embedding(cfg.vocab, d),
            "lm_head": normal_init((cfg.vocab, d), ("vocab", "embed"), scale=0.02),
            "ln_f": init_norm(d, cfg.norm_type),
            "shared": shared,
            "mamba": stack_init(_with_norm(SSM.init_mamba2, cfg), self.n_groups * self.per_group),
            "lora": stack_init(lora, self.n_groups),
        }

    def _shared_attn(self, params, lora, cfg, x, positions, cache, mode):
        """Shared transformer block with per-invocation LoRA on q/k/v."""
        sp = params["shared"]
        h = apply_norm(sp["ln1"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        p_attn = dict(sp["attn"])
        # effective weights: w + a @ b  (rank-r update per invocation)
        for name, wname in [("q", "wq"), ("k", "wk"), ("v", "wv")]:
            a, b = lora[name]["a"], lora[name]["b"]
            delta = (a @ b.reshape(b.shape[0], -1)).reshape(a.shape[0], *b.shape[1:])
            p_attn[wname] = sp["attn"][wname] + delta
        a_out, new_cache = A.apply_gqa(p_attn, cfg, h, positions=positions, cache=cache, mode=mode)
        x = x + a_out
        h = apply_norm(sp["ln2"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        return x + apply_mlp(sp["ffn"], h, mlp_type=cfg.mlp_type), new_cache

    def _mamba(self, lp, x, state, mode):
        """One pre-normed residual Mamba-2 layer → (output, its new state)."""
        cfg = self.cfg
        z = apply_norm(lp["ln"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        out, new_st = SSM.apply_mamba2(lp["p"], cfg, z, state=state, mode=mode)
        return x + out, new_st

    def _train_group(self, params, x, positions, mamba, lora):
        """One group in train mode: its Mamba-2 layers from zero states,
        then the shared attention with no cache."""
        for lp in mamba:
            x, _ = self._mamba(lp, x, None, "train")
        x, _ = self._shared_attn(params, lora, self.cfg, x, positions, None, "train")
        return x

    def _stack(self, params, x, positions, states, mode):
        """Every group in order: its Mamba-2 layers, then the shared
        attention with the group's LoRA.  Training (``states`` None) runs
        each group under :func:`_remat` and returns no state; serving
        threads the decode states through."""
        cfg = self.cfg
        G, Pg = self.n_groups, self.per_group
        mamba, loras = unstack(params["mamba"]), unstack(params["lora"])
        if mode == "train":
            group = _remat(self._train_group, cfg)
            for g in range(G):
                x = group(params, x, positions, mamba[g * Pg:(g + 1) * Pg], loras[g])
            return x, None
        ms, kv = states["mamba"], states["attn"]
        convs, ssms = [], []
        for g in range(G):
            for j in range(Pg):
                mst = SSM.Mamba2State(ms.conv[g, j], ms.ssm[g, j])
                x, new_st = self._mamba(mamba[g * Pg + j], x, mst, mode)
                if new_st is None:
                    new_st = mst
                convs.append(new_st.conv)
                ssms.append(new_st.ssm)
            cache = A.KVCache(kv.k[g], kv.v[g], kv.length[g])
            # the cache views are written in place, so ``kv`` holds the result
            x, _ = self._shared_attn(params, loras[g], cfg, x, positions, cache, mode)
        mamba = SSM.Mamba2State(
            conv=torch.stack(convs).reshape(G, Pg, *convs[0].shape),
            ssm=torch.stack(ssms).reshape(G, Pg, *ssms[0].shape),
        )
        return x, {"mamba": mamba, "attn": kv}

    def init_decode_state(self, batch: int, max_len: int, device=None):
        cfg = self.cfg
        G, Pg = self.n_groups, self.per_group
        device = resolve_device(device)
        m_one = SSM.init_mamba2_state(cfg, batch, torch.float32, device)
        kv_one = A.init_cache(batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim,
                              cfg.resolved_head_dim, self.cache_dtype(), device)
        return {
            "mamba": SSM.Mamba2State(*(a[None, None].repeat(G, Pg, *([1] * a.ndim)) for a in m_one)),
            "attn": A.KVCache(*(a[None].repeat(G, *([1] * a.ndim)) for a in kv_one)),
        }

    def decode_state_axes(self):
        return {
            "mamba": SSM.Mamba2State(
                conv=(None, None, "batch", None, "ssm_inner"),
                ssm=(None, None, "batch", "ssm_heads", None, None),
            ),
            "attn": _KV_AXES,
        }

    def loss(self, params, batch: Batch):
        """Next-token cross-entropy; zero Mamba-2 states and no attention
        cache (the reference's train mode ignores the caches it is handed)."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], batch["tokens"], cfg.act_dtype())
        B, S = x.shape[:2]
        x, _ = self._stack(params, x, _positions(B, S, device=x.device), None, "train")
        x = apply_norm(params["ln_f"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        loss = _xent(logits_projection(params["lm_head"], x[:, :-1]), batch["tokens"][:, 1:])
        return loss, {"xent": loss}

    def prefill(self, params, batch: Batch, max_len: Optional[int] = None):
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed_lookup(params["embed"], tokens, cfg.act_dtype())
        B, S = x.shape[:2]
        states = placed(self.init_decode_state(B, max_len or S + 64, x.device),
                        self.decode_state_axes())
        x, new_states = self._stack(params, x, _positions(B, S, device=x.device), states,
                                    "prefill")
        x = apply_norm(params["ln_f"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        return logits_projection(params["lm_head"], x[:, -1:]), new_states

    def decode_step(self, params, state, tokens: torch.Tensor):
        """One token per row; the KV caches in ``state`` advance in place."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens, cfg.act_dtype())
        B = x.shape[0]
        # a copy: the caches' lengths advance in place during the step
        positions = state["attn"].length[0].clone().expand(B, 1)
        x, new_states = self._stack(params, x, positions, state, "decode")
        x = apply_norm(params["ln_f"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        return logits_projection(params["lm_head"], x), new_states


# ===========================================================================
# xLSTM: groups of mLSTM blocks with an sLSTM every ``slstm_every``
# ===========================================================================


class XLSTMLM(Model):
    """``groups``: G groups of ``slstm_every - 1`` mLSTM blocks
    (``groups.mlstm``, stacked ``(G, Mg, …)``) and one sLSTM block
    (``groups.slstm``, ``(G, …)``), each pre-normed and residual.  The
    decode state holds the recurrent states stacked the same way, fp32 at
    the start of a prefill; it holds no KV length, since nothing in the
    model reads a position."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        xc = cfg.xlstm
        assert cfg.n_layers % xc.slstm_every == 0
        self.n_groups = cfg.n_layers // xc.slstm_every
        self.m_per_group = xc.slstm_every - 1

    def specs(self):
        cfg = self.cfg
        group = {
            "mlstm": stack_init(_with_norm(SSM.init_mlstm, cfg), self.m_per_group),
            "slstm": _with_norm(SSM.init_slstm, cfg),
        }
        return {
            "embed": init_embedding(cfg.vocab, cfg.d_model),
            "lm_head": normal_init((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=0.02),
            "ln_f": init_norm(cfg.d_model, cfg.norm_type),
            "groups": stack_init(group, self.n_groups),
        }

    def _apply_block(self, gp, x, states, mode: str):
        """One group: its mLSTM blocks in order, then its sLSTM block.
        ``states`` are the group's: ``mlstm`` stacked ``(Mg, …)``."""
        cfg = self.cfg
        ms = states["mlstm"]
        Cs, ns = [], []
        for j, lp in enumerate(unstack(gp["mlstm"])):
            st = SSM.MLSTMState(ms.C[j], ms.n[j])
            h = apply_norm(lp["ln"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
            out, new_st = SSM.apply_mlstm(lp["p"], cfg, h, state=st, mode=mode)
            if new_st is None:
                new_st = st
            x = x + out
            Cs.append(new_st.C)
            ns.append(new_st.n)
        sp = gp["slstm"]
        h = apply_norm(sp["ln"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        out, new_s = SSM.apply_slstm(sp["p"], cfg, h, state=states["slstm"], mode=mode)
        if new_s is None:
            new_s = states["slstm"]
        return x + out, {"mlstm": SSM.MLSTMState(torch.stack(Cs), torch.stack(ns)),
                         "slstm": new_s}

    def _train_group(self, gp, x):
        """One group in train mode: its mLSTM blocks, then its sLSTM block,
        each from zero states."""
        cfg = self.cfg
        for lp in unstack(gp["mlstm"]):
            h = apply_norm(lp["ln"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
            x = x + SSM.apply_mlstm(lp["p"], cfg, h, state=None, mode="train")[0]
        sp = gp["slstm"]
        h = apply_norm(sp["ln"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        return x + SSM.apply_slstm(sp["p"], cfg, h, state=None, mode="train")[0]

    def _stack(self, params, x, states, mode: str):
        """Every group in order; the new states are stacked as the old.
        Training (``states`` None) runs each group under :func:`_remat` and
        returns no state."""
        groups = unstack(params["groups"])
        if mode == "train":
            group = _remat(self._train_group, self.cfg)
            for gp in groups:
                x = group(gp, x)
            return x, None
        news = []
        for g, gp in enumerate(groups):
            st = {"mlstm": SSM.MLSTMState(*(a[g] for a in states["mlstm"])),
                  "slstm": SSM.SLSTMState(*(a[g] for a in states["slstm"]))}
            x, new_st = self._apply_block(gp, x, st, mode)
            news.append(new_st)
        return x, {
            "mlstm": SSM.MLSTMState(*(torch.stack(a) for a in zip(*(n["mlstm"] for n in news)))),
            "slstm": SSM.SLSTMState(*(torch.stack(a) for a in zip(*(n["slstm"] for n in news)))),
        }

    def init_decode_state(self, batch: int, max_len: int = 0, device=None):
        """fp32 recurrent states (``max_len`` is not read: no KV cache)."""
        cfg = self.cfg
        G, Mg = self.n_groups, self.m_per_group
        device = resolve_device(device)
        m_one = SSM.init_mlstm_state(cfg, batch, torch.float32, device)
        s_one = SSM.init_slstm_state(cfg, batch, torch.float32, device)
        return {
            "mlstm": SSM.MLSTMState(*(a[None, None].repeat(G, Mg, *([1] * a.ndim)) for a in m_one)),
            "slstm": SSM.SLSTMState(*(a[None].repeat(G, *([1] * a.ndim)) for a in s_one)),
        }

    def decode_state_axes(self):
        return {
            "mlstm": SSM.MLSTMState(
                C=(None, None, "batch", "ssm_heads", "ssm_inner", None),
                n=(None, None, "batch", "ssm_heads", None, None),
            ),
            "slstm": SSM.SLSTMState(
                h=(None, "batch", "ssm_heads", None),
                c=(None, "batch", "ssm_heads", None),
                n=(None, "batch", "ssm_heads", None),
                m=(None, "batch", "ssm_heads", None),
            ),
        }

    def loss(self, params, batch: Batch):
        """Next-token cross-entropy from zero recurrent states."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], batch["tokens"], cfg.act_dtype())
        x, _ = self._stack(params, x, None, "train")
        x = apply_norm(params["ln_f"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        loss = _xent(logits_projection(params["lm_head"], x[:, :-1]), batch["tokens"][:, 1:])
        return loss, {"xent": loss}

    def prefill(self, params, batch: Batch, max_len: Optional[int] = None):
        cfg = self.cfg
        x = embed_lookup(params["embed"], batch["tokens"], cfg.act_dtype())
        states = placed(self.init_decode_state(x.shape[0], 0, x.device), self.decode_state_axes())
        x, new_states = self._stack(params, x, states, "prefill")
        x = apply_norm(params["ln_f"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        return logits_projection(params["lm_head"], x[:, -1:]), new_states

    def decode_step(self, params, state, tokens: torch.Tensor):
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens, cfg.act_dtype())
        x, new_states = self._stack(params, x, state, "decode")
        x = apply_norm(params["ln_f"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        return logits_projection(params["lm_head"], x), new_states


# ===========================================================================
# Encoder–decoder (Whisper)
# ===========================================================================


def _init_encoder_layer(cfg: ModelConfig):
    return {"ln1": init_norm(cfg.d_model, cfg.norm_type),
            "attn": A.init_gqa(cfg),
            "ln2": init_norm(cfg.d_model, cfg.norm_type),
            "ffn": init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_type)}


def _apply_encoder_layer(p, cfg: ModelConfig, x):
    """Pre-norm bidirectional self-attention (plain ``_attend``, no rope),
    then the MLP."""
    h = apply_norm(p["ln1"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
    B, S = h.shape[:2]
    a, _ = A.apply_gqa(p["attn"], cfg, h, positions=_positions(B, S, device=h.device),
                       mode="bidir", rope_style="none")
    x = x + a
    h = apply_norm(p["ln2"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
    return x + apply_mlp(p["ffn"], h, mlp_type=cfg.mlp_type)


class EncDecLM(Model):
    """Whisper-style: stubbed mel-frame embeddings → encoder → decoder LM.

    ``enc_layers`` are stacked ``(n_enc_layers, …)``, ``dec_layers``
    ``(n_layers, …)`` with a cross-attention branch each (``ln_x``,
    ``xattn``).  The decode state is ``{"self": KVCache, "cross": {"k",
    "v"}}``: the decoder's self-attention caches with a leading
    ``(n_layers,)`` axis, and each layer's keys and values of the encoder's
    output, ``(n_layers, B, enc_seq, K, Dh)`` in the activation dtype,
    computed once at prefill and never written after."""

    def specs(self):
        cfg = self.cfg
        return {
            "embed": init_embedding(cfg.vocab, cfg.d_model),
            "lm_head": normal_init((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=0.02),
            "ln_f": init_norm(cfg.d_model, cfg.norm_type),
            "ln_enc": init_norm(cfg.d_model, cfg.norm_type),
            "enc_layers": stack_init(_init_encoder_layer(cfg), cfg.enc_dec.n_enc_layers),
            "dec_layers": stack_init(_init_decoder_layer(cfg, kind="dense", cross=True),
                                     cfg.n_layers),
        }

    def _encode(self, params, frames: torch.Tensor, mode: str = "prefill") -> torch.Tensor:
        """The encoder over ``frames``; in train mode each layer under
        :func:`_remat`."""
        cfg = self.cfg
        x = frames.to(cfg.act_dtype())
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
        x = shard(x, ("batch", "seq", "act_embed"))
        body = _remat(_apply_encoder_layer, cfg) if mode == "train" else _apply_encoder_layer
        for lp in unstack(params["enc_layers"]):
            x = body(lp, cfg, x)
        return apply_norm(params["ln_enc"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)

    def _decode_stack(self, params, x, positions, caches: A.KVCache, cross, mode: str):
        """Every decoder layer in order; layer i reads and writes self-cache
        row i and reads cross row i."""
        cfg = self.cfg
        for i, lp in enumerate(unstack(params["dec_layers"])):
            cache = A.KVCache(caches.k[i], caches.v[i], caches.length[i])
            x, _ = _apply_decoder_layer(lp, cfg, x, positions=positions, cache=cache, mode=mode,
                                        kind="dense",
                                        cross_kv={"k": cross["k"][i], "v": cross["v"][i]})
        return x

    def loss(self, params, batch: Batch):
        """Next-token cross-entropy of the decoder, which attends to the
        encoder's output of ``enc_frames``; every encoder and decoder layer
        under :func:`_remat`, as the reference."""
        cfg = self.cfg
        enc = self._encode(params, batch["enc_frames"], "train")
        x = embed_lookup(params["embed"], batch["tokens"], cfg.act_dtype())
        B, S = x.shape[:2]
        x = x + sinusoidal_positions(S, cfg.d_model, x.device).to(x.dtype)[None]
        body = _remat(_apply_decoder_layer, cfg)
        positions = _positions(B, S, device=x.device)
        for lp in unstack(params["dec_layers"]):
            x, _ = body(lp, cfg, x, positions=positions, cache=None, mode="train", kind="dense",
                        enc=enc)
        x = apply_norm(params["ln_f"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        loss = _xent(logits_projection(params["lm_head"], x[:, :-1]), batch["tokens"][:, 1:])
        return loss, {"xent": loss}

    def _cross_kv(self, params, enc: torch.Tensor):
        """Per-layer cross-attention K/V of the encoder's output, in its dtype."""
        xattn = params["dec_layers"]["xattn"]
        return {name: torch.stack([A._project(enc, w[i].to(enc.dtype))
                                   for i in range(self.cfg.n_layers)])
                for name, w in (("k", xattn["wk"]), ("v", xattn["wv"]))}

    def _self_cache(self, batch: int, max_len: int, device) -> A.KVCache:
        cfg = self.cfg
        one = A.init_cache(batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim,
                           cfg.resolved_head_dim, self.cache_dtype(), device)
        return A.KVCache(*(a.new_zeros((cfg.n_layers, *a.shape)) for a in one))

    def init_decode_state(self, batch: int, max_len: int, device=None):
        cfg = self.cfg
        device = resolve_device(device)
        shape = (cfg.n_layers, batch, cfg.enc_dec.enc_seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        cross = {name: torch.zeros(shape, dtype=self.cache_dtype(), device=device)
                 for name in ("k", "v")}
        return {"self": self._self_cache(batch, max_len, device), "cross": cross}

    def decode_state_axes(self):
        return {
            "self": _KV_AXES,
            "cross": {
                "k": (None, "batch", None, "kv_heads", None),
                "v": (None, "batch", None, "kv_heads", None),
            },
        }

    def prefill(self, params, batch: Batch, max_len: Optional[int] = None):
        cfg = self.cfg
        enc = self._encode(params, batch["enc_frames"])
        x = embed_lookup(params["embed"], batch["tokens"], cfg.act_dtype())
        B, S = x.shape[:2]
        T = max_len or S + 64
        x = x + sinusoidal_positions(T, cfg.d_model, x.device).to(x.dtype)[None, :S]
        caches = placed(self._self_cache(B, T, x.device), _KV_AXES)
        cross = self._cross_kv(params, enc)
        x = self._decode_stack(params, x, _positions(B, S, device=x.device), caches, cross,
                               "prefill")
        x = apply_norm(params["ln_f"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        return logits_projection(params["lm_head"], x[:, -1:]), {"self": caches, "cross": cross}

    def decode_step(self, params, state, tokens: torch.Tensor):
        """One token per row; the self caches in ``state`` advance in place,
        the cross keys and values are read as they are."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens, cfg.act_dtype())
        B = x.shape[0]
        caches = state["self"]
        # a copy: the caches' lengths advance in place during the step
        length = caches.length[0].clone()
        pos_tab = sinusoidal_positions(caches.k.shape[2], cfg.d_model, x.device)
        x = x + pos_tab.index_select(0, length.long().reshape(1)).to(x.dtype)[None]
        x = self._decode_stack(params, x, length.expand(B, 1), caches, state["cross"], "decode")
        x = apply_norm(params["ln_f"], x, eps=cfg.norm_eps, norm_type=cfg.norm_type)
        return logits_projection(params["lm_head"], x), state


# ===========================================================================

def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "hybrid":
        return HybridLM(cfg)
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg)
    if cfg.family == "ssm":
        return XLSTMLM(cfg)
    if cfg.family == "audio":
        return EncDecLM(cfg)
    raise NotImplementedError(
        f"build_model: the {cfg.family} family ({cfg.name}) is not one the reference "
        "defines; the port builds the dense, moe, vlm, hybrid, ssm and audio families"
    )
