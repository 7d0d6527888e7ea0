"""Config system: model architecture + input-shape registry.

A copy of ``repro.configs.base``; only :meth:`ModelConfig.act_dtype` differs:
it returns a torch dtype.

Every assigned architecture gets a module ``configs/<id>.py`` exporting
``CONFIG`` (exact published numbers) built on these dataclasses.  Each config
can derive a ``reduced()`` variant — same family and code paths, tiny sizes —
used by CPU smoke tests; the full config is only ever lowered via
ShapeDtypeStructs in the dry-run.

The four assigned input shapes live in ``SHAPES``; applicability per arch
(decode vs train vs long-context) is resolved by :func:`cells_for`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int               # per-expert FFN hidden size
    n_shared: int = 0           # shared (always-on) experts
    capacity_factor: float = 1.25
    first_dense: int = 0        # leading dense layers (DeepSeek: 1)
    d_first_dense_ff: int = 0   # FFN width of those dense layers
    # "grouped": per-batch-row dispatch groups → (G,E,C,D) buffers sharded
    # over data×model (EP×DP). "global": legacy single pool (§Perf baseline —
    # replicates expert compute across the data axis).
    dispatch: str = "grouped"


@dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 8        # one sLSTM block per this many blocks
    proj_factor: float = 2.0
    chunk: int = 64


@dataclass(frozen=True)
class HybridConfig:
    shared_attn_every: int = 6  # Zamba2: shared attn block cadence
    lora_rank: int = 64


@dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 12
    enc_seq: int = 1500         # stubbed mel-frame embeddings


@dataclass(frozen=True)
class VLMConfig:
    n_img_tokens: int = 256     # stubbed ViT patch embeddings


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    mlp_type: str = "swiglu"                # swiglu | gelu | relu2
    rope_style: str = "full"                # full | chatglm_2d | none | sinusoidal
    norm_type: str = "rmsnorm"              # rmsnorm | layernorm
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    hybrid: Optional[HybridConfig] = None
    enc_dec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    dtype: str = "bfloat16"                 # activation/compute dtype
    param_dtype: str = "float32"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: str = "full"                     # full | dots | none
    attention_impl: str = "full"            # full | blocked (flash-style jnp)
    scan_layers: bool = True
    use_pallas: bool = False                # hand-written kernels vs plain torch
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500 K context (SSM/linear/hybrid state)?"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs are decoder-bearing

    def act_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw: Dict = dict(
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads * 4 // self.n_heads, 4)),
            d_ff=128,
            vocab=256,
            head_dim=16,
            use_pallas=False,
            scan_layers=self.scan_layers,
            dtype="float32",  # CPU smoke: fp32 is faster & removes bf16 noise
        )
        if self.moe:
            kw["moe"] = replace(
                self.moe,
                n_experts=8,
                top_k=min(self.moe.top_k, 2),
                d_expert=32,
                d_first_dense_ff=64 if self.moe.first_dense else 0,
                # no token dropping in smoke tests: decode must equal prefill
                capacity_factor=float(8),
            )
        if self.mla:
            kw["mla"] = MLAConfig(kv_lora=32, qk_nope_dim=16, qk_rope_dim=8, v_dim=16)
        if self.ssm:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16, chunk=16)
        if self.xlstm:
            kw["xlstm"] = replace(self.xlstm, slstm_every=2, chunk=16)
            kw["n_layers"] = 4
        if self.hybrid:
            kw["hybrid"] = replace(self.hybrid, shared_attn_every=2, lora_rank=8)
        if self.enc_dec:
            kw["enc_dec"] = EncDecConfig(n_enc_layers=2, enc_seq=32)
        if self.vlm:
            kw["vlm"] = VLMConfig(n_img_tokens=8)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped). long_500k needs sub-quadratic attention
    (DESIGN.md §3.2); all assigned archs have decoders so decode shapes run."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""


def cells_for(cfg: ModelConfig) -> List[Tuple[ShapeConfig, bool, str]]:
    return [(s, *shape_applicable(cfg, s)) for s in SHAPES.values()]
