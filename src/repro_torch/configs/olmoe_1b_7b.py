"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (MHA kv=16) vocab=50304;
MoE 64 experts top-8, expert d_ff=1024 [arXiv:2409.02060; hf]."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    mlp_type="swiglu",
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024),
    source="arXiv:2409.02060; hf",
)
