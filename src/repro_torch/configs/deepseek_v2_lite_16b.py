"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H, MLA (kv_lora=512),
2 shared + 64 routed experts top-6, expert d_ff=1408, vocab=102400, first
layer dense (d_ff=10944) [arXiv:2405.04434; hf].

NOTE: the assignment prose says "160 routed" but the spec header says
"MoE 64e top-6"; 64 routed is correct for V2-*Lite* (DESIGN.md §3.1)."""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    mlp_type="swiglu",
    mla=MLAConfig(kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared=2,
        first_dense=1,
        d_first_dense_ff=10944,
    ),
    source="arXiv:2405.04434; hf",
)
