"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
2D (half-dim interleaved) RoPE, SwiGLU [arXiv:2406.12793; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    mlp_type="swiglu",
    rope_style="chatglm_2d",
    source="arXiv:2406.12793; hf",
)
