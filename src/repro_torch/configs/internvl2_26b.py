"""internvl2-26b [vlm]: InternLM2-20B backbone 48L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=92553; InternViT frontend is a stub (precomputed patch
embeddings via input_specs) [arXiv:2404.16821; hf]."""
from .base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    mlp_type="swiglu",
    vlm=VLMConfig(n_img_tokens=256),
    source="arXiv:2404.16821; hf",
)
