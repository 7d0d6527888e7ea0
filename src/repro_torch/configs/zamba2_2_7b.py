"""zamba2-2.7b [hybrid]: 54 Mamba2 blocks d_model=2560, ssm_state=64, plus one
parameter-shared attention+MLP block (32H GQA kv=32, d_ff=10240) invoked every
6 blocks with per-invocation LoRA [arXiv:2411.15242; hf]."""
from .base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    mlp_type="gelu",
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4, chunk=64),
    hybrid=HybridConfig(shared_attn_every=6, lora_rank=64),
    source="arXiv:2411.15242; hf",
)
