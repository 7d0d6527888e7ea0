"""bert_base: the paper's own end-to-end workload (§6): 12L 16H d_model=2048
transformer trained with FlexFlow-style simulation. We model it as a dense
decoder with GELU MLP (d_ff=4*d) for the task-graph benchmarks."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="bert-base-paper",
    family="dense",
    n_layers=12,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=30522,
    mlp_type="gelu",
    norm_type="layernorm",
    source="paper §6 workload",
)
