"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
Llama-arch code model [arXiv:2405.04324; hf]. GPTBigCode lineage -> GELU MLP."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    mlp_type="gelu",
    source="arXiv:2405.04324; hf",
)
