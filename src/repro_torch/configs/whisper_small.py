"""whisper-small [audio]: enc-dec, 12+12L d_model=768 12H (MHA kv=12)
d_ff=3072 vocab=51865; conv mel frontend is a stub (precomputed frame
embeddings via input_specs) [arXiv:2212.04356; unverified]."""
from .base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    mlp_type="gelu",
    norm_type="layernorm",
    rope_style="sinusoidal",
    enc_dec=EncDecConfig(n_enc_layers=12, enc_seq=1500),
    source="arXiv:2212.04356; unverified",
)
