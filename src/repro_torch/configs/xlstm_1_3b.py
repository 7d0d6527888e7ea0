"""xlstm-1.3b [ssm]: 48 blocks d_model=2048 4H, sLSTM + mLSTM, no FFN
(d_ff=0 honoured: the blocks carry their own up/down projections)
[arXiv:2405.04517; unverified]."""
from .base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=512,
    rope_style="none",
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0, chunk=64),
    source="arXiv:2405.04517; unverified",
)
