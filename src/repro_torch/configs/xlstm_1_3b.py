"""xLSTM-1.3B [arXiv:2405.04517; unverified]: 48 blocks, mLSTM:sLSTM 7:1,
4 heads, no MLP (mLSTM blocks carry their own up/down projection).  A copy
of the JAX package's ``configs/xlstm_1_3b.py``."""
from repro_torch.configs.base import BlockDesc, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=512,
    rope="none",
    norm="layernorm",
    act="gelu",
    xlstm_proj_factor=2.0,
    tie_embeddings=True,
    period=(
        BlockDesc("mlstm", "none"), BlockDesc("mlstm", "none"),
        BlockDesc("mlstm", "none"), BlockDesc("mlstm", "none"),
        BlockDesc("mlstm", "none"), BlockDesc("mlstm", "none"),
        BlockDesc("mlstm", "none"), BlockDesc("slstm", "none"),
    ),
    source="arXiv:2405.04517 (xLSTM[7:1]); unverified",
)
