"""StarCoder2-7B [arXiv:2402.19173; hf] — dense, GQA kv=4, RoPE, LayerNorm."""
from repro_torch.configs.base import BlockDesc, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    head_dim=128,
    rope="1d",
    rope_theta=1_000_000.0,
    norm="layernorm",
    act="gelu",            # StarCoder2 uses a plain (non-gated) GELU MLP
    period=(BlockDesc("attn", "dense"),),
    source="arXiv:2402.19173; hf:bigcode/starcoder2-7b",
)
