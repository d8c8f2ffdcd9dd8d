"""Qwen3-8B [hf:Qwen/Qwen3-8B] — dense, GQA kv=8, qk_norm, RoPE, SwiGLU."""
from repro_torch.configs.base import BlockDesc, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12288,
    vocab_size=151936,
    head_dim=128,
    rope="1d",
    rope_theta=1_000_000.0,
    qk_norm=True,
    norm="rmsnorm",
    act="silu",
    period=(BlockDesc("attn", "dense"),),
    source="hf:Qwen/Qwen3-8B",
)
