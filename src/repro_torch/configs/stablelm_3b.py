"""StableLM-3B [hf:stabilityai; unverified] — dense MHA (kv=32), LayerNorm."""
from repro_torch.configs.base import BlockDesc, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    head_dim=80,
    rope="1d",
    rope_theta=10_000.0,
    norm="layernorm",
    act="silu",
    period=(BlockDesc("attn", "dense"),),
    source="hf:stabilityai/stablelm-2-1_6b family; unverified",
)
