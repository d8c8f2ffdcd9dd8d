"""ChatGLM3-6B [arXiv:2406.12793; hf] — dense, GQA kv=2, 2d (partial) RoPE."""
from repro_torch.configs.base import BlockDesc, ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    head_dim=128,
    rope="2d",             # GLM applies rotary to half of each head dim
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="silu",
    period=(BlockDesc("attn", "dense"),),
    source="arXiv:2406.12793; hf:THUDM/chatglm3-6b",
)
