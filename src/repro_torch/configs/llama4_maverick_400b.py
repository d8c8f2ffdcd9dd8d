"""Llama-4 Maverick 400B-A17B [hf:meta-llama; unverified] — MoE 128e top-1
+ 1 shared expert, interleaved dense/MoE MLP layers (period 2), GQA kv=8.

The 400B total / 17B active split in the public card comes from alternating
dense-MLP and 128-expert layers; we encode that as a period of 2.
"""
from repro_torch.configs.base import BlockDesc, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=16384,            # dense (non-MoE) layers
    vocab_size=202048,
    head_dim=128,
    rope="1d",
    rope_theta=500_000.0,
    norm="rmsnorm",
    act="silu",
    n_experts=128,
    n_shared_experts=1,
    moe_top_k=1,
    moe_d_ff=8192,
    period=(BlockDesc("attn", "dense"), BlockDesc("attn", "moe")),
    source="hf:meta-llama/Llama-4-Maverick-17B-128E; unverified",
)
