"""Jamba-v0.1 52B [arXiv:2403.19887; hf] — hybrid Mamba+attention 7:1
interleave, MoE 16e top-2 on alternating layers, GQA kv=8.

Period of 8 layers (4 scanned super-blocks): attention sits at index 3 of
each period (matching the paper's placement mid-block), MoE MLP on the odd
indices (every other layer, 16 experts top-2), dense MLP elsewhere.

Hybrid family: Mamba layers have O(1) decode state, the 4 attention layers
keep a KV cache — long_500k runs with the cache sequence-sharded (SP).
The Mamba mixer uses the SSD (Mamba-2 style, scalar-per-head decay)
chunkwise-parallel formulation — TPU-friendly (4 matmuls per chunk) and
profile-equivalent to the paper's Mamba-1 kernel; recorded as a deviation
in DESIGN.md §2.
"""
from repro_torch.configs.base import BlockDesc, ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    rope="none",           # Jamba uses no positional encoding (Mamba provides order)
    norm="rmsnorm",
    act="silu",
    n_experts=16,
    n_shared_experts=0,
    moe_top_k=2,
    moe_d_ff=14336,
    ssm_state_dim=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    period=(
        BlockDesc("mamba", "dense"), BlockDesc("mamba", "moe"),
        BlockDesc("mamba", "dense"), BlockDesc("attn",  "moe"),
        BlockDesc("mamba", "dense"), BlockDesc("mamba", "moe"),
        BlockDesc("mamba", "dense"), BlockDesc("mamba", "moe"),
    ),
    source="arXiv:2403.19887; hf:ai21labs/Jamba-v0.1",
)
