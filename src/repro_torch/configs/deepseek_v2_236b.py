"""DeepSeek-V2 236B [arXiv:2405.04434; hf] — MLA (kv_lora=512) + MoE 160e top-6,
2 shared experts, per-expert d_ff=1536.

Deviation from HF checkpoint (recorded): the real model's first layer uses a
dense MLP (d_ff=12288); we make every layer MoE so the stack scans uniformly
(60 identical periods).  Param count impact < 0.1%.
"""
from repro_torch.configs.base import BlockDesc, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,        # nominal; MLA replaces GQA entirely
    d_ff=0,
    vocab_size=102400,
    head_dim=128,
    rope="1d",             # decoupled rope on the qk_rope_dim slice (MLA)
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="silu",
    n_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1536,
    mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    period=(BlockDesc("attn", "moe"),),
    source="arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2",
)
