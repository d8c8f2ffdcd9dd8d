"""Phi-3-Vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct] — phi3-mini
backbone (32L d=3072 MHA) + CLIP vision frontend.

Per spec the modality frontend is a STUB: ``input_specs()`` supplies
precomputed patch embeddings (batch, n_patches, d_model) which occupy the
sequence prefix; only the transformer backbone is built/tuned.
"""
from repro_torch.configs.base import BlockDesc, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    rope="1d",
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="silu",
    frontend="vision",
    n_frontend_tokens=256,   # 16x16 patch grid stand-in
    period=(BlockDesc("attn", "dense"),),
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
