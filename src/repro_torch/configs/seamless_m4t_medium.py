"""SeamlessM4T-medium [arXiv:2308.11596; hf] — encoder-decoder, 12+12 layers,
d=1024, MHA 16 heads, vocab 256206.

Audio frontend is a STUB per spec: ``input_specs()`` supplies precomputed
frame embeddings (batch, n_frames, d_model) as the encoder input; the
text decoder consumes target tokens.  Decode shapes exercise the decoder
with a frozen encoder memory.
"""
from repro_torch.configs.base import BlockDesc, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=24,           # 12 encoder + 12 decoder
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    rope="none",           # learned/sinusoidal positions in the original
    norm="layernorm",
    act="gelu",
    enc_dec=True,
    n_enc_layers=12,
    n_dec_layers=12,
    frontend="audio",
    n_frontend_tokens=0,   # encoder input IS the frame-embedding sequence
    period=(BlockDesc("attn", "dense"),),
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-medium",
)
