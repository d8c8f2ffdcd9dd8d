"""Model architecture configs: a copy of the JAX package's ``configs/base.py``.

A config fully determines the model.  Layer stacking is a repeating
*period* of block descriptors; the port runs the layers in a Python loop,
with each period slot's parameters stacked along a leading layer axis as
in the reference (so converted weights map one to one).

``PORTED_ARCHS`` lists the reference's ten architectures in its order
(``ARCH_IDS``); ``get_config`` knows exactly these.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass

PORTED_ARCHS = ("starcoder2_7b", "qwen3_8b", "stablelm_3b", "chatglm3_6b",
                "deepseek_v2_236b", "llama4_maverick_400b", "xlstm_1_3b",
                "phi3_vision_4_2b", "seamless_m4t_medium", "jamba_v0_1_52b")


@dataclass(frozen=True)
class BlockDesc:
    """One entry of the repeating layer period."""

    kind: str           # "attn" | "mamba" | "mlstm" | "slstm"
    mlp: str = "dense"  # "dense" | "moe" | "none"

    def __post_init__(self):
        if self.kind not in ("attn", "mamba", "mlstm", "slstm"):
            raise ValueError(self.kind)
        if self.mlp not in ("dense", "moe", "none"):
            raise ValueError(self.mlp)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0              # 0 -> d_model // n_heads
    rope: str = "1d"               # "1d" | "2d" | "none"
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    norm: str = "rmsnorm"          # "rmsnorm" | "layernorm"
    act: str = "silu"              # "silu" (gated) | "gelu"
    tie_embeddings: bool = False

    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0

    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    ssm_state_dim: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    xlstm_proj_factor: float = 2.0

    enc_dec: bool = False
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    frontend: str = "none"
    n_frontend_tokens: int = 0

    period: tuple = (BlockDesc("attn", "dense"),)

    dtype: str = "bfloat16"

    source: str = ""
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.enc_dec and self.n_layers % len(self.period):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not "
                             f"divisible by period of {len(self.period)}")

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim

    @property
    def n_prefix(self) -> int:
        """Positions a vision frontend's embeddings take before the
        tokens."""
        return self.n_frontend_tokens if self.frontend == "vision" else 0

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU tests (the reference's rule)."""
        small = dict(
            n_layers=len(self.period),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
            n_experts=min(self.n_experts, 4),
            moe_top_k=min(self.moe_top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_d_ff=64 if self.moe_d_ff else 0,
            kv_lora_rank=32 if self.mla else 0,
            q_lora_rank=48 if (self.mla and self.q_lora_rank) else 0,
            qk_nope_dim=16 if self.mla else 0,
            qk_rope_dim=8 if self.mla else 0,
            v_head_dim=16 if self.mla else 0,
            ssm_state_dim=16,
            ssm_head_dim=16,
            ssm_chunk=8,
            n_enc_layers=2 if self.enc_dec else 0,
            n_dec_layers=2 if self.enc_dec else 0,
            n_frontend_tokens=8 if self.frontend != "none" else 0,
            dtype="float32",
            name=self.name + "-smoke",
        )
        if self.enc_dec:
            small["n_layers"] = 4
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeConfig:
    """One input shape (a copy of the reference's)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in PORTED_ARCHS:
        raise ValueError(f"arch {arch!r} is not an arch of the port, which "
                         f"serves {', '.join(PORTED_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG
