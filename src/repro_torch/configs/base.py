"""Model architecture configs: a copy of the JAX package's ``configs/base.py``.

A config fully determines the model.  Layer stacking is a repeating
*period* of block descriptors; the port runs the layers in a Python loop,
with each period slot's parameters stacked along a leading layer axis as
in the reference (so converted weights map one to one).

``ARCH_IDS`` lists the reference's ten architectures in its order
(``PORTED_ARCHS`` is the same tuple); ``get_config`` knows exactly these.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass

ARCH_IDS = ("starcoder2_7b", "qwen3_8b", "stablelm_3b", "chatglm3_6b",
            "deepseek_v2_236b", "llama4_maverick_400b", "xlstm_1_3b",
            "phi3_vision_4_2b", "seamless_m4t_medium", "jamba_v0_1_52b")
PORTED_ARCHS = ARCH_IDS


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
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def d_kv_total(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return all(b.kind != "attn" for b in self.period)

    @property
    def subquadratic(self) -> bool:
        """True when decode state does not grow quadratically costly with
        context: the arch may run the 500k-context shape."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Total parameter count (for 6·N·D roofline bookkeeping)."""
        return _count_params(self)

    def active_param_count(self) -> int:
        """Parameters active per token (MoE: shared + top-k routed)."""
        return _count_params(self, active_only=True)

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


def _gated(act: str) -> bool:
    return act == "silu"


def _count_params(c: ModelConfig, active_only: bool = False) -> int:
    d = c.d_model
    total = c.vocab_size * d                       # embed
    if not c.tie_embeddings:
        total += c.vocab_size * d                  # lm head

    def attn_params() -> int:
        if c.mla:
            p = 0
            q_dim = c.n_heads * (c.qk_nope_dim + c.qk_rope_dim)
            if c.q_lora_rank:
                p += d * c.q_lora_rank + c.q_lora_rank * q_dim
            else:
                p += d * q_dim
            p += d * (c.kv_lora_rank + c.qk_rope_dim)            # down (kv + rope)
            p += c.kv_lora_rank * c.n_heads * (c.qk_nope_dim + c.v_head_dim)
            p += c.n_heads * c.v_head_dim * d                    # out proj
            return p
        return d * c.d_head_total + 2 * d * c.d_kv_total + c.d_head_total * d

    def dense_mlp_params() -> int:
        mult = 3 if _gated(c.act) else 2
        return mult * d * c.d_ff

    def moe_mlp_params(active: bool) -> int:
        mult = 3 if _gated(c.act) else 2
        n_routed = c.moe_top_k if active else c.n_experts
        p = (n_routed + c.n_shared_experts) * mult * d * c.moe_d_ff
        p += d * c.n_experts                                      # router
        return p

    def ssm_params() -> int:
        di, n = c.d_inner_ssm, c.ssm_state_dim
        h = c.n_ssm_heads
        return (d * 2 * di + di * c.ssm_conv_width + di * 2 * n
                + di + h + di * d)

    def xlstm_params(kind: str) -> int:
        if kind == "mlstm":
            # up(2 branches) + block-diagonal per-head qkv + gates + down
            di = int(c.xlstm_proj_factor * d)
            return d * 2 * di + 3 * di * di // c.n_heads + 2 * di + di * d
        # sLSTM: 4 gates (input + block-diag recurrent per head) + GLU MLP
        hd = d // c.n_heads
        return 4 * d * d + 4 * c.n_heads * hd * hd + 2 * d * (4 * d // 3)

    def block_params(b: BlockDesc, active: bool) -> int:
        p = 0
        if b.kind == "attn":
            p += attn_params()
        elif b.kind == "mamba":
            p += ssm_params()
        elif b.kind in ("mlstm", "slstm"):
            p += xlstm_params(b.kind)
        if b.mlp == "dense":
            p += dense_mlp_params()
        elif b.mlp == "moe":
            p += moe_mlp_params(active)
        return p

    n_units = (c.n_enc_layers + c.n_dec_layers) if c.enc_dec else c.n_layers
    per_period = sum(block_params(b, active_only) for b in c.period)
    total += per_period * (n_units // len(c.period))
    if c.enc_dec:   # cross-attention in decoder layers
        total += c.n_dec_layers * attn_params()
    return int(total)


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


def supported_shapes(cfg: ModelConfig) -> dict:
    """Which of the four shapes an arch runs, with the reference's reason
    for each skip."""
    out = {}
    for name in SHAPES:
        if name == "long_500k" and not cfg.subquadratic:
            out[name] = "SKIP: pure full-attention arch — 500k dense decode "\
                        "is quadratic-state; run only for ssm/hybrid per spec"
            continue
        out[name] = "run"
    return out


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"arch {arch!r} is not an arch of the port, which "
                         f"serves {', '.join(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
