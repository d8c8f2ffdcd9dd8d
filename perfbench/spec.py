"""A model configuration file, read into the sizes the benchmark needs.

The file holds the published ``config.json``'s keys (Hugging Face
names), the cut (``reduced``), what the benchmark assumed, the
deployment it stands for and the comparison's limits.  :class:`ModelSpec`
reads the sizes from those keys alone, so the reference and the work
counts never ask the program for a size.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelSpec:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab: int
    rope_theta: float
    norm: str                    # "layernorm" | "rmsnorm"
    act: str                     # "gelu_tanh" | "silu"
    d_ff: int = 0                # dense MLP width (0: every layer MoE)
    # MLA (DeepSeek-V2)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 0.0

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def qk_dim(self) -> int:
        """The attention core's q/k head dim."""
        return self.qk_nope_dim + self.qk_rope_dim if self.mla \
            else self.head_dim

    @property
    def v_dim(self) -> int:
        return self.v_head_dim if self.mla else self.head_dim


_ACTS = {"gelu_pytorch_tanh": "gelu_tanh", "silu": "silu"}


def load_config(path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec_from_config(cfg: dict, name: Optional[str] = None) -> ModelSpec:
    """The sizes of a configuration file's model.  The MoE layer's
    capacity factor and every other rule the published config does not
    state are read from its ``assumed`` group."""
    assumed = cfg.get("assumed", {})
    d = int(cfg["hidden_size"])
    heads = int(cfg["num_attention_heads"])
    act = _ACTS[cfg["hidden_act"]]
    # the norm: the config's ``norm_type``, else the one assumed
    norm_type = cfg.get("norm_type", assumed.get("norm_type"))
    norm = "layernorm" if norm_type == "layer_norm" else "rmsnorm"
    kw = dict(name=name or cfg.get("model_type", "model"),
              n_layers=int(cfg["num_hidden_layers"]), d_model=d,
              n_heads=heads,
              n_kv_heads=int(cfg.get("num_key_value_heads", heads)),
              head_dim=int(cfg.get("head_dim") or d // heads),
              vocab=int(cfg["vocab_size"]),
              rope_theta=float(cfg["rope_theta"]), norm=norm, act=act)
    if "kv_lora_rank" in cfg:
        kw.update(mla=True, q_lora_rank=int(cfg.get("q_lora_rank") or 0),
                  kv_lora_rank=int(cfg["kv_lora_rank"]),
                  qk_nope_dim=int(cfg["qk_nope_head_dim"]),
                  qk_rope_dim=int(cfg["qk_rope_head_dim"]),
                  v_head_dim=int(cfg["v_head_dim"]))
    if cfg.get("n_routed_experts"):
        kw.update(n_experts=int(cfg["n_routed_experts"]),
                  n_shared_experts=int(cfg.get("n_shared_experts") or 0),
                  top_k=int(cfg["num_experts_per_tok"]),
                  moe_d_ff=int(cfg["moe_intermediate_size"]),
                  capacity_factor=float(assumed["moe_capacity_factor"]))
        if assumed.get("moe_in_every_layer"):
            kw["d_ff"] = 0
        else:
            kw["d_ff"] = int(cfg["intermediate_size"])
    else:
        kw["d_ff"] = int(cfg["intermediate_size"])
    return ModelSpec(**kw)
