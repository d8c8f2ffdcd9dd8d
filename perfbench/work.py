"""The yardstick's arithmetic: the card's published peaks, a kernel call's
operations and bytes from its shapes, and the products one prefill runs.

Frozen here, apart from the program: a later change to the program may
move what it launches, not what the work is.  The products are listed
from the configuration's sizes (:mod:`perfbench.spec`), in the order a
layer runs them; ``engine`` says which of the port's paths runs each one
(``k1``: K1 in bf16, ``k1f32``: K1's f32 variant, ``einsum``: PyTorch's
own, ``k2``: K2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from perfbench.spec import ModelSpec

# NVIDIA H100 SXM data sheet, dense, at its 700 W power limit
PEAK_BF16 = 989e12          # FLOP/s, bf16 on the tensor cores
PEAK_F32 = 66.9e12          # FLOP/s, f32 outside the tensor cores
HBM_BPS = 3.35e12           # bytes/s

# the port's kernels by the names their launches carry in a device trace
KERNELS = {
    "k1": ("matmul_tma_kernel", "matmul_swap_kernel",
           "matmul_unaligned_kernel"),
    "k1f32": ("matmul_f32_kernel",),
    "k2": ("flash_tma_kernel", "flash_unaligned_kernel"),
    "k3": ("chunk_state_kernel", "state_pass_kernel", "chunk_out_kernel"),
}


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least time the card could take: operations at the peak rate or
    bytes at the HBM rate, whichever is longer."""
    return max(flops / peak, nbytes / HBM_BPS)


def matmul_work(M: int, N: int, K: int, itemsize: int = 2):
    """``(flops, bytes)`` of ``y(M,N) = x(M,K) @ w(K,N)``: x and w read
    once, y written once."""
    return 2.0 * M * N * K, float(itemsize) * (M * K + K * N + M * N)


def k2_work(B, H, Hkv, Sq, Skv, D, causal=True, Dv=None):
    """``(flops, bytes)`` of one attention call: the causal half of the two
    products (Sq = Skv), Q.K^T at D and P.V at the value dim Dv (default
    D), q, k, v read once and out written once, in bf16."""
    Dv = D if Dv is None else Dv
    pairs = Sq * (Sq + 1) / 2 if causal else Sq * Skv
    return (2.0 * B * H * (D + Dv) * pairs,
            2.0 * (B * H * Sq * (D + Dv) + B * Hkv * Skv * (D + Dv)))


@dataclass(frozen=True)
class Product:
    """One product a prefill runs ``count`` times (once a layer)."""
    site: str
    engine: str          # "k1" | "k1f32" | "einsum" | "k2"
    count: int
    M: int = 0
    N: int = 0
    K: int = 0
    attn: tuple = ()     # k2: (B, H, Hkv, S, D, Dv)

    @property
    def flops(self) -> float:
        return self.work[0]

    @property
    def work(self):
        if self.engine == "k2":
            B, H, Hkv, S, D, Dv = self.attn
            return k2_work(B, H, Hkv, S, S, D, True, Dv)
        return matmul_work(self.M, self.N, self.K,
                           4 if self.engine == "k1f32" else 2)

    @property
    def bound(self) -> float:
        f, b = self.work
        return bound_s(f, b, PEAK_F32 if self.engine == "k1f32"
                       else PEAK_BF16)


def prefill_products(s: ModelSpec, batch: int, seq: int) -> List[Product]:
    """The products of one prefill of ``batch`` prompts of ``seq`` tokens
    that return the last position's logits.  The MoE layer's experts are
    counted at the tokens routed to them (``T * top_k`` rows), the useful
    work, not at the capacity buffer the program fills."""
    T, L, d = batch * seq, s.n_layers, s.d_model
    out = []
    if s.mla:
        h, dn, dr, dv = s.n_heads, s.qk_nope_dim, s.qk_rope_dim, \
            s.v_head_dim
        r = s.kv_lora_rank
        if s.q_lora_rank:
            out += [Product("mla.q_down", "k1", L, T, s.q_lora_rank, d),
                    Product("mla.q_up", "k1", L, T, h * (dn + dr),
                            s.q_lora_rank)]
        else:
            out.append(Product("mla.q", "k1", L, T, h * (dn + dr), d))
        out += [Product("mla.kv_down", "k1", L, T, r + dr, d),
                Product("mla.k_up", "einsum", L, T, h * dn, r),
                Product("mla.v_up", "einsum", L, T, h * dv, r),
                Product("mla.core", "k2", L,
                        attn=(batch, h, h, seq, dn + dr, dv)),
                Product("mla.o", "k1", L, T, d, h * dv)]
    else:
        h, hkv, hd = s.n_heads, s.n_kv_heads, s.head_dim
        out += [Product("attn.q", "k1", L, T, h * hd, d),
                Product("attn.k", "k1", L, T, hkv * hd, d),
                Product("attn.v", "k1", L, T, hkv * hd, d),
                Product("attn.core", "k2", L,
                        attn=(batch, h, hkv, seq, hd, hd)),
                Product("attn.o", "k1", L, T, d, h * hd)]
    if s.moe:
        f, k = s.moe_d_ff, s.top_k
        out += [Product("moe.router", "k1f32", L, T, s.n_experts, d),
                Product("moe.expert_up", "einsum", L, T * k, f, d),
                Product("moe.expert_gate", "einsum", L, T * k, f, d),
                Product("moe.expert_down", "einsum", L, T * k, d, f)]
        if s.n_shared_experts:
            fs = f * s.n_shared_experts
            out += [Product("moe.shared_gate", "k1", L, T, fs, d),
                    Product("moe.shared_up", "k1", L, T, fs, d),
                    Product("moe.shared_down", "k1", L, T, d, fs)]
    else:
        f = s.d_ff
        if s.act == "silu":
            out.append(Product("mlp.gate", "k1", L, T, f, d))
        out += [Product("mlp.up", "k1", L, T, f, d),
                Product("mlp.down", "k1", L, T, d, f)]
    out.append(Product("lm_head", "k1", 1, batch, s.vocab, d))
    return out


def prefill_flops(s: ModelSpec, batch: int, seq: int) -> float:
    """The model's operations in one prefill (useful work only)."""
    return sum(p.flops * p.count for p in prefill_products(s, batch, seq))


def engine_bound_s(s: ModelSpec, batch: int, seq: int, engine: str) -> float:
    """The bound, in seconds, of the calls one prefill makes to ``engine``:
    each call's bound summed."""
    return sum(p.bound * p.count for p in prefill_products(s, batch, seq)
               if p.engine == engine)
