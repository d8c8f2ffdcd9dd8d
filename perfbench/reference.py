"""The plain reference: a prefill's last-position logits in float32.

Written from the configuration's sizes (:mod:`perfbench.spec`) in plain
``torch`` operations, layer by layer, with TF32 off; it imports nothing of
the program.  It takes the weights the benchmark drew, in the layout of
the parameter tree they were drawn into (a period of one block, each leaf
stacked over the layers), and converts one layer at a time to float32,
so that it runs beside the model on the card.

It follows the published models where the port does, and the port where
it departs, so that a difference is the program's precision and nothing
else; each departure is named where it is made (``PERF.md`` lists them):

* RoPE rotates interleaved pairs (dims ``0::2`` with ``1::2``), not
  Hugging Face's halves; DeepSeek-V2's YaRN scaling is not applied.
* StarCoder2's linear layers carry no bias (published: ``use_bias``);
  its sliding window (4096) never binds at these lengths.
* DeepSeek-V2's MoE: every layer is MoE (published: the first is
  dense); each token takes its top-k experts by softmax probability over
  all experts (published: group-limited, the best 3 of 8 groups), its
  gates renormalised over the k (published: ``norm_topk_prob`` false and
  ``routed_scaling_factor`` 16); an expert takes at most ``C`` tokens
  (the port's capacity rule, factor ``assumed.moe_capacity_factor``),
  slot 0 of every token before slot 1, later tokens dropped.

``quant="fp8"`` is the control: every product's operands rounded to
float8 e4m3 with a scale per tensor (per weight matrix, per expert), the
step below bfloat16 that would tempt a faster program.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.spec import ModelSpec

FP8_MAX = 448.0                 # float8 e4m3's largest finite value


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


class _Arith:
    """The reference's products, exact in f32 or through the fp8
    control."""

    def __init__(self, quant: Optional[str]):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant {quant!r}: None or 'fp8'")
        self.quant = quant

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in f32, rounded to e4m3 under a per-tensor scale in the
        control."""
        x = x.float()
        if self.quant is None:
            return x
        s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s

    def mm(self, x, w):
        return self.q(x) @ self.q(w)

    def einsum(self, spec, a, b):
        return torch.einsum(spec, self.q(a), self.q(b))


def _f(t):
    return t.float()


def layer_norm(x, p):
    """LayerNorm (eps 1e-5) where ``p`` has a bias, else RMSNorm (eps
    1e-6)."""
    if "bias" in p:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * _f(p["scale"]) + \
            _f(p["bias"])
    return rms_norm(x, p["scale"])


def rms_norm(x, scale):
    return x / torch.sqrt((x ** 2).mean(-1, keepdim=True) + 1e-6) * \
        _f(scale)


def rope(x, theta: float):
    """x (B, H, S, D): interleaved pairs rotated by position 0..S-1."""
    S, D = x.shape[-2], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    a, b = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = a * cos - b * sin
    out[..., 1::2] = b * cos + a * sin
    return out


def causal_attention(ar: _Arith, q, k, v):
    """q (B, H, S, D), k (B, H, S, D), v (B, H, S, Dv): softmax over the
    keys at or before each query, scaled by D^-1/2."""
    S = q.shape[-2]
    s = ar.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    s = s.masked_fill(mask, float("-inf"))
    return ar.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


def gqa(spec: ModelSpec, ar: _Arith, p, x):
    B, S, _ = x.shape
    H, Hkv, D = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = ar.mm(x, p["wq"]).view(B, S, H, D).transpose(1, 2)
    k = ar.mm(x, p["wk"]).view(B, S, Hkv, D).transpose(1, 2)
    v = ar.mm(x, p["wv"]).view(B, S, Hkv, D).transpose(1, 2)
    q, k = rope(q, spec.rope_theta), rope(k, spec.rope_theta)
    # query head h reads kv head h // (H / Hkv)
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    o = causal_attention(ar, q, k, v)
    return ar.mm(o.transpose(1, 2).reshape(B, S, H * D), p["wo"])


def mla(spec: ModelSpec, ar: _Arith, p, x):
    """Multi-head latent attention in its expanded form."""
    B, S, _ = x.shape
    H, dn, dr, dv = spec.n_heads, spec.qk_nope_dim, spec.qk_rope_dim, \
        spec.v_head_dim
    r = spec.kv_lora_rank
    if spec.q_lora_rank:
        q = ar.mm(rms_norm(ar.mm(x, p["wq_a"]), p["q_norm"]), p["wq_b"])
    else:
        q = ar.mm(x, p["wq"])
    q = q.view(B, S, H, dn + dr).transpose(1, 2)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], spec.rope_theta)], -1)
    kv = ar.mm(x, p["wkv_a"])
    c = rms_norm(kv[..., :r], p["kv_norm"])                    # (B, S, r)
    k_rope = rope(kv[:, None, :, r:], spec.rope_theta)         # (B,1,S,dr)
    k_nope = ar.einsum("bsr,rhd->bhsd", c, p["w_uk"])
    v = ar.einsum("bsr,rhd->bhsd", c, p["w_uv"])
    k = torch.cat([k_nope, k_rope.expand(B, H, S, dr)], dim=-1)
    o = causal_attention(ar, q, k, v)
    return ar.mm(o.transpose(1, 2).reshape(B, S, H * dv), p["wo"])


def mlp(spec: ModelSpec, ar: _Arith, p, x):
    if spec.act == "silu":
        h = F.silu(ar.mm(x, p["wg"])) * ar.mm(x, p["wi"])
    else:
        h = F.gelu(ar.mm(x, p["wi"]), approximate="tanh")
    return ar.mm(h, p["wo"])


def capacity(spec: ModelSpec, n_tokens: int) -> int:
    """Tokens an expert takes: ``T * k * factor / E`` rounded down, then
    up to a multiple of 8, at least 8."""
    c = int(n_tokens * spec.top_k * spec.capacity_factor / spec.n_experts)
    return max(8, -(-c // 8) * 8)


def route(spec: ModelSpec, logits: torch.Tensor):
    """Top-k by softmax probability with capacity, slot-major.  Returns
    ``(experts, gates, kept)``, each (T, k): the renormalised gates and
    whether the expert keeps the token in that slot."""
    T = logits.shape[0]
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, spec.top_k, dim=-1, sorted=True)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    C = capacity(spec, T)
    e_np = experts.cpu().numpy()
    kept = np.zeros(e_np.shape, dtype=bool)
    load = np.zeros(spec.n_experts, dtype=np.int64)
    for slot in range(spec.top_k):          # slot 0 of every token first
        for t in range(T):
            e = e_np[t, slot]
            kept[t, slot] = load[e] < C
            load[e] += 1
    return experts, gates, torch.from_numpy(kept).to(logits.device)


def moe(spec: ModelSpec, ar: _Arith, p, x):
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    # the router stays in f32 in the control too: the configuration
    # states it so
    experts, gates, kept = route(spec, xt @ _f(p["router"]))
    y = torch.zeros_like(xt)
    w = gates * kept
    for e in range(spec.n_experts):
        tok, slot = torch.nonzero((experts == e) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xt[tok]
        h = F.silu(ar.mm(xe, p["ewg"][e])) * ar.mm(xe, p["ewi"][e])
        y.index_add_(0, tok, ar.mm(h, p["ewo"][e]) * w[tok, slot, None])
    if spec.n_shared_experts:
        h = F.silu(ar.mm(xt, p["shared_wg"])) * ar.mm(xt, p["shared_wi"])
        y = y + ar.mm(h, p["shared_wo"])
    return y.view(B, S, d)


def _layer(tree, i):
    """Layer ``i`` of a stacked tree (views, still in the drawn type)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


@torch.no_grad()
def prefill_logits(spec: ModelSpec, params: dict, tokens: torch.Tensor,
                   quant: Optional[str] = None) -> torch.Tensor:
    """(B, V) float32 logits at the last position of ``tokens`` (B, S)."""
    ar = _Arith(quant)
    with exact_f32():
        x = _f(params["embed"][tokens]) * math.sqrt(spec.d_model)
        (stack,) = params["blocks"]
        for i in range(spec.n_layers):
            p = _layer(stack, i)
            h = layer_norm(x, p["norm1"])
            x = x + (mla if spec.mla else gqa)(spec, ar, p["mixer"], h)
            h = layer_norm(x, p["norm2"])
            x = x + (moe if spec.moe else mlp)(spec, ar, p["mlp"], h)
        x = layer_norm(x[:, -1], params["final_norm"])
        return ar.mm(x, params["head"].T)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each row's distance from the reference over the reference row's
    spread: ``||out - ref|| / ||ref - mean(ref)||``."""
    out, ref = out.float(), ref.float()
    spread = (ref - ref.mean(-1, keepdim=True)).norm(dim=-1)
    return (out - ref).norm(dim=-1) / spread
