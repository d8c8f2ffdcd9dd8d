"""The yardstick's arithmetic: operations and bytes from shapes, the
products of a prefill against the sites the program records, and the
trace's reductions on a synthetic timeline."""

import pytest
import torch

from perfbench import timeline as tl
from perfbench import work
from perfbench.spec import load_config, spec_from_config
from perfbench.tests.conftest import REPO, TINY_GQA, TINY_MLA


def test_starcoder2_prefill_flops_by_hand():
    s = spec_from_config(load_config(
        REPO / "perfbench/configs/starcoder2_7b.json"))
    d, T, L = 4608, 4 * 512, 32
    per_token = d * (4608 + 512 + 512 + 4608) + 2 * d * 18432
    attn = 2 * 4 * 36 * (128 + 128) * (512 * 513 / 2)
    want = L * (2 * T * per_token + attn) + 2 * 4 * 49152 * d
    assert work.prefill_flops(s, 4, 512) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(2.876e13, rel=1e-3)


def test_deepseek_v2_prefill_flops_by_hand():
    s = spec_from_config(load_config(
        REPO / "perfbench/configs/deepseek_v2_236b_l4.json"))
    d, T, L, h = 5120, 4 * 512, 4, 128
    per_token = (d * 1536 + 1536 * h * 192 + d * 576 + 512 * h * 128 * 2
                 + h * 128 * d + 6 * 3 * d * 1536 + 3 * d * 3072
                 + d * 160)
    attn = 2 * 4 * h * (192 + 128) * (512 * 513 / 2)
    want = L * (2 * T * per_token + attn) + 2 * 4 * 102400 * d
    assert work.prefill_flops(s, 4, 512) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(5.73e12, rel=1e-3)


def test_bound_and_k2_work():
    # the Qwen3-8B prefill's attention: bytes bound it (42 MB at 3.35
    # TB/s, 0.0125 ms) against 8.6 GFLOP (0.0087 ms)
    f, b = work.k2_work(4, 32, 8, 512, 512, 128)
    assert f == 2 * 4 * 32 * 256 * 512 * 513 / 2
    assert b == 2 * (4 * 32 * 512 * 256 + 4 * 8 * 512 * 256)
    assert work.bound_s(f, b) == pytest.approx(b / 3.35e12)
    assert work.bound_s(f, b) == pytest.approx(1.25e-5, rel=0.02)
    # MLA's core: D = 192, Dv = 128
    f, b = work.k2_work(4, 128, 128, 512, 512, 192, Dv=128)
    assert b == pytest.approx(335e6, rel=0.01)
    assert f == pytest.approx(42.9e9, rel=0.01)
    # a square bf16 product is bound by its operations
    f, b = work.matmul_work(4096, 4096, 4096)
    assert work.bound_s(f, b) == pytest.approx(2 * 4096 ** 3 / 989e12)
    assert work.bound_s(f, b, work.PEAK_F32) == pytest.approx(
        2 * 4096 ** 3 / 66.9e12)


@pytest.mark.parametrize("cfg", [TINY_GQA, TINY_MLA], ids=["gqa", "mla"])
def test_products_are_the_sites_the_program_records(cfg):
    """Every K1 product the yardstick counts is a matmul site the
    program's prefill records, at the same (M, N, K) and dtype, and K2's
    is its attention site."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import compute
    from repro_torch.models.lm import build_model
    spec = spec_from_config(cfg)
    base = get_config(cfg["port_arch"])
    kw = dict(n_layers=spec.n_layers, d_model=spec.d_model,
              n_heads=spec.n_heads, d_ff=spec.d_ff, vocab_size=spec.vocab,
              dtype="bfloat16")
    if spec.mla:
        kw.update(kv_lora_rank=spec.kv_lora_rank,
                  q_lora_rank=spec.q_lora_rank, qk_nope_dim=spec.qk_nope_dim,
                  qk_rope_dim=spec.qk_rope_dim, v_head_dim=spec.v_head_dim,
                  n_experts=spec.n_experts, moe_top_k=spec.top_k,
                  n_shared_experts=spec.n_shared_experts,
                  moe_d_ff=spec.moe_d_ff)
    else:
        kw.update(n_kv_heads=spec.n_kv_heads, head_dim=spec.head_dim)
    model = build_model(dataclasses.replace(base, **kw))
    meta = torch.device("meta")
    params = model.init(device=meta)
    cache = model.make_cache(2, 80, device=meta)
    rec = compute.SiteRecorder()
    with compute.compute_mode("eager", recorder=rec), torch.no_grad():
        model.prefill(params, {"tokens": torch.empty(
            (2, 64), dtype=torch.long, device=meta)}, cache)
    sites = {(s.site, s.m, s.n, s.k) for s in rec.unique_sites()
             if s.kind == "matmul"}
    prods = work.prefill_products(spec, 2, 64)
    k1 = {(p.site, p.M, p.N, p.K) for p in prods
          if p.engine in ("k1", "k1f32")}
    assert k1 == sites
    (att,) = [s for s in rec.unique_sites() if s.kind == "attention"]
    (core,) = [p for p in prods if p.engine == "k2"]
    B, H, Hkv, S, D, Dv = core.attn
    assert (att.m, att.n, att.k, att.batch) == (S, D, S, B * H)


def _ev(name, device, a, b):
    return tl.Event(name, device, float(a), float(b))


def test_idle_share_and_host_ops_on_a_synthetic_timeline():
    ev = [
        _ev("perfbench.prefill", False, 0, 100),
        _ev("aten::mm", False, 5, 15),
        _ev("cudaLaunchKernel", False, 10, 12),
        _ev("void matmul_swap_kernel<32>(int)", True, 12, 40),
        _ev("void flash_tma_kernel<1>(int)", True, 30, 50),   # overlaps
        _ev("aten::topk", False, 55, 75),
        _ev("elementwise_kernel", True, 80, 90),
        _ev("Memset (Device)", True, 95, 97),
        _ev("perfbench.prefill", False, 110, 200),
        _ev("void matmul_f32_kernel", True, 120, 130),
    ]
    t0, t1, n = tl.window(ev)
    assert (t0, t1, n) == (0, 200, 2)
    assert tl.busy_intervals(ev, t0, t1) == [(12, 50), (80, 90), (95, 97),
                                             (120, 130)]
    assert tl.busy_us(ev, t0, t1) == 38 + 10 + 2 + 10
    assert tl.idle_gaps(ev, t0, t1)[:2] == [(0, 12), (50, 80)]
    fam = tl.device_us_by_family(ev, t0, t1)
    assert fam == {"k1": 28, "k2": 20, "other": 12, "k1f32": 10}
    idle = tl.idle_by_host_op(ev, t0, t1)
    # (0,12) at 6: aten::mm; (50,80) at 65: aten::topk; (90,95) and
    # (97,120) at 92.5 and 108.5: the prefill, then no host op;
    # (130,200) at 165: the second prefill
    assert idle == {"aten::mm": 12, "aten::topk": 30,
                    "perfbench.prefill": 5 + 70, "(no host op)": 23}
    assert sum(idle.values()) == pytest.approx(200 - 60)
    (a, x), (b, y) = tl.top(idle, 2)
    assert (a, b) == ("perfbench.prefill", "aten::topk")
    assert (x, y) == (pytest.approx(75e-6), pytest.approx(30e-6))


def test_kernel_names_and_families():
    assert tl.kernel_name(
        "void (anonymous namespace)::matmul_tma_kernel<128, 2>(CUtensorMap)"
    ) == "matmul_tma_kernel"
    assert tl.family("void chunk_out_kernel<64>") == "k3"
    assert tl.family("ampere_sgemm_128x64_nn") is None
    assert not tl._device_activity("Context Sync")
    assert not tl._device_activity(tl.WINDOW_MARK)
    assert tl._device_activity("Memcpy DtoD (Device -> Device)")
