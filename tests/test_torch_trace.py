"""The port's spans and counter inside the model step and site extraction
(``repro_torch.obs.trace``): the off path does no work, an in-memory
tracer nests its records, a span mirrored into a CPU ``torch.profiler``
starts at the same time on both clocks, the span tree of a GQA and an MoE
prefill, logits bitwise alike with tracing on and off, and ``moe.kept``
against a direct count of the choices kept."""
import dataclasses
import threading
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.extractor import extract_serve_sites
from repro_torch.models import blocks, compute, moe
from repro_torch.models.lm import build_model
from repro_torch.models.site import KernelSite
from repro_torch.obs import NULL_TRACER, Tracer, to_chrome_trace, tracing
from repro_torch.obs import trace

B, S = 2, 16


def gqa_cfg():
    return dataclasses.replace(get_config("starcoder2_7b").reduced(),
                               n_layers=2, n_kv_heads=2)


def moe_cfg():
    return dataclasses.replace(get_config("deepseek_v2_236b").reduced(),
                               n_layers=2)


def _prefill(cfg, seed=0):
    """One prefill of a fresh model and cache: ``(logits, cache)``."""
    model = build_model(cfg)
    params = model.init(seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    cache = model.make_cache(B, S + 4, device="cpu")
    with torch.inference_mode():
        return model.prefill(params, {"tokens": tokens}, cache)


def _raise(*a, **k):
    raise AssertionError("the off path built a span")


@pytest.mark.parametrize("make", [gqa_cfg, moe_cfg])
def test_off_path_opens_no_range_and_keeps_nothing(make, monkeypatch):
    """With no tracer active and no profiler recording, no span, name,
    attribute, profiler range or site key is made."""
    assert trace.active() is NULL_TRACER
    monkeypatch.setattr(trace, "_profiler_range", _raise)
    monkeypatch.setattr(trace.NullTracer, "span", _raise)
    monkeypatch.setattr(trace.NullTracer, "count", _raise)
    monkeypatch.setattr(torch.autograd.profiler.record_function,
                        "__enter__", _raise)
    monkeypatch.setattr(compute, "_site_span", _raise)
    monkeypatch.setattr(blocks, "_mixer_span", _raise)
    monkeypatch.setattr(KernelSite, "key", _raise)
    logits, _ = _prefill(make())
    assert torch.isfinite(logits).all()


def test_in_memory_tracer_nests_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    t = Tracer()
    assert t.path is None and t.records() == []
    with tracing(t) as got:
        assert got is t and trace.active() is t
        with t.span("a", k=1) as a:
            with t.span("b") as b:
                t.event("e")
            with t.span("c"):
                pass

        def other():                    # another thread: its own stack
            with t.span("d"):
                pass
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
    assert trace.active() is NULL_TRACER
    by = {r["name"]: r for r in t.records()}
    assert by["a"]["parent"] is None and by["a"]["attrs"] == {"k": 1}
    assert by["b"]["parent"] == by["c"]["parent"] == a.id
    assert by["e"]["parent"] == b.id and by["e"]["type"] == "event"
    assert by["d"]["parent"] is None
    assert by["a"]["ts"] <= by["b"]["ts"] and by["b"]["dur"] <= by["a"]["dur"]
    assert t.n_spans == 4 and t.n_events == 1
    assert list(tmp_path.iterdir()) == []
    assert len(to_chrome_trace(t.records())["traceEvents"]) == 5


def test_tracing_restores_the_previous_tracer_on_error():
    outer, inner = Tracer(), Tracer()
    with tracing(outer):
        with pytest.raises(RuntimeError):
            with tracing(inner):
                raise RuntimeError("x")
        assert trace.active() is outer
    assert trace.active() is NULL_TRACER


def _tree(records):
    """Each span's name with its children's, in order of start."""
    kids = {}
    for r in sorted(records, key=lambda r: r["ts"]):
        kids.setdefault(r["parent"], []).append(r)

    def node(r):
        return (r["name"], [node(c) for c in kids.get(r["id"], [])])
    return [node(r) for r in kids[None]]


def _layer(mixer, mixer_sites, mlp):
    return ("nv.layer", [(mixer, [("nv.site", [])] * mixer_sites), mlp])


def test_gqa_prefill_span_tree_and_bitwise_logits():
    cfg = gqa_cfg()
    off, _ = _prefill(cfg)
    t = Tracer()
    with tracing(t):
        on, _ = _prefill(cfg)
    assert torch.equal(off, on)
    mlp = ("nv.mlp", [("nv.site", [])] * 2)
    layer = _layer("nv.attn", 5, mlp)      # q, k, v, the core, o
    assert _tree(t.records()) == [("nv.prefill", [
        ("nv.unstack", []), layer, layer, ("nv.site", [])])]
    recs = t.records()
    assert [r["attrs"]["index"] for r in recs if r["name"] == "nv.layer"] \
        == [0, 1]
    root = [r for r in recs if r["name"] == "nv.prefill"][0]
    assert root["attrs"] == {"batch": B, "tokens": B * S}
    sites = [r["attrs"] for r in recs if r["name"] == "nv.site"]
    assert {a["path"] for a in sites} == {"eager"}
    assert "attention:attn.core:" in {a["site"][:20] for a in sites}


def test_kernel_mode_site_spans_name_the_tile():
    """Under a program (the kernels' plain versions on the CPU) each
    ``nv.site`` names its path and the tile it took."""
    cfg = gqa_cfg()
    with compute.compute_mode("eager"):
        off, _ = _prefill(cfg)
    t = Tracer()
    with tracing(t), compute.compute_mode("kernel", tiles={}):
        on, _ = _prefill(cfg)
    sites = [r["attrs"] for r in t.records() if r["name"] == "nv.site"]
    assert {a["path"] for a in sites} == {"kernel"}
    assert {a["tile"] for a in sites} == {None}     # the baseline's
    assert on.shape == off.shape and torch.isfinite(on).all()


def test_moe_prefill_span_tree_bitwise_logits_and_counter():
    cfg = moe_cfg()
    off, _ = _prefill(cfg)
    t = Tracer()
    with tracing(t):
        on, _ = _prefill(cfg)
    assert torch.equal(off, on)
    moe_span = ("nv.moe", [
        ("nv.site", []), ("nv.moe.route", []), ("nv.moe.dispatch", []),
        ("nv.moe.combine", []), ("nv.moe.shared", [("nv.site", [])] * 3)])
    mla_sites = Counter(r["parent"] for r in t.records()
                        if r["name"] == "nv.site")
    n_mla = max(mla_sites.values())      # the MLA block's own sites
    layer = _layer("nv.mla", n_mla, moe_span)
    assert _tree(t.records()) == [("nv.prefill", [
        ("nv.unstack", []), layer, layer, ("nv.site", [])])]
    # every choice kept at this capacity: T * K a layer
    assert t.counters() == {"moe.kept": 2 * B * S * cfg.moe_top_k}


def test_moe_kept_equals_a_direct_count_of_keep_tk():
    """Routing skewed onto two experts overflows their capacity: the
    counter holds the choices ``route`` keeps, summed over calls."""
    cfg = moe_cfg()
    d, E = cfg.d_model, cfg.n_experts
    p = moe.moe_init(cfg, None, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(3)
    p = {k: torch.randn(v.shape, generator=gen) * 0.1 for k, v in p.items()}
    p["router"] = torch.zeros(d, E)
    p["router"][:, :2] = 1.0
    x = torch.rand(2, 32, d, generator=gen) + 0.5
    keep = moe.route(cfg, x.reshape(-1, d) @ p["router"])[2]
    kept = int(keep.sum())
    assert 0 < kept < keep.numel()          # some choices dropped
    t = Tracer()
    with tracing(t):
        moe.apply_moe(cfg, p, x)
        with torch.inference_mode():
            moe.apply_moe(cfg, p, x)
        moe.apply_moe(cfg, {k: v.to("meta") for k, v in p.items()},
                      x.to("meta"))         # counts nothing
    assert t.counters() == {"moe.kept": 2 * kept}
    assert NULL_TRACER.counters() == {}


def _cpu_profile(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def test_spans_mirror_into_the_profiler_on_one_clock():
    """Under a CPU profiler every span of a prefill is also a profiler
    range of its name, a plain function range (not a user annotation),
    starting within 1 ms of the tracer's record on the wall clock."""
    cfg = moe_cfg()
    t = Tracer()

    def run():
        with tracing(t):
            _prefill(cfg)
    prof = _cpu_profile(run)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    evs = sorted((e for e in prof.events() if e.name.startswith("nv.")),
                 key=lambda e: e.time_range.start)
    recs = sorted(t.records(), key=lambda r: r["ts"])
    assert [e.name for e in evs] == [r["name"] for r in recs]
    assert not any(e.is_user_annotation for e in evs)
    for e, r in zip(evs, recs):
        assert abs(start_ns + e.time_range.start * 1e3 - r["ts"] * 1e9) \
            < 1e6, r["name"]


def test_a_prefill_under_a_profiler_alone_puts_its_spans_there():
    """No tracer active: the profiler gets the prefill's spans, no
    record is kept, and the prefill after the profiler opens none."""
    cfg = gqa_cfg()
    assert trace.for_step() is NULL_TRACER
    holder = {}

    def run():
        holder["step"] = trace.for_step()
        holder["logits"] = _prefill(cfg)[0]
    prof = _cpu_profile(run)
    assert holder["step"].enabled and holder["step"].records() == []
    names = Counter(e.name for e in prof.events() if e.name.startswith("nv."))
    assert names == {"nv.prefill": 1, "nv.unstack": 1, "nv.layer": 2,
                     "nv.attn": 2, "nv.mlp": 2, "nv.site": 15}
    assert trace.for_step() is NULL_TRACER and trace.active() is NULL_TRACER
    assert torch.equal(holder["logits"], _prefill(cfg)[0])


def test_extraction_spans_and_the_same_sites():
    model = build_model(moe_cfg())
    plain = extract_serve_sites(model, B, S, 4)
    t = Tracer()
    with tracing(t):
        traced = extract_serve_sites(model, B, S, 4)
    assert [s.key() for s in traced] == [s.key() for s in plain]
    tree = dict(_tree(t.records()))
    assert [c[0] for c in tree["nv.extract"]] == [
        "nv.extract.init", "nv.extract.prefill", "nv.extract.decode"]
    assert t.counters() == {}               # meta tensors count nothing
