"""The program's ``nv.*`` spans in the benchmark's trace: the
``idle_python_ms`` reader on a synthetic timeline, nothing read from a
program without the spans or a trace without device activity, the other
readers unmoved by the spans' host ranges, the spans of a real CPU
profile coming out of ``timeline.from_profiler`` as host events, and
``perfbench.spans``: the launch mapping, device time by span and the
MoE's slots."""
import dataclasses
import json

import pytest

from perfbench import harness, spans, timeline, work
from perfbench.spec import spec_from_config
from perfbench.tests.conftest import REPO
from perfbench.timeline import Event

K1 = sorted(work.KERNELS["k1"])[0]
SPANS = [Event("nv.prefill", False, 1, 99), Event("nv.unstack", False, 2, 10),
         Event("nv.layer", False, 10, 90), Event("nv.site", False, 30, 40)]
BASE = [Event(timeline.WINDOW_MARK, False, 0, 100),
        Event("aten::unbind", False, 3, 5), Event("aten::mm", False, 31, 33),
        Event(K1, True, 8, 20), Event("elementwise_kernel", True, 36, 50),
        Event(K1, True, 60, 95)]


def record(events, prefills=2):
    spec = spec_from_config(json.loads(
        (REPO / "perfbench/configs/starcoder2_7b.json").read_text()))
    rec = harness.Record(spec=spec, batch=4, seq=512, setup_s=1.0,
                         window_s=1.0, latencies_s=[0.1])
    t0, t1, _ = timeline.window(events)
    rec.trace = harness.Trace(list(events), t0, t1, prefills)
    return rec


def reader(name):
    return harness.load_module(REPO / "perfbench" / "metrics"
                               / f"{name}.py").read


def test_idle_python_ms_sums_the_gaps_under_the_spans():
    """Gaps [0, 8] under ``aten::unbind``, [20, 36] and [50, 60] under
    ``nv.layer``, [95, 100] under ``nv.prefill``: 31 us of the port's
    Python over 2 prefills."""
    rec = record(BASE + SPANS)
    gaps = timeline.idle_by_host_op(rec.trace.events, 0, 100)
    assert gaps == {"aten::unbind": 8, "nv.layer": 26, "nv.prefill": 5}
    assert reader("idle_python_ms")(rec) == pytest.approx(0.031 / 2)


def test_idle_python_ms_reads_nothing_without_spans_or_device():
    assert reader("idle_python_ms")(record(BASE)) is None
    host = [e for e in BASE + SPANS if not e.device]
    assert reader("idle_python_ms")(record(host)) is None
    no_trace = record(BASE + SPANS)
    no_trace.trace = None
    assert reader("idle_python_ms")(no_trace) is None


@pytest.mark.parametrize("name", ["idle_share", "torch_ops_ms",
                                  "k1_roofline", "k2_roofline"])
def test_the_spans_move_no_other_reader(name):
    """The spans are host ranges: the device's busy time, its kernels'
    times and the window read the same with and without them."""
    assert reader(name)(record(BASE + SPANS)) == reader(name)(record(BASE))


def test_spans_leave_from_profiler_as_host_events():
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    cfg = dataclasses.replace(get_config("deepseek_v2_236b").reduced(),
                              n_layers=2)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    cache = model.make_cache(2, 20, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16))
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            torch.inference_mode():
        with torch.profiler.record_function(timeline.WINDOW_MARK):
            model.prefill(params, {"tokens": tokens}, cache)
    events = timeline.from_profiler(prof)
    ranges = [e for e in events if e.name.startswith("nv.")]
    assert {e.name for e in ranges} >= {
        "nv.prefill", "nv.layer", "nv.mla", "nv.moe", "nv.moe.route"}
    assert not any(e.device for e in ranges)
    t0, t1, n = timeline.window(events)
    root = [e for e in ranges if e.name == "nv.prefill"]
    assert n == 1 and len(root) == 1
    assert t0 <= root[0].start and root[0].end <= t1


class _Kineto:
    """A kineto event as ``prof.profiler.kineto_results.events()`` gives
    it, times in ns from the trace's start at 1000."""

    def __init__(self, name, kind, start, end, corr=0, linked=0,
                 annotation=False):
        self._v = (name, kind, start, end, corr, linked, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CPU" if self._v[1] != "kernel" else \
            "DeviceType.CUDA"

    def start_ns(self):
        return 1000 + self._v[2]

    def end_ns(self):
        return 1000 + self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


class _Prof:
    def __init__(self, events):
        res = type("R", (), {"trace_start_ns": lambda self: 1000,
                             "events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": res})()


def test_launched_pairs_device_events_with_their_launching_op():
    """Kernels link to the op or range that launched them; a runtime
    call's correlation id never stands in for an op's; annotations, sync
    records and events with no launch in the trace are left out."""
    evs = [_Kineto("nv.site", "cpu_op", 0, 9000, corr=7),
           _Kineto("aten::mm", "cpu_op", 2000, 3000, corr=8),
           _Kineto("cudaLaunchKernel", "cuda_runtime", 2500, 2600, corr=9),
           _Kineto("matmul_tma_kernel", "kernel", 10000, 12000, linked=7),
           _Kineto("nvjet_gemm", "kernel", 12000, 13000, linked=8),
           _Kineto("orphan_kernel", "kernel", 13000, 14000, linked=9),
           _Kineto("nv.site", "kernel", 10000, 13000, linked=7,
                   annotation=True),
           _Kineto("cudaDeviceSynchronize", "kernel", 13000, 14000,
                   linked=8)]
    got = spans.launched(_Prof(evs))
    assert got == [(Event("matmul_tma_kernel", True, 10.0, 12.0), 0.0),
                   (Event("nvjet_gemm", True, 12.0, 13.0), 2.0)]


def test_device_us_by_span_charges_the_innermost_span_at_launch():
    """Launched at 4 (under ``nv.unstack``), 35 (``nv.site``), 55
    (``nv.layer``), 95 (``nv.prefill``), 0.5 (no span); the last ends
    past the window and is clipped."""
    k = [(Event("a", True, 8, 20), 4.0), (Event("b", True, 36, 50), 35.0),
         (Event("c", True, 60, 70), 55.0), (Event("d", True, 95, 105), 95.0),
         (Event("e", True, 1, 2), 0.5)]
    got = spans.device_us_by_span(k, BASE + SPANS, 0, 100)
    assert got == {"nv.unstack": 12, "nv.site": 14, "nv.layer": 10,
                   "nv.prefill": 5, spans.NO_SPAN: 1}
    assert spans.device_us_by_span(k, BASE, 0, 100) == {spans.NO_SPAN: 42}


def test_moe_slots_are_experts_times_capacity_a_layer():
    """DeepSeek-V2 at 4 layers, 2048 tokens: C = 2048 * 6 * 1.25 / 160 =
    96 slots an expert, 160 experts a layer."""
    ds = spec_from_config(json.loads(
        (REPO / "perfbench/configs/deepseek_v2_236b_l4.json").read_text()))
    assert spans.moe_slots(ds, 2048) == 4 * 160 * 96
    assert spans.moe_slots(ds, 8) == 4 * 160 * 8    # at least 8
    assert spans.moe_slots(record([]).spec, 2048) == 0


def test_span_probe_reads_the_spans_and_the_counter_on_the_cpu(tiny_root):
    """``tools/span_probe.py`` on a tiny MoE cell: the extraction's
    seconds, the slots' use under the 80% a capacity of 1.25 allows, the
    spans of each traced prefill; no device reading on the CPU."""
    import argparse
    probe = harness.load_module(REPO / "tools" / "span_probe.py").probe
    out = probe(argparse.Namespace(workload="tiny_mla.tiny",
                                   seed=2 ** 31 + 17, prefills=2,
                                   root=tiny_root, device="cpu"))
    assert out["prefills"] == 2 and out["device"] == "cpu"
    assert out["sites_s"] > 0 and out["tune_s"] > 0
    assert 0 < out["moe_slot_use_pct"] <= 80.0
    assert out["idle_python_ms"] is None and out["moe_route_ms"] is None
    assert out["spans_a_prefill"] > 0 and out["window_ms"] > 0
