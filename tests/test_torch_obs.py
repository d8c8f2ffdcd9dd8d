"""The port's telemetry substrate (``repro_torch.obs``) against the JAX
package's ``repro.obs``: registry semantics, histogram buckets, the same
Prometheus text and snapshot from both registries for the same
operations, the same trace records from both tracers, and
instrumentation that changes no return value on the port's in-process
stack.  Carried over from ``tests/test_obs.py`` (less the HTTP exporter,
the service and the straggler monitor, which the port lacks).
"""
import json
import threading

import numpy as np
import pytest

from repro import obs as jobs
from repro_torch import obs as tobs
from repro_torch.configs.neurovec import NeuroVecConfig
from repro_torch.obs import (DEFAULT_LATENCY_BUCKETS, NULL_TRACER,
                             MetricsRegistry, Tracer, get_registry,
                             read_trace, resolve_obs, to_chrome_trace)
from repro_torch.obs.instrument import (instrument_oracle_stack,
                                        instrument_program_store,
                                        instrument_transport)


def small_cfg() -> NeuroVecConfig:
    return NeuroVecConfig(
        bm_choices=(16, 32), bn_choices=(128,), bk_choices=(128,),
        bq_choices=(64,), bkv_choices=(128,), chunk_choices=(32,),
        train_batch=32, sgd_minibatch=16, ppo_epochs=2)


def sites():
    from repro_torch.models.compute import KernelSite
    return [KernelSite(site="t.mm", kind="matmul", m=64, n=128, k=128),
            KernelSite(site="t.attn", kind="attention", m=64, n=32, k=64,
                       batch=2, causal=True)]


def _ops(mod):
    """One script of registry operations, run against either package."""
    r = mod.MetricsRegistry()
    r.counter("x_total", "things").inc(3)
    r.counter("t_total", labelnames=("session",)).labels(
        session='s"1').inc(2)
    g = r.gauge("q_depth", "queue")
    g.set(5)
    g.dec(1.5)
    h = r.histogram("lat_seconds", "latency")
    for v in (1e-7, 3e-4, 0.02, 2.0, 500.0):
        h.observe(v)
    hl = r.histogram("b_seconds", labelnames=("k",), buckets=(0.5, 1.0))
    hl.labels(k="a").observe(0.75)
    r.register_collector(lambda: r.gauge("synced").set(7))
    return r


def test_same_prometheus_text_and_snapshot_as_the_reference():
    port, ref = _ops(tobs), _ops(jobs)
    assert port.render_prom() == ref.render_prom()
    assert port.snapshot() == ref.snapshot()
    assert tuple(DEFAULT_LATENCY_BUCKETS) == \
        tuple(jobs.DEFAULT_LATENCY_BUCKETS)


def _trace_script(mod, path):
    tr = mod.Tracer(path)
    root = tr.begin("session", detached=True, kind="facade")
    with tr.span("fit", parent=root, n_sites=3):
        with tr.span("inner"):
            tr.event("ping", k=1)
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("kaput")
    root.end()
    tr.close()
    return mod.read_trace(path)


def test_same_trace_records_as_the_reference(tmp_path):
    """Both tracers write the same records (timestamps, durations and
    thread and process ids aside), and convert alike."""
    port = _trace_script(tobs, str(tmp_path / "p.jsonl"))
    ref = _trace_script(jobs, str(tmp_path / "r.jsonl"))
    clock = ("ts", "dur", "pid", "tid")

    def strip(recs):
        return [{k: v for k, v in r.items() if k not in clock} for r in recs]
    assert strip(port) == strip(ref)
    assert [set(r) for r in port] == [set(r) for r in ref]
    assert to_chrome_trace(port) == jobs.to_chrome_trace(port)


class TestRegistry:
    def test_counter_gauge_basics(self):
        r = MetricsRegistry()
        c = r.counter("x_total", "help text")
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5
        with pytest.raises(ValueError):
            c.inc(-1)
        g = r.gauge("depth")
        g.set(5)
        g.dec(2)
        assert g.value == 3.0

    def test_get_or_create_returns_same_family(self):
        r = MetricsRegistry()
        assert r.counter("a_total") is r.counter("a_total")
        with pytest.raises(ValueError):
            r.gauge("a_total")
        with pytest.raises(ValueError):
            r.counter("a_total", labelnames=("x",))
        with pytest.raises(ValueError):
            r.counter("9bad")

    def test_labels(self):
        r = MetricsRegistry()
        c = r.counter("t_total", labelnames=("session",))
        c.labels(session="s1").inc(2)
        assert r.snapshot()['t_total{session="s1"}'] == 2.0
        with pytest.raises(ValueError):
            c.labels(nope="x")
        with pytest.raises(ValueError):
            c.inc()

    def test_thread_safety(self):
        r = MetricsRegistry()
        c = r.counter("hits_total")
        h = r.histogram("lat_seconds", buckets=(0.5, 1.0))

        def work():
            for i in range(500):
                c.inc()
                h.observe(0.25 if i % 2 else 0.75)
        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert c.value == 4000
        assert h.value["buckets"]["0.5"] == 2000
        assert h.value["buckets"]["+Inf"] == 4000

    def test_collector_runs_before_snapshot(self):
        r = MetricsRegistry()
        g = r.gauge("synced")
        state = {"v": 1.0}
        fn = r.register_collector(lambda: g.set(state["v"]))
        assert r.snapshot()["synced"] == 1.0
        state["v"] = 7.0
        assert r.snapshot()["synced"] == 7.0
        r.unregister_collector(fn)
        state["v"] = 9.0
        assert r.snapshot()["synced"] == 7.0

    def test_histogram_buckets_and_wrong_verbs(self):
        r = MetricsRegistry()
        h = r.histogram("h_seconds", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.1, 0.5, 1.0, 5.0, 100.0):
            h.observe(v)
        v = h.value
        assert (v["buckets"]["0.1"], v["buckets"]["1.0"],
                v["buckets"]["10.0"], v["buckets"]["+Inf"]) == (2, 4, 5, 6)
        assert v["sum"] == pytest.approx(106.65)
        with pytest.raises(ValueError):
            r.histogram("bad", buckets=(1.0, 0.5))
        with pytest.raises(TypeError):
            r.counter("c_total").observe(1)
        with pytest.raises(TypeError):
            r.histogram("h2").inc()


class TestTrace:
    def test_span_nesting_errors_and_detached_root(self, tmp_path):
        p = str(tmp_path / "t.jsonl")
        tr = Tracer(p)
        root = tr.begin("session", detached=True)
        with tr.span("outer") as outer:
            assert outer.parent is None     # detached root not on the stack
            with tr.span("inner") as inner:
                assert inner.parent == outer.id
        with pytest.raises(RuntimeError):
            with tr.span("boom"):
                raise RuntimeError("kaput")
        with tr.span("child", parent=root) as sp:
            assert sp.parent == root.id
        root.end()
        tr.close()
        by = {r["name"]: r for r in read_trace(p)}
        assert by["boom"]["error"] == "RuntimeError: kaput"
        assert by["inner"]["dur"] <= by["outer"]["dur"]

    def test_chrome_trace_and_corrupt_lines(self, tmp_path):
        p = str(tmp_path / "t.jsonl")
        tr = Tracer(p)
        with tr.span("tune", n_sites=3):
            tr.event("straggler", z=4.2)
        tr.close()
        with open(p, "a") as f:
            f.write("{torn json\n\n[1,2,3]\n")
        evs = to_chrome_trace(p)["traceEvents"]
        x = [e for e in evs if e["ph"] == "X"][0]
        i = [e for e in evs if e["ph"] == "i"][0]
        assert x["args"]["n_sites"] == 3 and x["ts"] > 0
        assert i["args"]["parent_id"] == x["args"]["span_id"]
        json.dumps(evs)

    def test_null_tracer_and_resolve_obs(self, tmp_path):
        with NULL_TRACER.span("x") as sp:
            sp.set(a=1)
        assert NULL_TRACER.n_spans == 0
        r1, t1, own1 = resolve_obs(None, None)
        assert r1 is get_registry() and t1 is NULL_TRACER and not own1
        assert resolve_obs(False, None)[0] is not get_registry()
        p = str(tmp_path / "t.jsonl")
        _, t3, own3 = resolve_obs(MetricsRegistry(), p)
        assert own3 and t3.path == p
        t3.close()
        with pytest.raises(TypeError):
            resolve_obs(42, None)


class _SpyRunner:
    """Deterministic batched runner: value is a pure function of inputs."""

    backend_key = "spy:test"

    def __call__(self, sites_, tiles):
        return np.array([1e-3 * (i + 1) + 1e-5 * int(t[0])
                         for i, t in enumerate(np.asarray(tiles))],
                        np.float64)


class TestInstrumentationParity:
    def test_measured_env_returns_unchanged(self):
        from repro_torch.core.env import MeasuredEnv
        from repro_torch.measure.transport import (InProcessTransport,
                                                   TransportMeasureFn)
        cfg, ss = small_cfg(), sites()
        tiles = np.array([[16, 128, 128], [64, 128, 32]], np.int64)

        def run(instrumented):
            env = MeasuredEnv(cfg, measure_fn=TransportMeasureFn(
                InProcessTransport(_SpyRunner())), seed=0,
                legality="tpu_v5e")
            reg = MetricsRegistry()
            if instrumented:
                h = instrument_oracle_stack(env, reg, NULL_TRACER)
            out = env._measured_costs(ss, tiles)
            rb = env.rewards_batch(ss, np.zeros((2, 3), np.int64))
            if instrumented:
                snap = reg.snapshot()
                assert snap["env_measure_calls_total"] >= 1
                assert snap["env_measured_pairs_total"] >= 2
                assert snap["env_breaker_open"] == 0.0
                assert snap["env_measure_batch_seconds"]["count"] >= 1
                h.close()
            return out, rb

        (c0, r0), (c1, r1) = run(False), run(True)
        np.testing.assert_array_equal(c0, c1)
        np.testing.assert_array_equal(r0, r1)

    def test_transport_submit_drain_unchanged(self, tmp_path):
        from repro_torch.measure.db import MeasureDB
        from repro_torch.measure.transport import InProcessTransport
        ss = [sites()[0]] * 2
        tiles = np.array([[16, 128, 128]] * 2, np.int64)
        t_plain = InProcessTransport(_SpyRunner())
        t_obs = InProcessTransport(_SpyRunner(),
                                   MeasureDB(str(tmp_path / "m.jsonl")))
        reg = MetricsRegistry()
        h = instrument_transport(t_obs, reg, NULL_TRACER)
        v_plain = [f.result() for f in t_plain.submit(ss, tiles)]
        v_obs = [f.result() for f in t_obs.submit(ss, tiles)]
        t_obs.drain()
        assert v_plain == v_obs
        snap = reg.snapshot()
        assert snap["transport_misses_total"] == 1
        assert snap["transport_coalesced_total"] == 1
        assert snap["transport_submit_seconds"]["count"] == 1
        assert snap["transport_drain_seconds"]["count"] == 1
        assert snap["measuredb_puts_total"] == 1
        assert snap["measuredb_misses_total"] == 2
        assert instrument_transport(t_obs, MetricsRegistry()) is None
        h.close()
        t_obs.close()

    def test_program_store_instrumentation(self, tmp_path):
        from repro_torch.artifacts import ProgramStore
        from repro_torch.core.vectorizer import TileProgram
        store = ProgramStore(str(tmp_path / "p.jsonl"))
        reg = MetricsRegistry()
        h = instrument_program_store(store, reg)
        assert store.get("k1") is None
        store.put("k1", TileProgram({"s": (32, 32, 32)}))
        assert store.get("k1") is not None
        snap = reg.snapshot()
        assert snap["store_warm_hits_total"] == 1.0
        assert snap["store_misses_total"] == 1.0
        assert snap["store_programs_count"] == 1.0
        h.close()
        store.close()


class TestFacadeObs:
    def test_facade_trace_and_close_idempotent(self, tmp_path):
        from repro_torch.api import NeuroVectorizer
        p = str(tmp_path / "t.jsonl")
        nv = NeuroVectorizer(small_cfg(), agent="baseline",
                             metrics=MetricsRegistry(), trace=p,
                             device="cpu")
        nv.fit(sites())
        nv.tune_sites(sites())
        nv.close()
        nv.close()
        by_name = {}
        for r in read_trace(p):
            by_name.setdefault(r["name"], []).append(r)
        sess = by_name["session"][0]
        assert sess["attrs"] == {"kind": "facade", "agent": "baseline"}
        assert by_name["fit"][0]["parent"] == sess["id"]
        assert by_name["tune"][0]["parent"] == sess["id"]
        assert by_name["tune"][0]["attrs"]["store_hit"] is False
        assert len(by_name["session"]) == 1

    def test_facade_metrics_and_off_switch(self, tmp_path):
        from repro_torch.api import NeuroVectorizer
        reg = MetricsRegistry()
        nv = NeuroVectorizer(small_cfg(), agent="baseline", metrics=reg,
                             program_store=str(tmp_path / "p.jsonl"),
                             device="cpu")
        nv.fit(sites())
        nv.tune_sites(sites())
        nv.tune_sites(sites())
        snap = reg.snapshot()
        assert snap["facade_fit_seconds"]["count"] == 1
        assert snap["facade_tune_seconds"]["count"] == 2
        assert snap["store_warm_hits_total"] == 1.0
        assert snap["store_misses_total"] == 1.0
        nv.close()
        off = NeuroVectorizer(small_cfg(), agent="baseline", metrics=False,
                              device="cpu")
        assert len(off.fit(sites()).tune_sites(sites()).tiles) == 2
        off.close()
        assert off.registry is not get_registry()
