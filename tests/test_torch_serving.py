"""The port's serving path (``repro_torch.serving``) on the CPU: the cases
of ``tests/test_serving.py`` run against the port with ``device="cpu"``,
the same ``small_cfg()`` and sites, and what only the port has.

* The port's ``FusedTuner`` picks bitwise what ``repro.serving.FusedTuner``
  picks under ``legality="tpu_v5e"``, over the test sites and over the
  ten-arch corpus, and what the port's host brute force picks under
  ``"h100"`` and ``"cpu"`` (the launch rule in integer tensor arithmetic).
* The surrogate route, on a reference-trained model carried into the
  port, gives ``SurrogateOracle``'s brute labels.
* A site with no legal tile (an f32 attention site under ``"h100"``)
  fails its own request with ``ValueError``, in the fused and in the agent
  route; the rest of the batch resolves.
* ``Server.stats()`` and ``TuningService.stats()`` have the reference's
  keys, with its values on a deterministic script, and ``MetricsServer``
  serves the reference exporter's text for the same registry contents.
"""
import dataclasses
import threading
import time
import urllib.request

import numpy as np
import pytest

from repro_torch.configs.neurovec import DEFAULT, NeuroVecConfig
from repro_torch.core import dataset
from repro_torch.core.agents import AGENT_NAMES, make_agent
from repro_torch.core.agents.brute import brute_force_labels
from repro_torch.core.agents.ppo import MODES, PPOAgent
from repro_torch.core.env import ActionSpace, CostModelEnv
from repro_torch.models.site import KernelSite
from repro_torch.serving import (AgentBatch, DeadlineExceeded, FusedTuner,
                                 QueueFull, Server, ServingConfig,
                                 ServingError, bucket_size)
from repro_torch.service import TuningService

CPU = {"device": "cpu"}


def small_cfg() -> NeuroVecConfig:
    return NeuroVecConfig(
        bm_choices=(16, 32), bn_choices=(128,), bk_choices=(128,),
        bq_choices=(32, 64), bkv_choices=(128,), chunk_choices=(16, 32),
        train_batch=32, sgd_minibatch=16, ppo_epochs=2)


CFG = small_cfg()

SITES = [
    KernelSite(site="sv.mm0", kind="matmul", m=64, n=128, k=128),
    KernelSite(site="sv.mm1", kind="matmul", m=96, n=256, k=128),
    KernelSite(site="sv.attn", kind="attention", m=64, n=32, k=64,
               batch=2, causal=True),
    KernelSite(site="sv.scan", kind="chunk_scan", m=32, n=16, k=8,
               batch=2),
]
# K2 takes bf16 only: under legality="h100" this site has no legal tile
F32_ATTN = KernelSite(site="sv.attn32", kind="attention", m=64, n=32, k=64,
                      batch=2, causal=True, dtype="float32")
LEGALITIES = ("h100", "cpu", "tpu_v5e")


def _sites(tag: str, n: int = 3):
    """Distinct per-session site lists so cross-request mixing in the
    batcher would change results."""
    return [KernelSite(site=f"{tag}.mm{i}", kind="matmul",
                       m=32 * (i + 1), n=128, k=128) for i in range(n)]


def _jsites(sites):
    from repro.models.compute import KernelSite as JKernelSite
    return [JKernelSite(**dataclasses.asdict(s)) for s in sites]


def _jcfg(cfg):
    from repro.configs.neurovec import NeuroVecConfig as JNeuroVecConfig
    return JNeuroVecConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def corpus():
    """The ten-arch corpus (``dataset.arch_sites()``, the reference's key
    for key)."""
    return dataset.arch_sites()


# ---------------------------------------------------------------------------
# FusedTuner: one dispatch, argmin parity
# ---------------------------------------------------------------------------

class TestFusedTuner:
    @pytest.mark.parametrize("legality", LEGALITIES)
    def test_actions_match_brute_force_float64_reference(self, legality):
        """The float32 grid picks the float64 NumPy argmin, per site and
        per kind, under each legality."""
        env = CostModelEnv(CFG, seed=0, legality=legality)
        ref = brute_force_labels(env, SITES)
        fused = FusedTuner(CFG, legality=legality, **CPU).actions(SITES)
        np.testing.assert_array_equal(fused, np.asarray(ref))

    @pytest.mark.parametrize("legality", LEGALITIES)
    def test_tune_matches_inline_vectorizer_assembly(self, legality):
        env = CostModelEnv(CFG, seed=0, legality=legality)
        space = ActionSpace(CFG)
        ref = brute_force_labels(env, SITES)
        prog = FusedTuner(CFG, legality=legality, **CPU).tune(SITES)
        assert set(prog.tiles) == {s.key() for s in SITES}
        for s, a in zip(SITES, ref):
            assert prog.tiles[s.key()] == space.tiles(s.kind, a)

    def test_one_dispatch_and_bucketed_trace_reuse(self):
        """tune() is one dispatch; batch sizes inside one power-of-two
        bucket reuse the bucket's pipeline (on the CPU: no new bucket)."""
        t = FusedTuner(CFG, **CPU)
        t.tune(SITES[:3])
        assert t.dispatch_count == 1 and t.trace_count == 1
        t.tune(SITES)                         # 4 sites: same bucket of 8
        assert t.dispatch_count == 2 and t.trace_count == 1
        t.actions(SITES[:2])
        assert t.dispatch_count == 3 and t.trace_count == 1
        assert t.last_padded_batch == bucket_size(2)
        st = t.stats()
        assert st["serving_fused_dispatches_total"] == 3
        assert st["serving_fused_traces_total"] == 1
        assert st["serving_fused_sites_total"] == 9
        t.actions(_sites("big", 9))           # a new bucket of 16
        assert t.trace_count == 2 and t.last_padded_batch == 16

    def test_tune_many_slices_bitwise_equal_to_solo_tunes(self):
        t = FusedTuner(CFG, **CPU)
        a, b = SITES[:2], SITES[2:]
        many = t.tune_many([a, b, []])
        assert many[0].tiles == FusedTuner(CFG, **CPU).tune(a).tiles
        assert many[1].tiles == FusedTuner(CFG, **CPU).tune(b).tiles
        assert many[2].tiles == {}
        assert t.dispatch_count == 1          # the pair was one dispatch

    def test_fused_surrogate_matches_surrogate_oracle_argmin(self, tmp_path):
        from repro_torch.measure.db import MeasureDB, make_key
        from repro_torch.surrogate import SurrogateOracle, train_from_db

        db = MeasureDB(str(tmp_path / "m.jsonl"))
        for s in SITES:
            if s.kind != "matmul":
                continue
            for t0 in (16, 32):
                db.put(make_key(s.key(), (t0, 128, 128), "fix"),
                       1e-3 * (1 + t0) * (1 + s.m / 64))
        db.put(make_key(SITES[2].key(), (64, 128, 1), "fix"), 2e-3)
        db.put(make_key(SITES[3].key(), (32, 1, 1), "fix"), 3e-3)
        db.close()
        model = train_from_db(str(tmp_path / "m.jsonl"), min_pairs=4,
                              hidden=(16,), ensemble=2, steps=40, **CPU)
        assert model is not None
        for legality in LEGALITIES:
            oracle = SurrogateOracle(CFG, model, seed=0, legality=legality)
            ref = brute_force_labels(oracle, SITES)
            fused = FusedTuner(CFG, surrogate=model, legality=legality,
                               **CPU).actions(SITES)
            np.testing.assert_array_equal(fused, np.asarray(ref))


# ---------------------------------------------------------------------------
# against the JAX package and over the ten-arch corpus
# ---------------------------------------------------------------------------

def test_fused_actions_equal_the_references_fused_tuner_on_sites():
    from repro.serving import FusedTuner as JFusedTuner
    want = JFusedTuner(_jcfg(CFG)).actions(_jsites(SITES))
    got = FusedTuner(CFG, legality="tpu_v5e", **CPU).actions(SITES)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_fused_actions_equal_the_references_fused_tuner_on_the_corpus(
        corpus):
    from repro.configs.neurovec import DEFAULT as JDEFAULT
    from repro.serving import FusedTuner as JFusedTuner
    want = JFusedTuner(JDEFAULT).actions(_jsites(corpus))
    got = FusedTuner(DEFAULT, legality="tpu_v5e", **CPU).actions(corpus)
    assert len(corpus) == 105
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("legality", LEGALITIES)
def test_fused_grid_equals_the_host_grid_on_the_corpus(corpus, legality):
    """Every corpus site has a legal tile under each rule, and the fused
    argmin is the host brute force's, bitwise."""
    env = CostModelEnv(DEFAULT, legality=legality)
    assert np.isfinite(env.cost_grid(corpus)).any(1).all()
    got = FusedTuner(DEFAULT, legality=legality, **CPU).actions(corpus)
    np.testing.assert_array_equal(got, brute_force_labels(env, corpus))


def test_fused_surrogate_route_from_a_reference_trained_model(tmp_path):
    """A surrogate the reference trained, carried into the port, gives in
    the fused route the port's SurrogateOracle's brute labels."""
    from repro.measure.db import MeasureDB as JMeasureDB
    from repro.measure.db import make_key as jmake_key
    from repro.surrogate import train_from_db as jtrain_from_db
    from repro_torch import convert
    from repro_torch.surrogate import SurrogateOracle
    sites = dataset.generate(40, seed=4)
    env = CostModelEnv(DEFAULT, legality="h100")
    sites = [s for s in sites if np.isfinite(env.cost_grid([s])).any()]
    db = JMeasureDB(str(tmp_path / "m.jsonl"))
    rng = np.random.default_rng(0)
    space = ActionSpace(DEFAULT)
    for s in sites[:20]:
        for a in rng.integers(0, 3, (6, 3)):
            t = space.tiles(s.kind, a)
            db.put(jmake_key(s.key(), t, "fix"), float(rng.uniform(1e-4,
                                                                    1e-2)))
    db.close()
    jmodel = jtrain_from_db(str(tmp_path / "m.jsonl"), min_pairs=8,
                            hidden=(16, 16), ensemble=2, steps=60)
    model = convert.surrogate_from_jax(jmodel.state_dict(), **CPU)
    for legality in ("h100", "tpu_v5e"):
        oracle = SurrogateOracle(DEFAULT, model, legality=legality)
        want = brute_force_labels(oracle, sites)
        got = FusedTuner(DEFAULT, surrogate=model, legality=legality,
                         **CPU).actions(sites)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# a site with no legal tile fails its own request
# ---------------------------------------------------------------------------

def test_fused_tune_raises_for_a_site_with_no_legal_tile():
    t = FusedTuner(CFG, legality="h100", **CPU)
    with pytest.raises(ValueError, match="no legal action for site"):
        t.tune([SITES[0], F32_ATTN])
    out = t.tune_each([SITES[:2], [F32_ATTN], SITES[2:]])
    assert isinstance(out[1], ValueError)
    assert out[0].tiles == FusedTuner(CFG, **CPU).tune(SITES[:2]).tiles
    assert out[2].tiles == FusedTuner(CFG, **CPU).tune(SITES[2:]).tiles
    # the CPU route's rule has no dtype clause: the site is legal there
    assert FusedTuner(CFG, legality="cpu", **CPU).tune([F32_ATTN]).tiles


@pytest.mark.parametrize("agent", ["brute", "ppo"])
def test_no_legal_tile_fails_alone_in_the_fused_and_agent_routes(agent):
    """brute over the cost model takes the fused route, PPO the agent
    route: in each, the request holding the f32 attention site fails with
    ValueError and the others of its batch resolve."""
    with TuningService(CFG, serving={"max_wait_ms": 50.0}, metrics=False,
                       **CPU) as svc:
        s = svc.open_session(agent=agent, oracle="model")
        kw = {"total_steps": 48} if agent == "ppo" else {}
        s.fit(SITES, **kw)
        futs = [s.tune_async(SITES[:2]), s.tune_async([F32_ATTN] + SITES),
                s.tune_async(SITES[2:])]
        assert futs[0].result(timeout=120).tiles
        with pytest.raises(ValueError, match="no legal action"):
            futs[1].result(timeout=120)
        assert futs[2].result(timeout=120).tiles
        st = svc.server.stats()
    assert st["serving_batches_total"] == 1
    if agent == "brute":
        assert st["serving_fused_dispatches_total"] == 1
    else:
        assert st["serving_agent_batches_total"] == 1


# ---------------------------------------------------------------------------
# AgentBatch: spy-asserted bitwise parity for every registry agent
# ---------------------------------------------------------------------------

def _fitted(name: str, **kw):
    agent = make_agent(name, CFG, seed=0, **CPU, **kw)
    env = CostModelEnv(CFG, seed=0)
    fit_kw = {"total_steps": 48} if name == "ppo" else {}
    agent.fit(SITES, env, **fit_kw)
    return agent


def _spy_batch(agent, a, b, oracles=None):
    calls = []
    orig_act = agent.act
    agent.act = lambda *args, **kw: (calls.append("act"),
                                     orig_act(*args, **kw))[1]
    if hasattr(agent, "act_bucketed"):
        orig_bucketed = agent.act_bucketed
        agent.act_bucketed = lambda *args, **kw: (
            calls.append("bucketed"), orig_bucketed(*args, **kw))[1]
    batch = AgentBatch(agent)
    return batch, batch.act_many([a, b], oracles), calls


@pytest.mark.parametrize("name", AGENT_NAMES)
def test_batched_act_bitwise_equals_sequential_act(name):
    """Concatenate two requests through one AgentBatch forward: each
    request's actions are bitwise what a solo act() returns, and a spy
    proves the batched path ran one forward (batch-unsafe agents run one
    per request by design)."""
    agent = _fitted(name)
    a, b = SITES[:2], SITES[2:]
    expect = [np.asarray(agent.act(a, sample=False)),
              np.asarray(agent.act(b, sample=False))]
    batch, got, calls = _spy_batch(agent, a, b)
    np.testing.assert_array_equal(got[0], expect[0])
    np.testing.assert_array_equal(got[1], expect[1])
    if batch.coalesced:
        assert len(calls) == 1               # one forward for the batch
        if name == "ppo":
            assert calls == ["bucketed"]     # padded-bucket reuse
    else:
        assert calls == ["act", "act"]       # per-request by design
    assert batch.requests == 2 and batch.sites == len(SITES)


@pytest.mark.parametrize("name", AGENT_NAMES)
def test_batched_act_with_legal_masks_equals_solo_tune(name):
    """With each request's oracle, the batch passes the legal masks: each
    request's actions are what ``vectorizer.tune`` picks for it alone."""
    from repro_torch.core.vectorizer import mask_env
    agent = _fitted(name)
    env = CostModelEnv(CFG, seed=0)
    a, b = SITES[:2], SITES[2:]
    expect = [np.asarray(agent.act(r, sample=False,
                                   legal=np.isfinite(
                                       mask_env(env).cost_grid(r))))
              for r in (a, b)]
    _, got, _ = _spy_batch(agent, a, b, [env, env])
    np.testing.assert_array_equal(got[0], expect[0])
    np.testing.assert_array_equal(got[1], expect[1])


@pytest.mark.parametrize("mode", MODES)
def test_batched_ppo_modes_equal_sequential(mode):
    agent = PPOAgent(CFG, mode=mode, **CPU)
    agent.fit(SITES, CostModelEnv(CFG, seed=0), total_steps=48)
    a, b = SITES[:2], SITES[2:]
    env = CostModelEnv(CFG, legality="h100")
    for oracles in (None, [env, env]):
        kw = [{} if oracles is None else
              {"legal": np.isfinite(env.cost_grid(r))} for r in (a, b)]
        expect = [agent.act(a, **kw[0]), agent.act(b, **kw[1])]
        _, got, calls = _spy_batch(agent, a, b, oracles)
        np.testing.assert_array_equal(got[0], expect[0])
        np.testing.assert_array_equal(got[1], expect[1])
        assert calls == ["bucketed"]
        del agent.act, agent.act_bucketed    # drop the spies


@pytest.mark.parametrize("mode", MODES)
def test_ppo_act_bucketed_padding_is_bitwise_invisible(mode):
    agent = PPOAgent(CFG, mode=mode, **CPU)
    agent.fit(SITES, CostModelEnv(CFG, seed=0), total_steps=48)
    plain = np.asarray(agent.act(SITES, sample=False))
    padded = agent.act_bucketed(SITES, bucket=16)
    np.testing.assert_array_equal(plain, padded)


# ---------------------------------------------------------------------------
# Server: admission, batching, typed errors, health
# ---------------------------------------------------------------------------

def test_concurrent_sessions_one_fused_dispatch_and_isolation():
    """Concurrent model-oracle tunes coalesce into one batch = one fused
    dispatch; each session gets exactly its own program."""
    lists = [_sites(f"c{i}", n=2 + i % 2) for i in range(4)]
    with TuningService(CFG, serving={"max_wait_ms": 50.0},
                       metrics=False, **CPU) as svc:
        sessions = [svc.open_session(agent="brute", oracle="model")
                    for _ in lists]
        for s, ss in zip(sessions, lists):
            s.fit(ss)
        futs = [s.tune_async(ss) for s, ss in zip(sessions, lists)]
        progs = [f.result(timeout=120) for f in futs]
        st = svc.server.stats()
    env = CostModelEnv(CFG, seed=0)
    space = ActionSpace(CFG)
    for ss, prog in zip(lists, progs):
        assert set(prog.tiles) == {x.key() for x in ss}
        for x, a in zip(ss, brute_force_labels(env, ss)):
            assert prog.tiles[x.key()] == space.tiles(x.kind, a)
    assert st["serving_requests_total"] == 4
    assert st["serving_batches_total"] == 1
    assert st["serving_fused_dispatches_total"] == 1
    assert st["serving_fused_traces_total"] == 1


def test_fifo_resolution_within_an_slo_class():
    """Requests sharing one SLO class resolve strictly in admission
    order within the flushed batch."""
    order = []
    with TuningService(CFG, serving={"max_wait_ms": 30.0},
                       metrics=False, **CPU) as svc:
        sessions = [svc.open_session(agent="brute", oracle="model")
                    for _ in range(4)]
        lists = [_sites(f"f{i}") for i in range(4)]
        for s, ss in zip(sessions, lists):
            s.fit(ss)
        futs = []
        for i, (s, ss) in enumerate(zip(sessions, lists)):
            f = s.tune_async(ss)
            f.add_done_callback(lambda _f, i=i: order.append(i))
            futs.append(f)
        for f in futs:
            f.result(timeout=120)
    assert order == [0, 1, 2, 3]


def test_queue_full_sheds_with_typed_error_and_degrades_health():
    with TuningService(CFG, serving={"max_queue": 1, "max_wait_ms": 150.0,
                                     "slo_ms": 10_000.0},
                       metrics=False, **CPU) as svc:
        s = svc.open_session(agent="brute", oracle="model")
        s.fit(SITES[:1])
        assert svc.server.health() == "ok"
        f1 = s.tune_async(SITES[:1])
        with pytest.raises(QueueFull, match="max_queue"):
            s.tune_async(SITES[:1])
        assert svc.server.health() == "degraded"     # breach in window
        assert svc.health() == "degraded"            # service agrees
        assert f1.result(timeout=120) is not None    # queued one survives
        assert svc.server.stats()["serving_shed_total"] == 1
    assert svc.server.health() == "down"             # closed


def test_expired_budget_fails_future_with_deadline_exceeded():
    with TuningService(CFG, serving=True, metrics=False, **CPU) as svc:
        s = svc.open_session(agent="brute", oracle="model")
        s.fit(SITES[:1])
        fut = s.tune_async(SITES[:1], slo_ms=1e-4)   # expired on arrival
        with pytest.raises(DeadlineExceeded, match="budget"):
            fut.result(timeout=120)
        st = svc.server.stats()
        assert st["serving_deadline_misses_total"] == 1
        assert svc.server.health() == "degraded"
        # the session survives its failed request, and close() drains
        # the dead future without re-raising
        assert s.tune(SITES[:1]).tiles


def test_health_recovers_after_breach_window():
    with TuningService(CFG, serving={"max_queue": 1, "max_wait_ms": 1.0,
                                     "health_window_s": 0.2},
                       metrics=False, **CPU) as svc:
        s = svc.open_session(agent="brute", oracle="model")
        s.fit(SITES[:1])
        f1 = s.tune_async(SITES[:1])
        try:
            s.tune_async(SITES[:1])
            shed = False
        except QueueFull:
            shed = True
        if shed:                      # breach is fresh: inside the window
            assert svc.server.health() == "degraded"
        f1.result(timeout=120)
        time.sleep(0.25)              # ...and expired once it passes
        assert svc.server.health() == "ok"


def test_submit_after_close_raises_and_slo_needs_serving():
    svc = TuningService(CFG, serving=True, metrics=False, **CPU)
    s = svc.open_session(agent="brute", oracle="model")
    svc.close()
    with pytest.raises(ServingError, match="closed"):
        svc.server.submit(s, SITES[:1])
    with TuningService(CFG, metrics=False, **CPU) as plain:
        p = plain.open_session(agent="brute", oracle="model")
        with pytest.raises(ValueError, match="serving"):
            p.tune_async(SITES[:1], slo_ms=5.0)


def test_empty_sites_resolve_immediately():
    with TuningService(CFG, serving=True, metrics=False, **CPU) as svc:
        s = svc.open_session(agent="brute", oracle="model")
        assert s.tune([]).tiles == {}
        assert svc.server.stats()["serving_batches_total"] == 0


def test_warm_store_tier_answers_at_admission(tmp_path):
    with TuningService(CFG, serving=True, metrics=False,
                       program_store=str(tmp_path / "p.jsonl"),
                       **CPU) as svc:
        s = svc.open_session(agent="brute", oracle="model")
        s.fit(SITES[:2])
        p1 = s.tune(SITES[:2])               # miss: through the batcher
        p2 = s.tune(SITES[:2])               # hit: resolved at admission
        assert p2.tiles == p1.tiles
        st = svc.server.stats()
        assert st["serving_store_hits_total"] == 1
        assert st["serving_batches_total"] == 1      # hit never queued
        sst = s.stats()
        assert sst["session_store_hits_total"] == 1
        assert sst["session_store_misses_total"] == 1


def test_mixed_agent_routes_interleaved_under_load():
    """Fused (brute/model) and coalesced-forward (ppo) sessions submit
    concurrently from threads: every result is isolated per session and
    bitwise equal to that session's own unbatched decision."""
    with TuningService(CFG, serving={"max_wait_ms": 30.0},
                       metrics=False, **CPU) as svc:
        brutes = [(svc.open_session(agent="brute", oracle="model"),
                   _sites(f"mb{i}")) for i in range(2)]
        ppos = [(svc.open_session(agent="ppo", oracle="model"),
                 _sites(f"mp{i}")) for i in range(2)]
        for s, ss in brutes + ppos:
            kw = {"total_steps": 48} if s.agent.name == "ppo" else {}
            s.fit(ss, **kw)
        space = ActionSpace(CFG)
        expect = {}
        for s, ss in brutes + ppos:
            acts = np.asarray(s.agent.act(ss, sample=False))
            expect[s.name] = {x.key(): space.tiles(x.kind, a)
                              for x, a in zip(ss, acts)}

        results, errors = {}, []

        def worker(sess, ss):
            try:
                results[sess.name] = sess.tune(ss)
            except Exception as e:           # pragma: no cover - surfaced
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(s, ss))
                   for s, ss in brutes + ppos]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        st = svc.server.stats()
    assert not errors
    for s, _ in brutes + ppos:
        assert results[s.name].tiles == expect[s.name]
    assert st["serving_requests_total"] == 4
    assert st["serving_fused_dispatches_total"] >= 1
    assert st["serving_batched_requests_total"] >= 1


def test_serving_config_spellings_and_stats_keys():
    with TuningService(CFG, serving=ServingConfig(slo_ms=250.0),
                       metrics=False, **CPU) as svc:
        assert isinstance(svc.server, Server)
        assert svc.server.cfg.slo_ms == 250.0
        s = svc.open_session(agent="brute", oracle="model")
        s.fit(SITES[:1]).tune(SITES[:1])
        st = svc.server.stats()
        for k in ("serving_requests_total", "serving_queue_depth",
                  "serving_shed_total", "serving_deadline_misses_total",
                  "serving_batches_total", "serving_store_hits_total",
                  "serving_queue_wait_seconds_total",
                  "serving_batch_requests_hist", "serving_tune_p50_ms",
                  "serving_tune_p99_ms", "serving_fused_dispatches_total",
                  "health"):
            assert k in st, k
        assert st["serving_tune_p99_ms"] >= st["serving_tune_p50_ms"] >= 0
        assert "serving" in svc.stats()
    assert svc.stats()["serving"]["health"] == "down"


def test_instrument_serving_lands_series_in_registry():
    from repro_torch.obs import MetricsRegistry
    reg = MetricsRegistry()
    with TuningService(CFG, serving=True, metrics=reg, **CPU) as svc:
        s = svc.open_session(agent="brute", oracle="model")
        s.fit(SITES[:2]).tune(SITES[:2])
        snap = reg.snapshot()
    assert snap["serving_requests_total"] == 1.0
    assert snap["serving_batches_total"] == 1.0
    assert snap["serving_fused_dispatches_total"] == 1.0
    assert snap["serving_tune_seconds"]["count"] == 1
    assert snap["serving_queue_wait_seconds"]["count"] == 1
    assert snap["serving_batch_requests"]["count"] == 1


# ---------------------------------------------------------------------------
# the reference's stats() shape and exporter text
# ---------------------------------------------------------------------------

_TIMING_KEYS = {"serving_queue_wait_seconds_total", "serving_tune_p50_ms",
                "serving_tune_p99_ms"}


def _stats_script(TuningServiceCls, cfg, lists, **kw):
    """Four brute/model sessions and one baseline session, each tuning
    its list twice, one request at a time."""
    with TuningServiceCls(cfg, serving={"max_wait_ms": 1.0},
                          metrics=False, **kw) as svc:
        sessions = [svc.open_session(agent="brute", oracle="model")
                    for _ in lists]
        sessions.append(svc.open_session(agent="baseline", oracle="model"))
        for s, ss in zip(sessions, lists + [lists[0]]):
            s.fit(ss)
            s.tune(ss)
            s.tune(ss)
        server = svc.server.stats()
        service = svc.stats()
    return server, service, svc.stats()


def test_stats_have_the_references_keys_and_values():
    from repro.service import TuningService as JTuningService
    lists = [_sites(f"st{i}", n=1 + i) for i in range(4)]
    got = _stats_script(TuningService, CFG, lists, **CPU)
    want = _stats_script(JTuningService, _jcfg(CFG),
                         [_jsites(ss) for ss in lists])
    for g, w in zip(got, want):       # server, service, service closed
        for gs, ws in ((g, w), (g.get("serving"), w.get("serving"))):
            if gs is None:
                continue
            assert set(gs) == set(ws)
            for k in set(gs) - _TIMING_KEYS - {"transport", "serving"}:
                assert gs[k] == ws[k], k
    assert got[0]["serving_requests_total"] == 10
    assert got[0]["serving_fused_dispatches_total"] == 8
    assert got[2]["serving"]["health"] == "down"


def _fill(reg):
    c = reg.counter("demo_requests_total", "requests",
                    labelnames=("session",))
    c.labels(session="a").inc(3)
    c.labels(session="b").inc()
    reg.gauge("demo_depth", "queue depth").set(7)
    h = reg.histogram("demo_seconds", "latency")
    for v in (1e-4, 3e-3, 0.2, 2.0):
        h.observe(v)


def _scrape(server_cls, registry):
    with server_cls(port=0, registry=registry) as srv:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=30) as r:
            return r.headers["Content-Type"], r.read().decode()


def test_metrics_server_serves_the_reference_exporters_text():
    from repro.obs import MetricsRegistry as JMetricsRegistry
    from repro.obs.exporter import MetricsServer as JMetricsServer
    from repro_torch.obs import MetricsRegistry, MetricsServer
    reg, jreg = MetricsRegistry(), JMetricsRegistry()
    _fill(reg)
    _fill(jreg)
    got, want = _scrape(MetricsServer, reg), _scrape(JMetricsServer, jreg)
    assert got == want
    assert "demo_seconds_count 4" in got[1]
    with MetricsServer(port=0, registry=reg) as srv:
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope",
                                   timeout=30)
