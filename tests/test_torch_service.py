"""The port's tuning service (``repro_torch.service``) on the CPU: the
cases of ``tests/test_service.py`` run against the port with
``device="cpu"`` (the in-process and pool transports; the pool's worker
factories are ``tests/test_torch_pool_helpers.py``), and what the port
adds.

* ``AsyncOracle`` gives the wrapped oracle's costs, grids, health and
  legality, and the service's sessions hold one.
* ``serve --serving`` on the CPU gives the same program as the same
  command without it and prints the serving line; ``--metrics-port``
  serves the registry; the serving flags fail with the reference's
  argparse messages.
* The two service examples run to their ``OK``.
"""
import importlib.util
import pathlib
import urllib.request

import numpy as np
import pytest

from repro_torch.api import (AsyncOracle, CostModelEnv, NeuroVecConfig,
                             NeuroVectorizer, Oracle, SessionHandle,
                             TileProgram, TuningService, WorkerPoolTransport)
from repro_torch.models.site import KernelSite
from repro_torch.service import open_session

from test_torch_pool_helpers import fake_value

ROOT = pathlib.Path(__file__).resolve().parents[1]
H = "test_torch_pool_helpers"
CPU = {"device": "cpu"}

SMALL = NeuroVecConfig(
    bm_choices=(16, 32), bn_choices=(128,), bk_choices=(128,),
    bq_choices=(64,), bkv_choices=(128,), chunk_choices=(32,))

MM = KernelSite(site="s.mm", kind="matmul", m=32, n=128, k=128)
ATTN = KernelSite(site="s.attn", kind="attention", m=64, n=32, k=64,
                  batch=2, causal=True)
SITES = [MM, ATTN]


def _fake_pool(**kw):
    return WorkerPoolTransport(workers=2, factory=f"{H}:deterministic",
                               **kw)


# ---------------------------------------------------------------------------
# pool-service parity with the in-process path
# ---------------------------------------------------------------------------

def test_service_pool_parity_with_inproc_measured(tmp_path):
    """Real runners: the in-process measured facade fills the DB; the
    pool-backed service reproduces the same TileProgram with zero
    re-timings."""
    p = str(tmp_path / "m.jsonl")
    with NeuroVectorizer(SMALL, agent="brute", oracle="measured",
                         db_path=p, oracle_kwargs=dict(reps=1, warmup=1),
                         **CPU) as nv:
        prog_inproc = nv.fit(SITES).tune_sites(SITES)
        t = nv.oracle.measure_fn.transport
        assert t.stats()["transport_timed_pairs_total"] > 0

    with TuningService(SMALL, transport="pool", workers=2, db_path=p,
                       reps=1, warmup=1, **CPU) as svc:
        session = svc.open_session(agent="brute", oracle="measured")
        prog_pool = session.fit(SITES).tune(SITES)
        st = svc.transport.stats()
    assert prog_pool.tiles == prog_inproc.tiles
    assert st["transport_timed_pairs_total"] == 0 \
        and st["transport_misses_total"] == 0   # zero re-timings
    assert st["transport_hits_total"] > 0


def test_service_pool_parity_cold_fake_runners():
    """Deterministic fake runners: the pool service and the in-process
    facade agree with separate cold DBs (values derive from the key, so
    this checks the whole decision path, not the cache)."""
    from repro_torch.measure import InProcessTransport
    from test_torch_pool_helpers import FakeRunner

    with NeuroVectorizer(SMALL, agent="brute", oracle="measured",
                         transport=InProcessTransport(FakeRunner()),
                         **CPU) as nv:
        prog_inproc = nv.fit(SITES).tune_sites(SITES)
    with TuningService(SMALL, transport=_fake_pool(), **CPU) as svc:
        prog_pool = svc.open_session(
            agent="brute", oracle="measured").fit(SITES).tune(SITES)
    assert prog_pool.tiles == prog_inproc.tiles


def test_service_program_equals_the_references_on_fake_runners():
    """The reference's service over its in-process transport and the
    port's over its pool, each timing through the same deterministic
    runner, tune the same program under the reference's rule."""
    import dataclasses

    from repro.api import TuningService as JTuningService
    from repro.configs.neurovec import NeuroVecConfig as JNeuroVecConfig
    from repro.measure import InProcessTransport as JInProcessTransport
    from repro.models.compute import KernelSite as JKernelSite
    from test_torch_pool_helpers import FakeRunner
    jsites = [JKernelSite(**dataclasses.asdict(s)) for s in SITES]
    with JTuningService(JNeuroVecConfig(**dataclasses.asdict(SMALL)),
                        transport=JInProcessTransport(FakeRunner())) as svc:
        want = svc.open_session(agent="brute",
                                oracle="measured").fit(jsites).tune(jsites)
    with TuningService(SMALL, transport=_fake_pool(), legality="tpu_v5e",
                       **CPU) as svc:
        got = svc.open_session(agent="brute",
                               oracle="measured").fit(SITES).tune(SITES)
    assert got.tiles == want.tiles


# ---------------------------------------------------------------------------
# the session API
# ---------------------------------------------------------------------------

def test_tune_async_returns_program_future_and_tracks_stats():
    with TuningService(SMALL, transport=_fake_pool(), **CPU) as svc:
        s = svc.open_session(agent="brute", oracle="measured")
        assert isinstance(s, SessionHandle)
        assert isinstance(s.oracle, Oracle)
        assert isinstance(s.oracle, AsyncOracle)
        fut = s.fit(SITES).tune_async(SITES)
        prog = fut.result(timeout=120)
        assert isinstance(prog, TileProgram)
        assert set(prog.tiles) == {x.key() for x in SITES}
        st = s.stats()
        assert st["session_tunes_total"] == 1
        assert st["session_sites_tuned_total"] == 2
        assert st["session_inflight_tunes"] == 0
        assert st["transport"]["transport_timed_pairs_total"] > 0
        assert st["transport"]["transport_inflight_pairs"] == 0
        assert st["session_wall_seconds"] > 0 and st["agent"] == "brute"


def test_sessions_share_one_transport_and_its_cache(tmp_path):
    """Two sessions over one pool: the second session's identical sweep
    is served from the shared transport's DB; its stats window shows
    hits, not timings."""
    with TuningService(SMALL,
                       transport=_fake_pool(db=str(tmp_path / "m.jsonl")),
                       **CPU) as svc:
        s1 = svc.open_session(agent="brute", oracle="measured")
        p1 = s1.fit(SITES).tune(SITES)
        s2 = svc.open_session(agent="brute", oracle="measured")
        p2 = s2.fit(SITES).tune(SITES)
        assert p1.tiles == p2.tiles
        st2 = s2.stats()["transport"]            # deltas since s2 opened
        assert st2["transport_timed_pairs_total"] == 0
        assert svc.stats()["service_sessions_total"] == 2
    assert st2["transport_hits_total"] > 0


def test_session_model_oracle_needs_no_transport_traffic():
    with TuningService(SMALL, transport=_fake_pool(), **CPU) as svc:
        s = svc.open_session(agent="brute", oracle="model")
        prog = s.fit(SITES).tune(SITES)
        assert len(prog.tiles) == 2
        st = svc.transport.stats()
        assert st["transport_misses_total"] == 0      # untouched
        assert s.stats()["transport"]["transport_timed_pairs_total"] == 0


def test_service_validation_and_lifecycle():
    svc = TuningService(SMALL, **CPU)                 # default inproc
    with pytest.raises(ValueError, match="unknown oracle"):
        svc.open_session(oracle="wat")
    s = svc.open_session(agent="baseline", oracle="model")
    svc.close()
    svc.close()                                       # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        svc.open_session(agent="baseline")
    with pytest.raises(RuntimeError, match="closed"):
        s.tune(SITES)
    with pytest.raises(TypeError, match="pre-built transport"):
        TuningService(SMALL, transport=_fake_pool(), workers=4, **CPU)


def test_service_borrows_prebuilt_transport_without_closing_it():
    t = _fake_pool()
    with TuningService(SMALL, transport=t, **CPU) as svc:
        svc.open_session(agent="baseline", oracle="measured")
    # the service is closed; the borrowed transport still works
    futs = t.submit([MM], np.array([[16, 128, 128]]))
    t.drain()
    assert futs[0].result() == fake_value(MM.key(), (16, 128, 128))
    t.close()


def test_open_session_convenience_wraps_private_service():
    h = open_session(SMALL, agent="baseline", oracle="model", **CPU)
    prog = h.fit(SITES).tune(SITES)
    assert len(prog.tiles) == 2
    h.service.close()


def test_service_raises_without_cuda_unless_the_cpu_is_asked_for():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TuningService(SMALL)


def test_service_device_and_legality_reach_every_layer(tmp_path):
    """Agents, the in-process runner and the fused tuners run on the
    service's device; every oracle it builds prices under its
    legality."""
    with TuningService(SMALL, serving=True, legality="cpu",
                       db_path=str(tmp_path / "m.jsonl"), reps=1,
                       metrics=False, **CPU) as svc:
        assert svc.transport.runner.device.type == "cpu"
        for oracle in ("model", "measured"):
            s = svc.open_session(agent="ppo", oracle=oracle)
            assert s.agent._dev.type == "cpu"
            assert s.oracle.legality == "cpu"
            assert s.oracle.oracle.legality == "cpu"
        b = svc.open_session(agent="brute", oracle="model")
        b.fit(SITES).tune(SITES)
        (tuner,) = svc.server._tuners.values()
        assert tuner.device.type == "cpu" and tuner.legality == "cpu"
    with pytest.raises(ValueError, match="legality"):
        TuningService(SMALL, legality="tpu_v4", **CPU)


def test_session_tune_masks_with_the_oracles_legality():
    """Under legality="h100" a session's program only names tiles the
    kernels launch, and a site they refuse (f32 attention) raises."""
    from repro_torch.kernels import ops
    f32 = KernelSite(site="s.attn32", kind="attention", m=64, n=32, k=64,
                     batch=2, causal=True, dtype="float32")
    with TuningService(SMALL, metrics=False, **CPU) as svc:
        s = svc.open_session(agent="ppo", oracle="model")
        s.fit(SITES, total_steps=32)
        prog = s.tune(SITES)
        assert all(ops.tile_ok(x, prog.tiles[x.key()]) for x in SITES)
        with pytest.raises(ValueError, match="no legal action"):
            s.tune([f32])


# ---------------------------------------------------------------------------
# AsyncOracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("legality", ["h100", "cpu", "tpu_v5e"])
def test_async_oracle_gives_the_wrapped_oracles_numbers(legality):
    from repro_torch.core import dataset
    env = CostModelEnv(SMALL, legality=legality)
    ao = AsyncOracle(env)
    sites = dataset.generate(20, seed=1)
    acts = np.zeros((len(sites), 3), np.int64)
    assert ao.cfg is env.cfg and ao.space is env.space
    assert ao.legality == legality
    np.testing.assert_array_equal(ao.cost_grid(sites), env.cost_grid(sites))
    for fn in ("costs_batch", "rewards_batch", "speedups_batch"):
        np.testing.assert_array_equal(getattr(ao, fn)(sites, acts),
                                      getattr(env, fn)(sites, acts))
    np.testing.assert_array_equal(ao.baseline_costs(sites),
                                  env.baseline_costs(sites))
    tiles = np.ones((len(sites), 3), np.int64) * 32
    np.testing.assert_array_equal(ao.tiles_costs(sites, tiles),
                                  env.tiles_costs(sites, tiles))
    assert ao.health() == "ok"
    with pytest.raises(RuntimeError, match="no transport"):
        ao.submit_tiles(sites[:1], tiles[:1])
    ao.drain()
    ao.close()                        # nothing of its own to close


def test_async_oracle_over_a_transport_submits_and_reports_health():
    from repro_torch.core.env import MeasuredEnv
    from repro_torch.core.vectorizer import mask_env
    from repro_torch.measure import TransportMeasureFn
    t = _fake_pool()
    env = MeasuredEnv(SMALL, measure_fn=TransportMeasureFn(t))
    with AsyncOracle(env, t) as ao:
        futs = ao.submit_tiles([MM], np.array([[16, 128, 128]]))
        ao.drain()
        assert futs[0].result() == fake_value(MM.key(), (16, 128, 128))
        np.testing.assert_array_equal(ao.cost_grid(SITES),
                                      env.cost_grid(SITES))
        assert ao.health() == "ok"
        # the legal mask of a measured oracle is the cost model's under
        # its legality: it times nothing
        m = mask_env(ao)
        assert type(m) is CostModelEnv and m.legality == env.legality
    assert t.health() == "down"       # closed with the adapter


def test_program_key_unwraps_the_async_oracle():
    from repro_torch.api import make_agent, program_key
    env = CostModelEnv(SMALL, legality="cpu")
    agent = make_agent("baseline", SMALL, **CPU)
    assert program_key(SITES, agent, AsyncOracle(env)) == \
        program_key(SITES, agent, env)


# ---------------------------------------------------------------------------
# facade + serve wiring
# ---------------------------------------------------------------------------

def test_facade_transport_args_require_measured_oracle():
    with pytest.raises(ValueError, match="oracle='measured'"):
        NeuroVectorizer(SMALL, transport="pool", **CPU)
    with pytest.raises(ValueError, match="oracle='measured'"):
        NeuroVectorizer(SMALL, oracle="model", workers=2, **CPU)


def test_facade_close_is_safe_for_model_oracle():
    nv = NeuroVectorizer(SMALL, agent="baseline", **CPU)
    nv.close()                                        # no-op, must not raise
    with NeuroVectorizer(SMALL, agent="baseline", **CPU):
        pass


def test_serve_rejects_bad_measure_flags():
    from repro_torch.launch import serve

    base = ["--arch", "stablelm_3b", "--autotune", "brute", "--measured"]
    with pytest.raises(SystemExit):
        serve.main(base + ["--measure-reps", "0"])
    with pytest.raises(SystemExit):
        serve.main(base + ["--transport", "pool", "--workers", "0"])
    with pytest.raises(SystemExit):
        serve.main(base + ["--transport", "teleport"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "stablelm_3b", "--agent-ckpt", "/tmp/x"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "stablelm_3b", "--tiles", "t.json",
                    "--program-store", "/tmp/x.jsonl"])


@pytest.mark.parametrize("argv", [
    ["--serving"],
    ["--serving", "--tiles", "t.json"],
    ["--serving", "--autotune", "brute", "--measured", "--prune-topk",
     "2"],
    ["--serving", "--autotune", "brute", "--trace-out", "t.jsonl"],
    ["--autotune", "brute", "--metrics-port", "65536"],
    ["--autotune", "brute", "--metrics-port", "-1"],
])
def test_serving_flag_checks_are_the_references(argv, capsys):
    """Each refused combination exits with the reference's argparse
    message, word for word."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    def error(main):
        with pytest.raises(SystemExit) as e:
            main(["--arch", "stablelm_3b"] + argv)
        assert e.value.code == 2
        return capsys.readouterr().err.strip().splitlines()[-1]
    got = error(serve.main)
    want = error(jserve.main)
    assert got.split("error: ", 1)[1] == want.split("error: ", 1)[1]


SERVE = ["--device", "cpu", "--batch", "2", "--prompt-len", "16", "--gen",
         "4", "--inject"]


@pytest.mark.parametrize("agent", ["brute", "baseline"])
def test_serve_serving_gives_the_program_without_it(agent, capsys):
    """serve --serving admits the tune to the batch server: the same
    program, one fused dispatch for brute force over the cost model, and
    the serving line printed."""
    from repro_torch.launch import serve
    plain = serve.main(SERVE + ["--autotune", agent])
    capsys.readouterr()
    served = serve.main(SERVE + ["--autotune", agent, "--serving",
                                 "--slo-ms", "5000"])
    out = capsys.readouterr().out
    assert served.prog.tiles == plain.prog.tiles
    assert "[serve] serving: p50" in out and "(slo 5000 ms)" in out
    assert "health: ok" in out
    st = served.tuning["serving"]
    assert st["serving_requests_total"] == 1
    assert st.get("serving_fused_dispatches_total", 0) == (agent == "brute")
    assert served.tuning["health"] == "ok"
    np.testing.assert_array_equal(served.seq.numpy(), plain.seq.numpy())


def test_serve_serving_ppo_and_metrics_port(capsys):
    from repro_torch.launch import serve
    res = serve.main(SERVE + ["--autotune", "ppo", "--autotune-steps",
                              "64", "--serving", "--metrics-port", "0"])
    out = capsys.readouterr().out
    assert "[serve] metrics: http://127.0.0.1:" in out
    assert res.tuning["serving"]["serving_agent_batches_total"] == 1
    assert set(res.prog.tiles) == {s.key() for s in res.sites}


def test_metrics_port_serves_the_live_registry():
    from repro_torch.obs import MetricsServer, get_registry
    with TuningService(SMALL, serving=True, **CPU) as svc:
        s = svc.open_session(agent="brute", oracle="model")
        s.fit(SITES).tune(SITES)
        with MetricsServer(port=0) as srv:
            assert srv.registry is get_registry()
            text = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics",
                timeout=30).read().decode()
    assert "serving_requests_total" in text
    assert "session_tunes_total" in text


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_service_example_runs_to_ok_and_reruns_without_timing(tmp_path,
                                                             capsys):
    ex = _example("torch_service_autotune")
    db = str(tmp_path / "m.jsonl")
    _, _, st = ex.main(["--device", "cpu", "--db", db, "--steps", "32"])
    assert st["transport_timed_pairs_total"] > 0
    assert capsys.readouterr().out.rstrip().endswith("service OK")
    _, _, st = ex.main(["--device", "cpu", "--db", db, "--steps", "32",
                        "--chaos"])
    out = capsys.readouterr().out
    assert st["transport_timed_pairs_total"] == 0
    assert "[chaos] health: degraded" in out
    assert out.rstrip().endswith("service OK")


def test_serving_example_runs_to_ok(capsys):
    ex = _example("torch_serving_autotune")
    lat = ex.main(["--device", "cpu", "--clients", "3", "--rounds", "3",
                   "--slo-ms", "5000"])
    assert len(lat) == 9
    out = capsys.readouterr().out
    assert "shed: 0" in out and out.rstrip().endswith("serving OK")
