"""The port's transport conformance cases re-run under injected faults
(``tests/test_chaos.py``'s suite on ``repro_torch.measure``), the fault
machinery itself, the pool's respawn backoff and cross-process quarantine
(``tests/test_faults.py``'s pool cases), and the fault schedule bitwise
against the JAX package's.

The conformance cases of ``test_torch_transport`` are imported unmodified;
only its module-global ``_make`` is swapped for one that wraps every
transport in :class:`~repro_torch.measure.faults.FaultInjectionTransport`
and, for the pool, runs a :class:`~repro_torch.measure.faults.ChaosRunner`
inside the real workers.  Faults are deterministic and destructive ones
fire once per key, so a retried job recovers within the pool's attempts
and values and once-per-key DB writes stay exact.
"""
import inspect
import os

import numpy as np
import pytest

from repro_torch.measure import (ChaosRunner, FaultInjectionTransport,
                                 FaultSchedule, InProcessTransport,
                                 MeasureDB, WorkerPoolTransport, make_key,
                                 respawn_backoff)

import test_torch_transport as tt
from test_torch_pool_helpers import FakeRunner, fake_value

SEEDS = (0, 1)
H = tt.H


def _chaos_make(kind, db_path=None, factory=f"{H}:deterministic", **kw):
    seed = int(os.environ["REPRO_CHAOS_SEED"])
    if kind == "inproc":
        runner = kw.pop("runner", None) or FakeRunner()
        assert not kw
        inner = InProcessTransport(
            runner, MeasureDB(db_path) if db_path else None)
        return FaultInjectionTransport(inner, seed=seed)
    os.environ["REPRO_CHAOS_BASE"] = factory
    inner = WorkerPoolTransport(workers=2, db=db_path,
                                factory=f"{H}:chaos", spawn_timeout=60.0,
                                job_timeout=2.0, **kw)
    return FaultInjectionTransport(inner, seed=seed)


CONFORMANCE = [f for name, f in sorted(vars(tt).items())
               if name.startswith("test_conformance_")]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", tt.TRANSPORTS)
@pytest.mark.parametrize("case", CONFORMANCE, ids=lambda c: c.__name__)
def test_conformance_suite_survives_faults(case, kind, seed, tmp_path,
                                           monkeypatch):
    state = tmp_path / "chaos_state"
    state.mkdir()
    monkeypatch.setenv("REPRO_CHAOS_STATE", str(state))
    monkeypatch.setenv("REPRO_CHAOS_SEED", str(seed))
    monkeypatch.setattr(tt, "_make", _chaos_make)
    kwargs = ({"tmp_path": tmp_path}
              if "tmp_path" in inspect.signature(case).parameters else {})
    case(kind, **kwargs)


# ---------------------------------------------------------------------------
# the fault-injection machinery itself
# ---------------------------------------------------------------------------

def test_fault_schedule_is_deterministic_and_seed_sensitive():
    a, b, c = FaultSchedule(seed=0), FaultSchedule(seed=0), \
        FaultSchedule(seed=1)
    keys = [f"site-{i}|(8, 8, 8)" for i in range(200)]
    draws_a = [a.draw(k) for k in keys]
    assert draws_a == [b.draw(k) for k in keys]      # a pure function
    assert draws_a != [c.draw(k) for k in keys]      # the seed matters
    fired = [d for d in draws_a if d is not None]
    assert 40 < len(fired) < 160                     # about half
    assert set(fired) == set(FaultSchedule().faults)
    with pytest.raises(ValueError, match="period"):
        FaultSchedule(period=0)


def test_fault_schedule_draws_the_reference_faults():
    """The port's schedule is the reference's, bitwise, over seeds,
    periods, fault sets and keys."""
    from repro.measure.faults import FaultSchedule as JFaultSchedule
    keys = [f"{tt.MM.key()}|({i}, {8 * i}, 128)" for i in range(64)] + \
        [f"submit|{i}" for i in range(64)] + ["", "ü|(1, 1, 1)"]
    for seed in range(6):
        for faults, period in ((("crash", "hang", "torn", "noise"), 2),
                               (("noise",), 2), (("crash", "torn"), 5)):
            p = FaultSchedule(seed, faults=faults, period=period)
            j = JFaultSchedule(seed, faults=faults, period=period)
            assert [p.draw(k) for k in keys] == [j.draw(k) for k in keys]


def test_fault_injection_transport_is_correctness_invisible():
    """Values, coalescing, counters and health pass through the wrapper;
    only latency changes."""
    inner = InProcessTransport(FakeRunner())
    t = FaultInjectionTransport(inner, seed=0, noise_s=0.001)
    assert t.backend_key == inner.backend_key
    f = t.submit([tt.MM, tt.MM], np.array([[16, 128, 128]] * 2))
    t.drain()
    assert f[0] is f[1]                              # coalescing intact
    assert f[0].result() == fake_value(tt.MM.key(), (16, 128, 128))
    st = t.stats()
    assert st["transport_misses_total"] == 1
    assert st["transport_coalesced_total"] == 1
    assert "faults_injected" in st
    assert t.health() == "ok"
    t.close()
    assert t.health() == "down"                      # delegated
    with pytest.raises(RuntimeError, match="closed"):
        t.submit([tt.MM], np.array([[16, 128, 128]]))


def test_chaos_runner_noise_never_alters_values(tmp_path):
    state = tmp_path / "state"
    state.mkdir()
    r = ChaosRunner(FakeRunner(), FaultSchedule(seed=3, faults=("noise",)),
                    str(state), noise_s=0.001)
    out = r(tt.SITES, tt.TILES)
    np.testing.assert_array_equal(
        out, [fake_value(s.key(), t) for s, t in zip(tt.SITES, tt.TILES)])
    assert r.backend_key == "fake-backend" and r.device is None


def test_pool_torn_result_frame_requeues_and_recovers(tmp_path,
                                                      monkeypatch):
    """A worker that tears its result frame costs one attempt; the
    requeued job succeeds on the respawn with the identical value."""
    sentinel = str(tmp_path / "tore_once")
    monkeypatch.setenv("REPRO_TEST_TORN_FILE", sentinel)
    torn = tt.KernelSite(site="torn", kind="matmul", m=64, n=128, k=128)
    with tt._make("pool", factory=f"{H}:torn_once") as t:
        futs = t.submit([torn, tt.MM], np.array([[16, 128, 128]] * 2))
        t.drain()
        assert futs[0].result() == fake_value(torn.key(), (16, 128, 128))
        assert futs[1].result() == fake_value(tt.MM.key(), (16, 128, 128))
        st = t.stats()
        assert st["transport_retries_total"] >= 1
        assert st["pool_worker_restarts_total"] >= 1
        assert st["transport_failed_pairs_total"] == 0
    assert os.path.exists(sentinel)                  # it really tore


# ---------------------------------------------------------------------------
# respawn backoff and quarantine across processes
# ---------------------------------------------------------------------------

def test_dispatcher_backoff_is_deterministic_under_fake_clock(
        tmp_path, monkeypatch):
    """A crash-looping backend drives the dispatcher through exactly the
    respawn_backoff schedule (the ``_sleep`` seam, a fake clock), and the
    stranded job fails closed without quarantine (spawn failures are the
    pool's trouble, not the job's)."""
    monkeypatch.setenv("REPRO_TEST_SPAWN_FILE", str(tmp_path / "spawned"))
    p = str(tmp_path / "m.jsonl")
    t = WorkerPoolTransport(workers=1, db=p, factory=f"{H}:spawn_flaky",
                            backoff_base=0.05, backoff_seed=42,
                            spawn_timeout=60.0, job_timeout=30.0)
    recorded = []
    t._sleep = recorded.append          # fake clock: record, don't wait
    futs = t.submit([tt.MM], np.array([[16, 128, 128]]))
    assert futs[0].result(timeout=60) == float("inf")
    t.drain()
    assert recorded == [
        respawn_backoff(1, base=0.05, cap=30.0, seed=42),
        respawn_backoff(2, base=0.05, cap=30.0, seed=42)]
    assert t.health() == "down"         # every dispatcher gave up
    t.close()
    db = MeasureDB(p)
    assert db.get(make_key(tt.MM.key(), (16, 128, 128),
                           "fake-backend")) is None
    assert db.n_quarantined == 0


def test_quarantine_persists_and_blocks_reattempts_across_processes(
        tmp_path):
    """A pair that kills workers max_attempts times is quarantined; a
    second pool over the same path serves inf from the record, with no
    attempt and no worker death."""
    p = str(tmp_path / "m.jsonl")
    boom = tt.KernelSite(site="boom", kind="matmul", m=64, n=128, k=128)
    with tt._make("pool", db_path=p, factory=f"{H}:boom_always",
                  max_attempts=2) as t1:
        futs = t1.submit([boom, tt.MM], np.array([[16, 128, 128]] * 2))
        t1.drain()
        assert futs[0].result() == float("inf")
        backend = t1.backend_key
        assert t1.stats()["pool_quarantined_total"] == 1
    key = make_key(boom.key(), (16, 128, 128), backend)
    rec = MeasureDB(p).quarantined(key)
    assert rec is not None and rec["attempts"] == 2
    assert "worker died" in rec["reason"]
    with tt._make("pool", db_path=p, factory=f"{H}:boom_always",
                  max_attempts=2) as t2:
        futs = t2.submit([boom], np.array([[16, 128, 128]]))
        t2.drain()
        assert futs[0].result() == float("inf")
        st = t2.stats()
    assert st["transport_hits_total"] == 1           # never re-submitted
    assert st["transport_misses_total"] == 0
    assert st["pool_worker_restarts_total"] == 0
