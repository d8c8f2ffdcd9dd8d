"""The port's MeasureTransport contract: the conformance cases of
``tests/test_transport.py`` run against the port's in-process transport
and its subprocess pool, the pool's failure modes (a worker's death,
requeue, fail-closed with quarantine, a wedged worker, a runner that
raises), the timing DB's quarantine repair, and parity with the JAX
package (the respawn schedule, the wire bytes, the DB files in both
directions, the facade over a pool, and which pairs serve times beside
the facade).

The pool cases run real worker subprocesses speaking the real pipe
protocol; their runners come from ``test_torch_pool_helpers`` factories,
which import no JAX and no torch, so a worker starts at once.  Every pool
here sets a small ``spawn_timeout`` and ``job_timeout``.
"""
import dataclasses
import io
import json
import os

import numpy as np
import pytest

from repro_torch.core.protocols import MeasureTransport
from repro_torch.measure import (InProcessTransport, MeasureDB,
                                 TransportMeasureFn, WorkerPoolTransport,
                                 make_key, make_measured_env, make_transport,
                                 respawn_backoff)
from repro_torch.measure.wire import write_frame
from repro_torch.models.site import KernelSite

from test_torch_pool_helpers import FailRunner, FakeRunner, fake_value

MM = KernelSite(site="t.mm", kind="matmul", m=32, n=128, k=128)
ATTN = KernelSite(site="t.attn", kind="attention", m=64, n=32, k=64,
                  batch=2, causal=True)
SCAN = KernelSite(site="t.scan", kind="chunk_scan", m=32, n=16, k=8,
                  batch=2)
SITES = [MM, ATTN, SCAN]
TILES = np.array([[16, 128, 128], [64, 128, 1], [32, 1, 1]])

TRANSPORTS = ("inproc", "pool")
H = "test_torch_pool_helpers"
POOL_KW = dict(spawn_timeout=60.0, job_timeout=60.0)


def _make(kind: str, db_path=None, factory=f"{H}:deterministic", **kw):
    if kind == "inproc":
        runner = kw.pop("runner", None) or FakeRunner()
        assert not kw
        return InProcessTransport(
            runner, MeasureDB(db_path) if db_path else None)
    return WorkerPoolTransport(workers=2, db=db_path, factory=factory,
                               **{**POOL_KW, **kw})


# ---------------------------------------------------------------------------
# the shared conformance suite (tests/test_transport.py's cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", TRANSPORTS)
def test_conformance_protocol_and_values(kind):
    with _make(kind) as t:
        assert isinstance(t, MeasureTransport)
        futs = t.submit(SITES, TILES)
        t.drain()
        assert len(futs) == 3
        for s, tile, f in zip(SITES, TILES, futs):
            assert f.done()
            assert f.result() == fake_value(s.key(), tile)
        st = t.stats()
        assert st["transport_misses_total"] == 3
        assert st["transport_timed_pairs_total"] == 3
        assert st["transport_inflight_pairs"] == 0
        for key in ("transport_hits_total", "transport_misses_total",
                    "transport_coalesced_total",
                    "transport_timed_pairs_total",
                    "transport_failed_pairs_total",
                    "transport_retries_total",
                    "transport_inflight_pairs", "transport_hit_ratio"):
            assert key in st
        for legacy in ("hits", "misses", "timed_pairs", "in_flight",
                       "hit_rate"):
            assert legacy not in st


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_conformance_duplicate_keys_coalesce(kind):
    """The same key submitted many times in one batch is measured once;
    every future resolves to that value."""
    with _make(kind) as t:
        sites = [MM] * 4 + [ATTN]
        tiles = np.array([[16, 128, 128]] * 4 + [[64, 128, 1]])
        futs = t.submit(sites, tiles)
        t.drain()
        vals = [f.result() for f in futs]
        assert vals[:4] == [fake_value(MM.key(), (16, 128, 128))] * 4
        st = t.stats()
        assert st["transport_misses_total"] == 2
        assert st["transport_coalesced_total"] == 3
        assert st["transport_timed_pairs_total"] == 2


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_conformance_db_hits_and_zero_retiming(kind, tmp_path):
    """A second transport against the same DB path times nothing."""
    p = str(tmp_path / "m.jsonl")
    with _make(kind, db_path=p) as t1:
        out1 = [f.result() for f in t1.submit(SITES, TILES)]
    with _make(kind, db_path=p) as t2:
        futs = t2.submit(SITES, TILES)
        out2 = [f.result() for f in futs]
        st = t2.stats()
    assert out2 == out1
    assert st["transport_hits_total"] == 3
    assert st["transport_misses_total"] == 0
    assert st["transport_timed_pairs_total"] == 0
    assert st["transport_hit_ratio"] == 1.0


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_conformance_db_written_exactly_once_per_key(kind, tmp_path):
    """Coalesced duplicates must not produce duplicate DB lines."""
    p = str(tmp_path / "m.jsonl")
    sites = [MM, MM, ATTN, MM]
    tiles = np.array([[16, 128, 128]] * 2 + [[64, 128, 1], [16, 128, 128]])
    with _make(kind, db_path=p) as t:
        t.submit(sites, tiles)
        t.drain()
        backend = t.backend_key
    keys = [json.loads(line)["k"] for line in open(p)]
    assert sorted(keys) == sorted({
        make_key(MM.key(), (16, 128, 128), backend),
        make_key(ATTN.key(), (64, 128, 1), backend)})


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_conformance_failure_fails_closed(kind):
    """A pair the runner cannot measure resolves to inf, never raises."""
    fail = KernelSite(site="fail", kind="matmul", m=32, n=128, k=128)
    t = _make(kind, factory=f"{H}:failing") if kind == "pool" \
        else _make(kind, runner=FailRunner())
    with t:
        futs = t.submit([fail, MM], np.array([[16, 128, 128]] * 2))
        t.drain()
        assert futs[0].result() == float("inf")
        assert futs[1].result() == fake_value(MM.key(), (16, 128, 128))
        st = t.stats()
        assert st["transport_failed_pairs_total"] == 1
        assert st["transport_timed_pairs_total"] == 1


@pytest.mark.parametrize("kind", TRANSPORTS)
def test_conformance_submit_after_close_raises(kind):
    t = _make(kind)
    t.close()
    with pytest.raises(RuntimeError, match="closed"):
        t.submit([MM], np.array([[16, 128, 128]]))
    t.close()                                      # idempotent


# ---------------------------------------------------------------------------
# pool-specific failure modes
# ---------------------------------------------------------------------------

def test_pool_worker_death_requeues_and_recovers(tmp_path, monkeypatch):
    """A worker killed mid-batch costs one attempt; the requeued job
    succeeds on the respawned worker."""
    sentinel = str(tmp_path / "died_once")
    monkeypatch.setenv("REPRO_TEST_BOOM_FILE", sentinel)
    boom = KernelSite(site="boom", kind="matmul", m=64, n=128, k=128)
    with _make("pool", factory=f"{H}:boom_once") as t:
        futs = t.submit([boom, MM], np.array([[16, 128, 128]] * 2))
        t.drain()
        assert futs[0].result() == fake_value(boom.key(), (16, 128, 128))
        assert futs[1].result() == fake_value(MM.key(), (16, 128, 128))
        st = t.stats()
        assert st["transport_retries_total"] >= 1
        assert st["pool_worker_restarts_total"] >= 1
        assert st["transport_failed_pairs_total"] == 0
    assert os.path.exists(sentinel)                # it really did die


def test_pool_worker_death_fails_closed_after_max_attempts(tmp_path):
    """A job that kills every worker it lands on spends its attempts and
    resolves inf, quarantined in the DB, while other jobs survive."""
    p = str(tmp_path / "m.jsonl")
    boom = KernelSite(site="boom", kind="matmul", m=64, n=128, k=128)
    with _make("pool", db_path=p, factory=f"{H}:boom_always",
               max_attempts=2) as t:
        futs = t.submit([boom, MM], np.array([[16, 128, 128]] * 2))
        t.drain()
        assert futs[0].result() == float("inf")
        assert futs[1].result() == fake_value(MM.key(), (16, 128, 128))
        st = t.stats()
        assert st["transport_retries_total"] == 1  # attempt 1 requeued
        assert st["transport_failed_pairs_total"] == 1
        assert st["transport_timed_pairs_total"] == 1
        assert st["pool_quarantined_total"] == 1
        backend = t.backend_key
    db = MeasureDB(p)
    key = make_key(boom.key(), (16, 128, 128), backend)
    assert db.get(key) == float("inf")
    assert db.quarantined(key)["attempts"] == 2


def test_pool_cross_submit_inflight_coalescing():
    """A second submit of a key already measuring joins the job."""
    with _make("pool", factory=f"{H}:slow") as t:
        f1 = t.submit([MM], np.array([[16, 128, 128]]))
        f2 = t.submit([MM], np.array([[16, 128, 128]]))   # while in flight
        t.drain()
        assert f1[0] is f2[0]
        assert f1[0].result() == fake_value(MM.key(), (16, 128, 128))
        st = t.stats()
        assert st["transport_misses_total"] == 1
        assert st["transport_coalesced_total"] == 1


def test_pool_raising_runner_fails_closed_without_killing_worker():
    """A runner that raises inside the worker answers inf instead of
    dying: no respawn, no attempt spent."""
    boom = KernelSite(site="boom", kind="matmul", m=64, n=128, k=128)
    with _make("pool", factory=f"{H}:raising") as t:
        futs = t.submit([boom, MM], np.array([[16, 128, 128]] * 2))
        t.drain()
        assert futs[0].result() == float("inf")
        assert futs[1].result() == fake_value(MM.key(), (16, 128, 128))
        st = t.stats()
        assert st["transport_failed_pairs_total"] == 1
        assert st["transport_retries_total"] == 0
        assert st["pool_worker_restarts_total"] == 0


def test_pool_wedged_worker_hits_job_timeout_and_fails_closed():
    """A hanging measurement costs one worker per attempt (killed at
    job_timeout, job requeued), then fails closed; drain() returns."""
    wedge = KernelSite(site="wedge", kind="matmul", m=64, n=128, k=128)
    with _make("pool", factory=f"{H}:wedging", max_attempts=2,
               job_timeout=1.5) as t:
        futs = t.submit([wedge, MM], np.array([[16, 128, 128]] * 2))
        t.drain()
        assert futs[0].result() == float("inf")
        assert futs[1].result() == fake_value(MM.key(), (16, 128, 128))
        st = t.stats()
        assert st["transport_failed_pairs_total"] == 1
        assert st["transport_retries_total"] == 1
        assert st["pool_worker_restarts_total"] >= 1


def test_inproc_raising_runner_resolves_futures_before_propagating():
    """A raising runner must not strand in-flight futures; they fail
    closed, then the error reaches the submitting caller."""

    class Boom(FakeRunner):
        def __call__(self, sites, tiles):
            raise RuntimeError("runner bug")

    t = InProcessTransport(Boom())
    with pytest.raises(RuntimeError, match="runner bug"):
        t.submit([MM], np.array([[16, 128, 128]]))
    t.drain()                                      # must not hang
    st = t.stats()
    assert st["transport_failed_pairs_total"] == 1
    assert st["transport_inflight_pairs"] == 0
    t.runner = FakeRunner()
    futs = t.submit([MM], np.array([[16, 128, 128]]))
    assert futs[0].result() == fake_value(MM.key(), (16, 128, 128))
    t.close()


def test_pool_rejects_bad_arguments():
    with pytest.raises(ValueError, match="workers"):
        WorkerPoolTransport(workers=0)
    with pytest.raises(ValueError, match="max_attempts"):
        WorkerPoolTransport(workers=1, max_attempts=0)
    with pytest.raises(RuntimeError, match="failed to start"):
        WorkerPoolTransport(workers=1, factory=f"{H}:no_such_factory",
                            **POOL_KW)


def test_pool_on_the_card_without_cuda_fails_to_start(monkeypatch):
    """A pool whose runner asks for the card, where there is none, fails
    to start with the device's error; it never measures on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="failed to start") as e:
        WorkerPoolTransport(workers=1, runner_kwargs={"device": "cuda"},
                            **POOL_KW)
    assert "no CUDA device found" in str(e.value.__cause__)


def test_pool_workers_never_import_jax_or_the_reference():
    """Neither a factory worker nor one running the port's real runner
    (on the CPU, its plain versions) holds ``jax`` or ``repro`` in
    ``sys.modules``: the runner measures inf where it does."""
    with _make("pool", factory=f"{H}:modules") as t:
        assert all(np.isfinite(f.result()) for f in t.submit(SITES, TILES))
    with WorkerPoolTransport(workers=1, factory=f"{H}:modules_cpu_runner",
                             **POOL_KW) as t:
        [f] = t.submit([MM], np.array([[16, 128, 128]]))
        assert np.isfinite(f.result())
        assert t.backend_key.endswith("cpu:plain(dim<=128,b<=2)")


def test_pool_with_the_real_cpu_runner_matches_in_process(tmp_path):
    """``make_transport("pool", device="cpu")`` builds the port's runner
    in each worker: same backend key and DB keys as the in-process
    transport."""
    with make_transport("pool", workers=1, reps=1, warmup=0,
                        device="cpu", db_path=str(tmp_path / "p.jsonl")) as t:
        [f] = t.submit([MM], np.array([[16, 128, 128]]))
        assert np.isfinite(f.result()) and f.result() > 0
        pool_backend = t.backend_key
    with make_transport("inproc", reps=1, warmup=0, device="cpu") as t:
        assert t.backend_key == pool_backend


# ---------------------------------------------------------------------------
# the factories and adapters around transports
# ---------------------------------------------------------------------------

def test_make_transport_validation():
    with pytest.raises(ValueError, match="unknown transport"):
        make_transport("carrier-pigeon")
    with pytest.raises(ValueError, match="workers"):
        make_transport("inproc", workers=4)
    with pytest.raises(ValueError, match="workers"):
        make_transport("pool", workers=0)          # not coerced to default
    with pytest.raises(TypeError, match="db"):
        make_transport("inproc", db=MeasureDB("/tmp/x.jsonl"),
                       db_path="/tmp/y.jsonl")
    with pytest.raises(TypeError, match="runner"):
        make_transport("pool", runner=FakeRunner())
    t = make_transport("inproc", runner=FakeRunner())
    assert isinstance(t, InProcessTransport)
    t.close()


def test_make_measured_env_rejects_args_with_prebuilt_transport():
    t = InProcessTransport(FakeRunner())
    with pytest.raises(TypeError, match="pre-built transport"):
        make_measured_env(transport=t, db_path="/tmp/x.jsonl")
    with pytest.raises(TypeError, match="pre-built transport"):
        make_measured_env(transport=t, reps=3)
    with pytest.raises(TypeError, match="pre-built transport"):
        make_measured_env(transport=t, workers=2)
    t.close()


def test_transport_measure_fn_adapts_any_transport():
    with InProcessTransport(FakeRunner()) as t:
        fn = TransportMeasureFn(t)
        out = fn(SITES, TILES)
        assert out.shape == (3,)
        np.testing.assert_allclose(
            out, [fake_value(s.key(), tl) for s, tl in zip(SITES, TILES)])
        assert fn.misses == 3 and fn.hits == 0


# ---------------------------------------------------------------------------
# the timing DB's quarantine, and files shared with the JAX package
# ---------------------------------------------------------------------------

def test_quarantine_survives_lru_eviction_in_both_packages(tmp_path):
    """A DB the reference quarantined a key in, opened with
    ``max_entries=1`` by both packages: once other keys evict it from the
    LRU, ``get`` still answers inf in both."""
    from repro.measure.db import MeasureDB as JMeasureDB
    p = str(tmp_path / "q.jsonl")
    poison = make_key(MM.key(), (16, 128, 128), "b")
    j = JMeasureDB(p)
    j.quarantine(poison, 3, "kills workers")
    j.close()
    dbs = (JMeasureDB(p, max_entries=1), MeasureDB(p, max_entries=1))
    for db in dbs:
        for i in range(3):
            db.put(make_key(ATTN.key(), (64, 128 * (i + 1), 1), "b"), 1e-3)
        assert poison not in db                    # evicted from the LRU
    assert [db.get(poison) for db in dbs] == [float("inf")] * 2
    assert dbs[1].quarantined(poison) == {"attempts": 3,
                                          "reason": "kills workers"}
    assert dbs[1].n_quarantined == 1
    for db in dbs:
        db.close()


def _db_state(db):
    return (dict(db._mem), dict(db._quarantined), db.skipped_lines,
            [tuple(r) for r in db.iter_records()])


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_db_files_read_back_the_same_in_both_packages(writer, tmp_path):
    """Puts, failures, a quarantine, a garbage line and a torn tail
    written by either package read back identically in both, and an
    append after the torn tail lands on a fresh line in both."""
    from repro.measure.db import MeasureDB as JMeasureDB
    p = str(tmp_path / "x.jsonl")
    W = MeasureDB if writer == "port" else JMeasureDB
    db = W(p)
    db.put(make_key(MM.key(), (16, 128, 128), "b"), 1.5e-4)
    db.put(make_key(ATTN.key(), (64, 128, 1), "b"), float("inf"))
    db.quarantine(make_key(SCAN.key(), (32, 1, 1), "b"), 2, "wedged")
    db.put(make_key(MM.key(), (16, 128, 128), "b"), 2.5e-4)   # last wins
    db.close()
    with open(p, "a") as f:
        f.write("not json\n" + '{"k": "torn|1x1x1|b", "v": 0.')
    port, ref = MeasureDB(p), JMeasureDB(p)
    assert _db_state(port) == _db_state(ref)
    assert port.get(make_key(SCAN.key(), (32, 1, 1), "b")) == float("inf")
    assert len(list(port.iter_records())) == 2
    port.put("after|1x1x1|b", 1.0)
    port.close()
    assert JMeasureDB(p).get("after|1x1x1|b") == 1.0
    empty = str(tmp_path / "empty.jsonl")
    open(empty, "w").close()
    for D in (MeasureDB, JMeasureDB):
        d = D(empty)
        d.put("e|1x1x1|b", 2.0)
        d.close()
    assert [json.loads(x)["k"] for x in open(empty)] == ["e|1x1x1|b"] * 2


def test_respawn_backoff_and_wire_frames_match_the_reference():
    from repro.measure.pool import respawn_backoff as jrespawn
    from repro.measure.wire import write_frame as jwrite_frame
    for seed in range(8):
        for failures in range(1, 12):
            for base, cap in ((0.1, 30.0), (0.05, 0.2), (1.0, 5.0)):
                assert respawn_backoff(failures, base=base, cap=cap,
                                       seed=seed) == \
                    jrespawn(failures, base=base, cap=cap, seed=seed)
    with pytest.raises(ValueError, match="failures"):
        respawn_backoff(0)
    msgs = [{"type": "init", "runner": {"reps": 3}, "factory": None},
            {"type": "job", "id": 7, "site": dataclasses.asdict(ATTN),
             "tiles": [64, 128, 1]},
            {"type": "result", "id": 7, "v": None},
            {"type": "result", "id": 8, "v": 1.25e-4, "cached": True},
            {"type": "welcome", "backend": "torch:ü", "slots": 2}]
    for m in msgs:
        a, b = io.BytesIO(), io.BytesIO()
        write_frame(a, m)
        jwrite_frame(b, m)
        assert a.getvalue() == b.getvalue()


# ---------------------------------------------------------------------------
# the facade over a pool, and what serve times beside the facade
# ---------------------------------------------------------------------------

def _small_cfgs():
    from repro.configs.neurovec import NeuroVecConfig as JCfg
    from repro_torch.configs.neurovec import NeuroVecConfig
    kw = dict(bm_choices=(16, 32), bn_choices=(128, 256),
              bk_choices=(128,), bq_choices=(64,), bkv_choices=(128,),
              chunk_choices=(32, 64))
    return NeuroVecConfig(**kw), JCfg(**kw)


def test_facade_over_a_pool_gives_the_reference_program(tmp_path):
    """The port's and the reference's facades, each with a brute-force
    agent over its own package's pool of two workers running the same
    fake runner, tune the same ``TileProgram`` under the reference's
    VMEM rule."""
    from repro.api import NeuroVectorizer as JNeuroVectorizer
    from repro.measure import WorkerPoolTransport as JPool
    from repro_torch.api import NeuroVectorizer
    cfg, jcfg = _small_cfgs()
    with JPool(workers=2, factory="pool_helpers:deterministic") as jt:
        jnv = JNeuroVectorizer(jcfg, agent="brute", oracle="measured",
                               transport=jt)
        want = jnv.fit(SITES).tune_sites(SITES).tiles
        jnv.close()
    with _make("pool") as t:
        env = make_measured_env(cfg, transport=t, legality="tpu_v5e")
        nv = NeuroVectorizer(cfg, agent="brute", oracle=env, device="cpu")
        got = nv.fit(SITES).tune_sites(SITES).tiles
        assert t.stats()["transport_timed_pairs_total"] > 0
        nv.close()
    assert got == want


def _db_keys(path) -> set:
    return {json.loads(x)["k"].rsplit("|", 1)[0] for x in open(path)}


def test_serve_times_the_facade_pairs_and_the_baseline_tiles(tmp_path,
                                                             monkeypatch):
    """Why a measured brute-force serve times one pair more than the
    facade's fit and tune at StableLM-3B (1674 against 1673 on the card):
    serve also prices the baseline program, and one baseline tile (decode
    attention's, ``bq`` = 8) lies outside the action space.  Both packages
    do the same: serve's timed keys are the facade's fit-and-tune keys
    plus the baseline tiles the grid lacks, and the facade's
    ``speedup`` times exactly those."""
    import repro.measure as jmeasure
    from repro.api import NeuroVectorizer as JNeuroVectorizer
    from repro.configs.neurovec import DEFAULT as JDEFAULT
    from repro.core import costmodel_vec as jcv
    from repro.core.env import ActionSpace as JActionSpace
    from repro.launch import serve as jserve
    from repro_torch.api import NeuroVectorizer
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.launch import serve
    from repro_torch.measure import runner as prunner

    class Fake(FakeRunner):
        def __init__(self, **kw):
            super().__init__()
    monkeypatch.setattr(prunner, "MeasureRunner", Fake)
    monkeypatch.setattr(jmeasure, "MeasureRunner", Fake)
    common = ["--arch", "stablelm_3b", "--batch", "2", "--prompt-len", "16",
              "--gen", "3", "--autotune", "brute", "--measured"]

    def extra_pairs(space, cv, sites):
        grids = {k: {tuple(int(x) for x in t)
                     for t in cv.action_tiles_grid(space, k)}
                 for k in ("matmul", "attention", "chunk_scan")}
        return {make_key(s.key(), t, "x").rsplit("|", 1)[0]
                for s, t in zip(sites, cv.baseline_tiles_batch(sites))
                if tuple(int(x) for x in t) not in grids[s.kind]}

    # the port: serve on the CPU, then its facade on serve's sites
    p_serve, p_fac = tmp_path / "ps.jsonl", tmp_path / "pf.jsonl"
    res = serve.main(common + ["--device", "cpu", "--measure-db",
                               str(p_serve)])
    env = make_measured_env(DEFAULT, runner=Fake(), db_path=str(p_fac),
                            legality="cpu")
    nv = NeuroVectorizer(DEFAULT, agent="brute", oracle=env, device="cpu")
    prog = nv.fit(res.sites).tune_sites(res.sites)
    fit_tune = _db_keys(p_fac)
    nv.speedup(prog, res.sites)
    nv.close()
    env.measure_fn.transport.close()
    port_extra = _db_keys(p_serve) - fit_tune
    assert _db_keys(p_serve) == _db_keys(p_fac)
    from repro_torch.core import costmodel_vec as cv
    from repro_torch.core.env import ActionSpace
    assert port_extra == extra_pairs(ActionSpace(DEFAULT), cv, res.sites)
    assert port_extra and all(k.startswith("attention:") for k in
                              port_extra)

    # the reference: its serve, then its facade on the same sites
    j_serve, j_fac = tmp_path / "js.jsonl", tmp_path / "jf.jsonl"
    jserve.main(common + ["--measure-db", str(j_serve)])
    from repro.models.compute import KernelSite as JKernelSite
    jsites = [JKernelSite(**dataclasses.asdict(s)) for s in res.sites]
    jnv = JNeuroVectorizer(JDEFAULT, agent="brute", oracle="measured",
                           db_path=str(j_fac))
    jprog = jnv.fit(jsites).tune_sites(jsites)
    j_fit_tune = _db_keys(j_fac)
    jnv.speedup(jprog, jsites)
    jnv.close()
    assert _db_keys(j_serve) == _db_keys(j_fac)
    assert _db_keys(j_serve) - j_fit_tune == port_extra == \
        extra_pairs(JActionSpace(JDEFAULT), jcv, jsites)
