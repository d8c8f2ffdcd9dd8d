"""The measured oracle's stack (``repro_torch.measure`` and
``core.env.MeasuredEnv``) against the JAX package's, and the serve path's
``--measured`` flag.

``MeasuredEnv`` is compared bitwise with the reference under
``legality="tpu_v5e"``: both get the same deterministic fake
``measure_fn``, keyed on ``site.key()`` and the tiles, so every number is
the fake's and the two must agree exactly in what they send to it, what
they cache, and when their circuit breakers open.  The runner times the
plain versions on the CPU (``device="cpu"``, capped shapes).
"""
import dataclasses
import json
import zlib

import numpy as np
import pytest
import torch

from repro.configs.neurovec import DEFAULT as JDEFAULT
from repro.core import dataset
from repro.core.env import MeasuredEnv as JMeasuredEnv
from repro.measure.db import MeasureDB as JMeasureDB
from repro_torch.configs.neurovec import DEFAULT
from repro_torch.core.env import MeasuredEnv
from repro_torch.core.protocols import MeasureTransport, resolve_health
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.measure import (CachedMeasureFn, InProcessTransport,
                                 MeasureDB, MeasureRunner, make_key,
                                 make_measured_env, make_transport,
                                 open_measure_db)
from repro_torch.models.compute import KernelSite


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU tensors: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_site(s) -> KernelSite:
    return KernelSite(**{f.name: getattr(s, f.name)
                         for f in dataclasses.fields(KernelSite)})


def _corpus(n, seed):
    jsites = dataset.generate(n, seed=seed)
    return jsites, [_port_site(s) for s in jsites]


def fake_seconds(site_key, tiles) -> float:
    """Deterministic: a time from a hash of the pair; every 7th pair
    fails (inf)."""
    h = zlib.crc32(f"{site_key}|{tuple(int(t) for t in tiles)}".encode())
    return float("inf") if h % 7 == 0 else 1e-4 * (1 + h % 997)


class FakeHook:
    def __init__(self, mode="ok"):
        self.mode = mode
        self.calls = []

    def __call__(self, sites, tiles):
        self.calls.append([(s.key(), tuple(int(x) for x in t))
                           for s, t in zip(sites, np.asarray(tiles))])
        if self.mode == "raise":
            raise ConnectionError("transport down")
        if self.mode == "inf":
            return np.full(len(sites), np.inf)
        return np.array([fake_seconds(s.key(), t)
                         for s, t in zip(sites, np.asarray(tiles))])


def _pair(mode="ok", **kw):
    jh, th = FakeHook(mode), FakeHook(mode)
    return (JMeasuredEnv(JDEFAULT, measure_fn=jh, **kw), jh,
            MeasuredEnv(DEFAULT, measure_fn=th, legality="tpu_v5e", **kw), th)


def _actions(seed, n):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, 7, n), rng.integers(0, 5, n),
                     rng.integers(0, 6, n)], 1)


# ---------------------------------------------------------------------------
# MeasuredEnv, bitwise against the reference
# ---------------------------------------------------------------------------

def test_measured_env_matches_reference_bitwise():
    jsites, tsites = _corpus(40, 5)
    je, jh, te, th = _pair()
    assert np.array_equal(je.baseline_costs(jsites),
                          te.baseline_costs(tsites))
    for seed in (0, 1):        # the second batch hits the result cache
        acts = _actions(seed, len(jsites))
        assert np.array_equal(je.rewards_batch(jsites, acts),
                              te.rewards_batch(tsites, acts))
        assert np.array_equal(je.speedups_batch(jsites, acts),
                              te.speedups_batch(tsites, acts))
    assert np.array_equal(je.cost_grid(jsites[:12]),
                          te.cost_grid(tsites[:12]))
    assert jh.calls == th.calls
    assert (je.measure_calls, je.measured_pairs) == \
        (te.measure_calls, te.measured_pairs)
    assert te.measured_pairs == sum(len(c) for c in th.calls) > 0
    assert (je.health(), te.health()) == ("ok", "ok")


def test_breaker_opens_on_a_raising_hook_as_the_reference():
    jsites, tsites = _corpus(20, 6)
    je, _, te, _ = _pair("raise")
    acts = _actions(2, len(jsites))
    assert np.array_equal(je.rewards_batch(jsites, acts),
                          te.rewards_batch(tsites, acts))
    assert je.breaker_open and te.breaker_open
    assert je.degraded_reason == te.degraded_reason
    assert te.health() == "degraded"
    assert np.array_equal(je.cost_grid(jsites[:5]), te.cost_grid(tsites[:5]))
    assert (je.measure_calls, je.measured_pairs) == \
        (te.measure_calls, te.measured_pairs) == (0, 0)


def test_breaker_opens_after_two_all_failed_batches_as_the_reference():
    jsites, tsites = _corpus(30, 7)
    je, jh, te, th = _pair("inf")
    acts = _actions(3, 10)
    j1 = je.costs_batch(jsites[:10], acts)
    t1 = te.costs_batch(tsites[:10], acts)
    assert np.array_equal(j1, t1) and np.isinf(t1).all()
    assert not je.breaker_open and not te.breaker_open
    j2 = je.costs_batch(jsites[10:20], acts)
    t2 = te.costs_batch(tsites[10:20], acts)
    assert np.array_equal(j2, t2)
    assert je.breaker_open and te.breaker_open
    assert je.degraded_reason == te.degraded_reason
    # degraded: the model prices, the collapse's failures were purged
    assert np.array_equal(je.costs_batch(jsites[:20], _actions(3, 20)),
                          te.costs_batch(tsites[:20], _actions(3, 20)))
    assert jh.calls == th.calls
    te.reset_breaker()
    assert te.health() == "ok"


def test_h100_legality_never_sends_an_unlaunchable_tile():
    _, tsites = _corpus(60, 8)
    hook = FakeHook()
    env = MeasuredEnv(DEFAULT, measure_fn=hook, legality="h100")
    env.cost_grid(tsites)
    sent = [p for c in hook.calls for p in c]
    by_key = {s.key(): s for s in tsites}
    assert sent and all(ops.tile_ok(by_key[k], t) for k, t in sent)
    timed = env.timed_tiles(tsites[0])
    assert timed and all(np.isfinite(v) for v in timed.values())


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

SITES = [KernelSite("attn.q", "matmul", m=64, n=256, k=512),
         KernelSite("attn.core", "attention", m=512, n=128, k=512,
                    batch=128, causal=True),
         KernelSite("mlstm.chunk_scan", "chunk_scan", m=256, n=1024,
                    k=1024, batch=32)]


def test_runner_times_all_three_kinds_on_the_cpu():
    r = MeasureRunner(device="cpu", reps=1, warmup=0)
    t = r(SITES, [[64, 128, 256], [128, 256, 1], [64, 1, 1]])
    assert t.shape == (3,) and np.isfinite(t).all() and (t > 0).all()
    assert (r.timed_pairs, r.failed_pairs, r.failures) == (3, 0, [])
    assert r.backend_key.endswith(":cpu:plain(dim<=128,b<=2)")
    assert r.backend_key.startswith(f"torch{torch.__version__}:")


def test_a_refused_tile_is_inf_and_counted(monkeypatch):
    real = ops.matmul

    def refuse(x, w, tiles=None):
        if tiles is not None and tiles[0] == 512:
            raise kmm.TileError("matmul tile cannot launch")
        return real(x, w, tiles=tiles)
    monkeypatch.setattr(ops, "matmul", refuse)
    r = MeasureRunner(device="cpu", reps=1, warmup=0)
    t = r([SITES[0]] * 2, [[512, 128, 128], [8, 128, 128]])
    assert np.isinf(t[0]) and np.isfinite(t[1])
    assert (r.timed_pairs, r.failed_pairs) == (1, 1)
    (key, tiles, err), = r.failures
    assert (key, tiles) == (SITES[0].key(), (512, 128, 128))
    assert err.startswith("TileError: matmul tile")


def test_runner_without_cuda_needs_the_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MeasureRunner()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_measured_env()


# ---------------------------------------------------------------------------
# the DB and the transport
# ---------------------------------------------------------------------------

def test_db_round_trip_and_torn_line(tmp_path):
    path = str(tmp_path / "m.jsonl")
    db = MeasureDB(path)
    db.put("a|1x1x1|b", 0.5)
    db.put("c|1x1x1|b", float("inf"))
    db.close()
    with open(path, "a") as f:
        f.write('{"k": "torn|1x1x1|b", "v"')          # crash mid-append
    db = MeasureDB(path)
    assert (db.get("a|1x1x1|b"), db.get("c|1x1x1|b")) == (0.5, float("inf"))
    assert db.get("torn|1x1x1|b") is None and db.skipped_lines == 1
    db.put("d|1x1x1|b", 2.0)
    db.close()
    db = MeasureDB(path)
    assert db.get("d|1x1x1|b") == 2.0 and db.skipped_lines == 1
    assert len(db) == 3


def test_a_db_written_by_the_jax_package_is_read(tmp_path):
    path = str(tmp_path / "j.jsonl")
    key = make_key(SITES[0].key(), (64, 128, 256), "be")
    jdb = JMeasureDB(path)
    jdb.put(key, 1.25e-3)
    jdb.put(make_key(SITES[1].key(), (128, 256, 1), "be"), float("inf"))
    jdb.quarantine(make_key(SITES[2].key(), (64, 1, 1), "be"), 3, "hang")
    jdb.close()
    db = open_measure_db(path)
    assert db.get(key) == 1.25e-3
    assert db.get(make_key(SITES[1].key(), (128, 256, 1), "be")) == np.inf
    assert db.get(make_key(SITES[2].key(), (64, 1, 1), "be")) == np.inf
    db.put(make_key(SITES[2].key(), (128, 1, 1), "be"), 4e-3)
    db.close()
    assert JMeasureDB(path).get(
        make_key(SITES[2].key(), (128, 1, 1), "be")) == 4e-3
    with open(path) as f:
        assert all("k" in json.loads(line) for line in f)


class SpyRunner:
    backend_key = "spy"

    def __init__(self):
        self.pairs = 0

    def __call__(self, sites, tiles):
        self.pairs += len(sites)
        return np.array([fake_seconds(s.key(), t)
                         for s, t in zip(sites, np.asarray(tiles))])


def test_transport_coalesces_and_writes_through(tmp_path):
    spy = SpyRunner()
    t = make_transport(runner=spy, db_path=str(tmp_path / "t.jsonl"))
    assert isinstance(t, MeasureTransport)
    fn = CachedMeasureFn(t)
    tiles = [[64, 128, 256]] * 3 + [[8, 128, 128]]
    v = fn([SITES[0]] * 4, tiles)
    assert spy.pairs == 2
    assert v[0] == v[1] == v[2] == fake_seconds(SITES[0].key(), tiles[0])
    st = t.stats()
    assert (st["transport_coalesced_total"], st["transport_misses_total"],
            st["transport_hits_total"]) == (2, 2, 0)
    fn([SITES[0]], tiles[:1])
    assert t.stats()["transport_hits_total"] == 1 and spy.pairs == 2
    t.close()
    assert t.health() == "down"
    t2 = make_transport(runner=SpyRunner(), db_path=str(tmp_path / "t.jsonl"))
    assert CachedMeasureFn(t2)([SITES[0]], tiles[3:])[0] == v[3]
    assert t2.stats()["transport_timed_pairs_total"] == 0


def test_unported_transports_and_pruning_raise(tmp_path):
    """Pruning is ported (``tests/test_torch_surrogate.py``): without a
    DB to train a surrogate from it stays inactive, as the reference's.
    The pool and socket transports and ``fleet://`` DBs are ported
    (``tests/test_torch_transport.py``, ``tests/test_torch_fleet.py``): a
    shared runner is refused by the pool and a socket fleet needs hosts,
    the same classes the reference raises, and a ``fleet://`` path opens
    the shared store."""
    import repro.measure as jmeasure
    from repro.measure.db import open_measure_db as jopen_measure_db
    from repro_torch.fleet import ArtifactServer, RemoteMeasureDB
    for name, err in (("pool", TypeError), ("socket", ValueError)):
        with pytest.raises(err):
            make_transport(name, runner=SpyRunner())
        with pytest.raises(err):
            jmeasure.make_transport(name, runner=SpyRunner())
    env = make_measured_env(runner=SpyRunner(), prune_topk=4)
    jenv = jmeasure.make_measured_env(runner=SpyRunner(), prune_topk=4)
    assert env.prune_topk == jenv.prune_topk == 4
    assert env.surrogate is None and not env.prune_active
    assert not jenv.prune_active
    with pytest.raises(ValueError, match="prune_topk"):
        make_measured_env(runner=SpyRunner(), prune_topk=0)
    with ArtifactServer(measure_db=str(tmp_path / "m.jsonl")) as art:
        art.start()
        db = open_measure_db(f"fleet://{art.address}")
        assert isinstance(db, RemoteMeasureDB)
        db.put("k|1x1x1|b", 0.5)
        jdb = jopen_measure_db(f"fleet://{art.address}")
        assert jdb.get("k|1x1x1|b") == 0.5
        db.close()
        jdb.close()


def test_make_measured_env_and_health():
    env = make_measured_env(runner=SpyRunner(), legality="tpu_v5e")
    assert isinstance(env.measure_fn.transport, InProcessTransport)
    assert env.legality == "tpu_v5e"
    t = env.measure_fn.transport
    assert resolve_health(env, t) == "ok"
    t.close()
    assert resolve_health(env, t) == "degraded"


# ---------------------------------------------------------------------------
# serve --measured
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3_8b", "xlstm_1_3b"])
def test_measured_serve_twice_times_nothing_the_second_time(arch, tmp_path):
    db = str(tmp_path / "m.jsonl")
    argv = ["--device", "cpu", "--arch", arch, "--batch", "2",
            "--prompt-len", "16", "--gen", "3", "--autotune", "ppo",
            "--autotune-steps", "96", "--measured", "--measure-db", db,
            "--measure-reps", "1", "--inject"]
    first = serve.main(argv)
    st = first.tuning["stats"]
    assert st["transport_timed_pairs_total"] > 0
    assert st["transport_failed_pairs_total"] == 0
    assert first.tuning["health"] == "ok" and not first.tuning["failures"]
    assert set(first.tuning["picks"]) == {s.key() for s in first.sites}
    second = serve.main(argv)
    st2 = second.tuning["stats"]
    assert st2["transport_timed_pairs_total"] == 0
    assert st2["transport_hits_total"] > 0
    assert second.prog.tiles == first.prog.tiles
    assert torch.equal(second.seq, first.seq)
    if arch == "xlstm_1_3b":
        assert first.tuning["launches"] == {"matmul": 0,
                                            "flash_attention": 0,
                                            "chunk_scan": 0}


def test_timing_helpers():
    from repro_torch.measure import timing
    calls = []
    t = timing.median_time(lambda: calls.append(1), reps=3, warmup=2)
    assert len(calls) == 5 and t >= 0
    a, b = timing.interleaved_medians(lambda: torch.ones(3),
                                      lambda: calls.append(2), reps=4)
    assert a >= 0 and b >= 0 and calls.count(2) == 4
    with pytest.raises(ValueError, match="reps"):
        timing.median_time(lambda: None, reps=0)
