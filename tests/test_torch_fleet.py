"""``repro_torch.fleet``: the socket transport and the artifact service
(``tests/test_fleet.py``'s cases on the port), and the fleet protocol
across packages.

The conformance cases of ``test_torch_transport`` run unmodified across a
real localhost TCP hop, with ``_make`` swapped for a
:class:`~repro_torch.fleet.MeasureServer` (over the same inner transport
flavors) behind a :class:`~repro_torch.fleet.SocketTransport`; the chaos
variant puts a ``ChaosRunner`` pool behind the socket and a
``FaultInjectionTransport`` in front.  Then the fleet's failure modes, the
shared artifact service, the wire's hardening, the ``serve-worker`` CLI,
and a port client against each reference daemon and the other way round.
"""
import inspect
import io
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.artifacts import ProgramStore, open_program_store
from repro_torch.core.vectorizer import TileProgram
from repro_torch.fleet import (ArtifactServer, MeasureServer, RemoteMeasureDB,
                               RemoteProgramStore, SocketTransport,
                               complete_versions, parse_address)
from repro_torch.measure import (TRANSPORT_NAMES, FaultInjectionTransport,
                                 InProcessTransport, WorkerPoolTransport,
                                 make_transport, open_measure_db)
from repro_torch.measure.wire import MAX_FRAME_BYTES, read_frame, write_frame
from repro_torch.models.site import KernelSite

import test_torch_transport as tt
from test_torch_pool_helpers import FakeRunner, fake_value

H = tt.H
FAST = dict(backoff_base=0.05, backoff_cap=0.2, connect_timeout=20.0,
            job_timeout=60.0)


# ---------------------------------------------------------------------------
# wire hardening: framing rejects garbage, never allocates it
# ---------------------------------------------------------------------------

def _frame_bytes(msg) -> bytes:
    buf = io.BytesIO()
    write_frame(buf, msg)
    return buf.getvalue()


def test_wire_rejects_absurd_length_prefix():
    assert struct.unpack(">I", b"garb")[0] > MAX_FRAME_BYTES
    with pytest.raises(ValueError, match="exceeds cap"):
        read_frame(io.BytesIO(b"garbage that is not a frame"))


def test_wire_cap_is_tunable_and_enforced_on_both_sides():
    msg = {"pad": "x" * 100}
    with pytest.raises(ValueError, match="exceeds cap"):
        read_frame(io.BytesIO(_frame_bytes(msg)), max_bytes=16)
    with pytest.raises(ValueError, match="refusing to write"):
        write_frame(io.BytesIO(), msg, max_bytes=16)
    data = _frame_bytes(msg)
    assert read_frame(io.BytesIO(data), max_bytes=len(data) - 4) == msg


def test_wire_truncation_is_eof_and_non_utf8_is_value_error():
    data = _frame_bytes({"type": "job", "id": 7})
    assert read_frame(io.BytesIO(data)) == {"type": "job", "id": 7}
    assert read_frame(io.BytesIO(b"")) is None          # clean EOF
    for cut in range(1, len(data)):                      # torn anywhere
        with pytest.raises(EOFError):
            read_frame(io.BytesIO(data[:cut]))
    bad = struct.pack(">I", 4) + b"\xff\xfe\xfd\xfc"
    with pytest.raises(ValueError):
        read_frame(io.BytesIO(bad))


def test_wire_fuzz_garbage_never_hangs_or_overallocates():
    rng = np.random.RandomState(0)
    for _ in range(300):
        blob = rng.bytes(int(rng.randint(0, 64)))
        try:
            msg = read_frame(io.BytesIO(blob))
        except (EOFError, ValueError):
            continue
        assert msg is None                               # only empty input


# ---------------------------------------------------------------------------
# ProgramStore.refresh: the pull half of store invalidation
# ---------------------------------------------------------------------------

def test_program_store_refresh_sees_other_writers(tmp_path):
    p = str(tmp_path / "progs.jsonl")
    with ProgramStore(p) as a, ProgramStore(p) as b:
        b.put("k1", TileProgram({"s": (16, 128, 128)}))
        assert a.get("k1") is None
        assert a.refresh() == 1
        assert a.get("k1").tiles == {"s": (16, 128, 128)}
        assert a.refresh() == 0
        a.put("k2", TileProgram({"s": (8, 128, 128)}))
        b.refresh()
        assert b.get("k2").tiles == {"s": (8, 128, 128)}


# ---------------------------------------------------------------------------
# localhost fleet fixtures
# ---------------------------------------------------------------------------

_CLEANUP = []


def _track(obj):
    _CLEANUP.append(obj)
    return obj


def _start_worker(inner, **kw) -> MeasureServer:
    srv = MeasureServer(inner, **kw)
    srv.start()
    _track(srv)
    _track(inner)
    return srv


@pytest.fixture(autouse=True)
def _fleet_cleanup():
    yield
    while _CLEANUP:
        _CLEANUP.pop().close()


def _socket_make(kind, db_path=None, factory=f"{H}:deterministic", **kw):
    """``tt._make``'s stand-in: the same inner transports behind a real
    localhost ``MeasureServer``; the DB attaches on the client."""
    if kind == "inproc":
        runner = kw.pop("runner", None) or FakeRunner()
        assert not kw
        inner = InProcessTransport(runner)
    else:
        inner = WorkerPoolTransport(workers=2, factory=factory,
                                    **{**tt.POOL_KW, **kw})
    srv = _start_worker(inner)
    return SocketTransport([srv.address], db=db_path, **FAST)


CONFORMANCE = [f for name, f in sorted(vars(tt).items())
               if name.startswith("test_conformance_")]


@pytest.mark.parametrize("kind", tt.TRANSPORTS)
@pytest.mark.parametrize("case", CONFORMANCE, ids=lambda c: c.__name__)
def test_conformance_suite_over_socket(case, kind, tmp_path, monkeypatch):
    monkeypatch.setattr(tt, "_make", _socket_make)
    kwargs = ({"tmp_path": tmp_path}
              if "tmp_path" in inspect.signature(case).parameters else {})
    case(kind, **kwargs)


def _chaos_socket_make(kind, db_path=None, factory=f"{H}:deterministic",
                       **kw):
    seed = int(os.environ["REPRO_CHAOS_SEED"])
    os.environ["REPRO_CHAOS_BASE"] = factory
    inner = WorkerPoolTransport(workers=2, factory=f"{H}:chaos",
                                spawn_timeout=60.0, job_timeout=2.0, **kw)
    srv = _start_worker(inner)
    return FaultInjectionTransport(
        SocketTransport([srv.address], db=db_path, **FAST), seed=seed)


@pytest.mark.parametrize("case", CONFORMANCE, ids=lambda c: c.__name__)
def test_chaos_conformance_over_socket(case, tmp_path, monkeypatch):
    state = tmp_path / "chaos_state"
    state.mkdir()
    monkeypatch.setenv("REPRO_CHAOS_STATE", str(state))
    monkeypatch.setenv("REPRO_CHAOS_SEED", "0")
    monkeypatch.setattr(tt, "_make", _chaos_socket_make)
    kwargs = ({"tmp_path": tmp_path}
              if "tmp_path" in inspect.signature(case).parameters else {})
    case("pool", **kwargs)


# ---------------------------------------------------------------------------
# fleet-specific failure modes
# ---------------------------------------------------------------------------

class _OtherBackendRunner(FakeRunner):
    backend_key = "other-backend"


def test_backend_mismatch_host_is_rejected():
    a = _start_worker(InProcessTransport(FakeRunner()))
    b = _start_worker(InProcessTransport(_OtherBackendRunner()))
    with SocketTransport([a.address, b.address], **FAST) as t:
        futs = t.submit(tt.SITES, tt.TILES)
        t.drain()
        assert [f.result() for f in futs] == \
            [fake_value(s.key(), tuple(tl))
             for s, tl in zip(tt.SITES, tt.TILES)]
        assert t.backend_key in ("fake-backend", "other-backend")
        for _ in range(200):                             # loser handshakes
            if "rejected" in t.host_states().values():
                break
            time.sleep(0.02)
        states = list(t.host_states().values())
        assert states.count("rejected") == 1
        assert states.count("connected") == 1
        assert t.health() == "degraded"
        assert t.stats()["transport_failed_pairs_total"] == 0


def test_server_killed_mid_batch_fails_over_to_surviving_host():
    a = _start_worker(InProcessTransport(FakeRunner(delay=0.2)))
    b = _start_worker(InProcessTransport(FakeRunner(delay=0.2)))
    sites = [KernelSite(site=f"s{i}", kind="matmul", m=32, n=128, k=128)
             for i in range(8)]
    tiles = np.array([[16, 128, 128]] * 8)
    with SocketTransport([a.address, b.address], max_connect_failures=2,
                         **FAST) as t:
        futs = t.submit(sites, tiles)
        time.sleep(0.3)                                  # jobs in flight
        a.drop_connections()
        a.close()                                        # host A is gone
        t.drain()
        for s, tl, f in zip(sites, tiles, futs):
            assert f.result() == fake_value(s.key(), tuple(tl))
        st = t.stats()
        assert st["transport_failed_pairs_total"] == 0
        assert st["transport_retries_total"] >= 1
        assert t.host_states()[a.address] in ("gone", "backing_off",
                                              "connecting")


def test_connection_reset_resends_without_double_timing():
    inner = InProcessTransport(FakeRunner(delay=0.5))
    srv = _start_worker(inner)
    with SocketTransport([srv.address], **FAST) as t:
        futs = t.submit([tt.MM], np.array([[16, 128, 128]]))
        time.sleep(0.15)
        srv.drop_connections()                           # RST mid-measure
        t.drain()
        assert futs[0].result() == fake_value(tt.MM.key(), (16, 128, 128))
        st = t.stats()
        assert st["transport_retries_total"] >= 1
        assert st["transport_failed_pairs_total"] == 0
    assert inner.stats()["transport_timed_pairs_total"] == 1


def test_idle_reset_then_resubmit_reconnects():
    srv = _start_worker(InProcessTransport(FakeRunner()))
    with SocketTransport([srv.address], **FAST) as t:
        f1 = t.submit([tt.MM], np.array([[16, 128, 128]]))
        t.drain()
        assert f1[0].result() == fake_value(tt.MM.key(), (16, 128, 128))
        srv.drop_connections()
        time.sleep(0.1)
        f2 = t.submit([tt.ATTN], np.array([[64, 128, 1]]))
        t.drain()
        assert f2[0].result() == fake_value(tt.ATTN.key(), (64, 128, 1))
        assert t.stats()["transport_failed_pairs_total"] == 0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()                                            # nobody listening
    return port


def test_fleet_down_at_construction_raises():
    with pytest.raises(RuntimeError, match="failed to start"):
        SocketTransport([f"127.0.0.1:{_free_port()}"],
                        max_connect_failures=2, backoff_base=0.01,
                        backoff_cap=0.02, connect_timeout=20.0)


def test_every_host_dying_fails_pending_closed_and_health_down():
    srv = _start_worker(InProcessTransport(FakeRunner(delay=0.4)))
    t = SocketTransport([srv.address], max_connect_failures=2,
                        backoff_base=0.02, backoff_cap=0.05,
                        connect_timeout=20.0, job_timeout=60.0)
    futs = t.submit([tt.MM, tt.ATTN],
                    np.array([[16, 128, 128], [64, 128, 1]]))
    srv.drop_connections()
    srv.close()                                          # the fleet is gone
    t.drain()                                            # must not hang
    assert [f.result() for f in futs] == [float("inf")] * 2
    assert t.stats()["transport_failed_pairs_total"] == 2
    assert t.health() == "down"
    [f3] = t.submit([tt.MM], np.array([[32, 128, 128]]))
    assert f3.result(timeout=1) == float("inf")
    t.drain()
    t.close()


# ---------------------------------------------------------------------------
# registration and facade wiring
# ---------------------------------------------------------------------------

def test_make_transport_socket_validation():
    assert TRANSPORT_NAMES == ("inproc", "pool", "socket")
    with pytest.raises(ValueError, match="hosts"):
        make_transport("socket")
    with pytest.raises(ValueError, match="socket"):
        make_transport("pool", hosts=["h:1"])
    with pytest.raises(ValueError, match="workers"):
        make_transport("socket", hosts=["h:1"], workers=4)
    with pytest.raises(TypeError, match="serve-worker"):
        make_transport("socket", hosts=["h:1"], reps=3)


def test_parse_address_shapes():
    assert parse_address("h:7761") == ("h", 7761)
    assert parse_address("fleet://h:7761") == ("h", 7761)
    assert parse_address(("h", 7761)) == ("h", 7761)
    with pytest.raises(ValueError, match="host:port"):
        parse_address("nonsense")


def test_facade_socket_transport_end_to_end(tmp_path):
    """``NeuroVectorizer(transport="socket", hosts=[...])`` tunes through
    the fleet; the saved recipe reloads against the same hosts."""
    from repro_torch.api import NeuroVectorizer
    cfg, _ = tt._small_cfgs()
    srv = _start_worker(InProcessTransport(FakeRunner()))
    p = str(tmp_path / "m.jsonl")
    with NeuroVectorizer(cfg, agent="brute", oracle="measured",
                         transport="socket", hosts=[srv.address],
                         db_path=p, device="cpu") as nv:
        t = nv.oracle.measure_fn.transport
        assert t.backend_key == "fake-backend"
        prog = nv.fit([tt.MM]).tune_sites([tt.MM])
        assert tt.MM.key() in prog.tiles
        assert t.stats()["transport_timed_pairs_total"] > 0
        assert nv._spec["hosts"] == [srv.address]
        nv.save(str(tmp_path / "art"))
    with NeuroVectorizer.load(str(tmp_path / "art"), device="cpu") as nv2:
        t2 = nv2.oracle.measure_fn.transport
        assert isinstance(t2, SocketTransport)
        assert nv2.fit([tt.MM]).tune_sites([tt.MM]).tiles == prog.tiles
        assert t2.stats()["transport_timed_pairs_total"] == 0
    with pytest.raises(ValueError, match="hosts"):
        NeuroVectorizer(cfg, hosts=[srv.address], device="cpu")


def test_serve_worker_cli_roundtrip():
    """``python -m repro_torch.fleet serve-worker --port 0`` binds, prints
    its ready line, serves a real client and exits 0 on SIGTERM."""
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    src_dir = os.path.join(os.path.dirname(tests_dir), "src")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([src_dir, tests_dir]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.fleet", "serve-worker",
         "--host", "127.0.0.1", "--port", "0", "--transport", "inproc",
         "--factory", f"{H}:deterministic"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    try:
        addr = None
        for _ in range(20):
            line = proc.stdout.readline()
            if "ready on" in line:
                addr = line.rsplit("ready on", 1)[1].strip()
                break
        assert addr, "serve-worker never printed its ready line"
        with SocketTransport([addr], **FAST) as t:
            futs = t.submit([tt.MM], np.array([[16, 128, 128]]))
            t.drain()
            assert futs[0].result() == fake_value(tt.MM.key(),
                                                  (16, 128, 128))
        proc.terminate()
        assert proc.wait(timeout=20) == 0
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_serve_worker_on_the_card_without_cuda_fails_to_start():
    """A serve-worker whose runner asks for the card fails to start where
    there is none: it never measures on the CPU."""
    from repro_torch.fleet.__main__ import main
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve-worker", "--port", "0", "--transport", "inproc"])


# ---------------------------------------------------------------------------
# the shared artifact service
# ---------------------------------------------------------------------------

def test_program_store_push_invalidation_and_pull_fallback(tmp_path):
    p = str(tmp_path / "p.jsonl")
    art = _track(ArtifactServer(program_store=p))
    art.start()
    url = f"fleet://{art.address}"
    a = _track(open_program_store(url))
    b = _track(open_program_store(url))
    assert isinstance(a, RemoteProgramStore)
    b.put("k1", TileProgram({"s": (16, 128, 128)}))
    for _ in range(200):
        if a.pushes_received:
            break
        time.sleep(0.02)
    assert a.pushes_received >= 1
    assert a.get("k1").tiles == {"s": (16, 128, 128)}    # no refresh
    with ProgramStore(p) as local:
        local.put("k2", TileProgram({"s2": (8, 64, 32)}))
    a.refresh()                                          # server refreshes
    assert a.get("k2").tiles == {"s2": (8, 64, 32)}


def test_remote_measure_db_round_trip_and_quarantine(tmp_path):
    art = _track(ArtifactServer(measure_db=str(tmp_path / "m.jsonl")))
    art.start()
    url = f"fleet://{art.address}"
    d1 = _track(RemoteMeasureDB(url))
    d2 = _track(open_measure_db(url))
    assert isinstance(d2, RemoteMeasureDB)
    d1.put("mm|(16, 128, 128)|fake-backend", 0.125)
    d1.quarantine("bad|(1, 1, 1)|fake-backend", 3, "kills workers")
    for _ in range(200):
        if d2.pushes_received >= 2:
            break
        time.sleep(0.02)
    assert d2.get("mm|(16, 128, 128)|fake-backend") == 0.125
    assert d2.get("bad|(1, 1, 1)|fake-backend") == float("inf")
    assert d2.quarantined("bad|(1, 1, 1)|fake-backend")["attempts"] == 3
    d3 = _track(RemoteMeasureDB(url))
    assert d3.get("mm|(16, 128, 128)|fake-backend") == 0.125
    assert d3.n_quarantined == 1
    assert [(r.key, r.value) for r in d3.iter_records()] == \
        [("mm|(16, 128, 128)|fake-backend", 0.125)]


def test_fleet_db_gives_second_run_zero_retimings(tmp_path):
    art = _track(ArtifactServer(measure_db=str(tmp_path / "m.jsonl")))
    art.start()
    url = f"fleet://{art.address}"
    srv = _start_worker(InProcessTransport(FakeRunner()))
    with SocketTransport([srv.address], db=url, **FAST) as t1:
        out1 = [f.result() for f in t1.submit(tt.SITES, tt.TILES)]
        t1.drain()
    with SocketTransport([srv.address], db=url, **FAST) as t2:
        out2 = [f.result() for f in t2.submit(tt.SITES, tt.TILES)]
        st = t2.stats()
    assert out2 == out1
    assert st["transport_hits_total"] == 3
    assert st["transport_timed_pairs_total"] == 0


def test_versioned_snapshots_keep_n_and_gc(tmp_path):
    vdir = str(tmp_path / "versions")
    art = _track(ArtifactServer(measure_db=str(tmp_path / "m.jsonl"),
                                program_store=str(tmp_path / "p.jsonl"),
                                versions_dir=vdir, keep_n=2))
    art.start()
    db = _track(RemoteMeasureDB(f"fleet://{art.address}"))
    db.put("k|(8, 8, 8)|b", 0.5)
    for _ in range(4):
        art.snapshot()
    kept = complete_versions(vdir)
    assert kept == [2, 3]
    for v in kept:
        vd = os.path.join(vdir, f"version_{v:06d}")
        assert os.path.exists(os.path.join(vd, "manifest.json"))
        assert os.path.exists(os.path.join(vd, "measure.jsonl"))
    os.makedirs(os.path.join(vdir, "version_000009"))
    assert complete_versions(vdir) == [2, 3]


def test_instrument_fleet_exports_per_host_series():
    from repro_torch.obs import MetricsRegistry, instrument_transport
    srv = _start_worker(InProcessTransport(FakeRunner()))
    reg = MetricsRegistry()
    with SocketTransport([srv.address], **FAST) as t:
        h = instrument_transport(t, reg)
        t.submit(tt.SITES, tt.TILES)
        t.drain()
        snap = reg.snapshot()
        assert snap["fleet_hosts_live"] == 1
        assert snap["fleet_hosts_count"] == 1
        assert snap[f'fleet_host_up{{host="{srv.address}"}}'] == 1.0
        assert snap[f'fleet_host_jobs_total{{host="{srv.address}"}}'] == 3
        assert snap["transport_timed_pairs_total"] == 3
        h.close()


def test_instrument_pool_exports_restarts_and_job_split(tmp_path,
                                                        monkeypatch):
    from repro_torch.obs import MetricsRegistry, instrument_transport
    monkeypatch.setenv("REPRO_TEST_BOOM_FILE", str(tmp_path / "died"))
    boom = KernelSite(site="boom", kind="matmul", m=64, n=128, k=128)
    reg = MetricsRegistry()
    with tt._make("pool", factory=f"{H}:boom_once") as t:
        h = instrument_transport(t, reg)
        t.submit([boom, tt.MM], np.array([[16, 128, 128]] * 2))
        t.drain()
        snap = reg.snapshot()
        assert snap["pool_worker_restarts_total"] >= 1
        assert snap["pool_workers_count"] == 2
        assert snap["pool_run_seconds"]["count"] == 2
        assert snap["transport_retries_total"] >= 1
        h.close()


# ---------------------------------------------------------------------------
# across packages: the same protocol, byte for byte
# ---------------------------------------------------------------------------

def _ref_sites():
    from repro.models.compute import KernelSite as JKernelSite
    import dataclasses
    return [JKernelSite(**dataclasses.asdict(s)) for s in tt.SITES]


def test_port_socket_transport_against_a_reference_serve_worker():
    """A port ``SocketTransport`` against the reference's ``MeasureServer``
    (its accept loop on a thread here), and a reference client against the
    port's: the same values, and each worker times each key once."""
    from repro.fleet import MeasureServer as JMeasureServer
    from repro.fleet import SocketTransport as JSocketTransport
    from repro.measure import InProcessTransport as JInProcessTransport
    want = [fake_value(s.key(), tl) for s, tl in zip(tt.SITES, tt.TILES)]
    j_inner = JInProcessTransport(FakeRunner())
    jsrv = _track(JMeasureServer(j_inner))
    jsrv.start()
    with SocketTransport([jsrv.address], **FAST) as t:
        assert t.backend_key == "fake-backend"
        assert [f.result() for f in t.submit(tt.SITES, tt.TILES)] == want
        t.drain()
    assert j_inner.stats()["transport_timed_pairs_total"] == 3
    p_inner = InProcessTransport(FakeRunner())
    psrv = _start_worker(p_inner)
    with JSocketTransport([psrv.address], backoff_base=0.05,
                          backoff_cap=0.2) as jt:
        assert [f.result() for f in jt.submit(_ref_sites(), tt.TILES)] == \
            want
        jt.drain()
    assert p_inner.stats()["transport_timed_pairs_total"] == 3


@pytest.mark.parametrize("server", ["reference", "port"])
def test_remote_stores_against_the_other_packages_artifact_server(
        server, tmp_path):
    """Each package's ``RemoteMeasureDB`` and ``RemoteProgramStore``
    against the other's ``ArtifactServer``: writes from one client, pushes
    to the other, and a fresh client's sync, quarantine included."""
    from repro.core.vectorizer import TileProgram as JTileProgram
    from repro.fleet import ArtifactServer as JArtifactServer
    from repro.fleet import RemoteMeasureDB as JRemoteMeasureDB
    from repro.fleet import RemoteProgramStore as JRemoteProgramStore
    Server = JArtifactServer if server == "reference" else ArtifactServer
    art = _track(Server(measure_db=str(tmp_path / "m.jsonl"),
                        program_store=str(tmp_path / "p.jsonl")))
    art.start()
    url = f"fleet://{art.address}"
    if server == "reference":          # a port client writes
        w_db, w_ps, P = RemoteMeasureDB(url), RemoteProgramStore(url), \
            TileProgram
        r_db, r_ps = JRemoteMeasureDB(url), JRemoteProgramStore(url)
    else:                              # a reference client writes
        w_db, w_ps, P = JRemoteMeasureDB(url), JRemoteProgramStore(url), \
            JTileProgram
        r_db, r_ps = RemoteMeasureDB(url), RemoteProgramStore(url)
    for c in (w_db, w_ps, r_db, r_ps):
        _track(c)
    w_db.put("mm|16x128x128|b", 0.25)
    w_db.put("at|64x128x1|b", float("inf"))
    w_db.quarantine("bad|1x1x1|b", 3, "kills workers")
    w_ps.put("prog", P({"s": (16, 128, 128), "t": (64, 128, 1)}))
    for _ in range(300):
        if r_db.pushes_received >= 3 and r_ps.pushes_received >= 1:
            break
        time.sleep(0.02)
    for db in (r_db, RemoteMeasureDB(url), JRemoteMeasureDB(url)):
        _track(db)
        assert db.get("mm|16x128x128|b") == 0.25
        assert db.get("at|64x128x1|b") == float("inf")
        assert db.get("bad|1x1x1|b") == float("inf")
        assert db.quarantined("bad|1x1x1|b") == {"attempts": 3,
                                                 "reason": "kills workers"}
    for ps in (r_ps, RemoteProgramStore(url), JRemoteProgramStore(url)):
        _track(ps)
        assert ps.get("prog").tiles == {"s": (16, 128, 128),
                                        "t": (64, 128, 1)}


def test_serve_worker_threads_are_not_left_behind():
    """Closing a ``MeasureServer`` and its clients leaves no fleet thread
    running."""
    srv = MeasureServer(InProcessTransport(FakeRunner())).start()
    with SocketTransport([srv.address], **FAST) as t:
        t.submit([tt.MM], np.array([[16, 128, 128]]))[0].result()
    srv.close()
    srv.transport.close()
    time.sleep(0.1)
    left = [th.name for th in threading.enumerate()
            if th.name.startswith(("fleet-", "measure-w"))
            and f"-{srv.port}" in th.name]
    assert not left


# ---------------------------------------------------------------------------
# serve's transport, warm-start and telemetry flags
# ---------------------------------------------------------------------------

SERVE = ["--arch", "stablelm_3b", "--batch", "2", "--prompt-len", "16",
         "--gen", "3", "--autotune", "brute"]


@pytest.mark.parametrize("bad", [
    ["--transport", "socket", "--measured"],
    ["--hosts", "h:1", "--measured"],
    ["--measured", "--transport", "pool", "--workers", "0"],
], ids=["socket-without-hosts", "hosts-without-socket", "zero-workers"])
def test_serve_refuses_what_the_reference_refuses(bad):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    for parse in (serve.parse_args, jserve.main):
        with pytest.raises(SystemExit) as e:
            parse(SERVE + bad)
        assert e.value.code == 2
    for argv in (["--tiles", "t.json", "--program-store", "p.jsonl"],
                 ["--tiles", "t.json", "--agent-ckpt", "ckpt"],
                 ["--tiles", "t.json", "--trace-out", "t.jsonl"]):
        with pytest.raises(SystemExit):
            serve.parse_args(SERVE[:6] + argv)


def test_serve_over_the_fleet_with_store_trace_metrics_and_ckpt(tmp_path):
    """serve --transport socket with ``fleet://`` DB and store: a cold run
    times every pair on the serve-worker, writes a trace and a metrics
    snapshot; a warm run times nothing and takes its program from the
    store; a run from a saved agent skips the fit."""
    import json

    from repro_torch.artifacts import save_agent
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.core.agents import make_agent
    from repro_torch.launch import serve
    srv = _start_worker(InProcessTransport(FakeRunner()))
    art = _track(ArtifactServer(measure_db=str(tmp_path / "m.jsonl"),
                                program_store=str(tmp_path / "p.jsonl")))
    art.start()
    fleet = ["--device", "cpu", "--measured", "--transport", "socket",
             "--hosts", srv.address, "--measure-db",
             f"fleet://{art.address}", "--program-store",
             f"fleet://{art.address}"]
    cold = serve.main(SERVE + fleet + [
        "--trace-out", str(tmp_path / "t.jsonl"),
        "--metrics-out", str(tmp_path / "m.json")])
    st = cold.tuning["stats"]
    assert st["transport_timed_pairs_total"] > 0 and \
        cold.tuning["health"] == "ok"
    assert cold.tuning["backend_key"] == "fake-backend"
    assert cold.tuning["store"]["misses"] == 1
    names = {json.loads(x).get("name") for x in open(tmp_path / "t.jsonl")}
    assert {"session", "fit", "tune"} <= names
    snap = json.load(open(tmp_path / "m.json"))
    assert snap["fleet_hosts_count"] >= 1
    warm = serve.main(SERVE + fleet)
    assert warm.tuning["stats"]["transport_timed_pairs_total"] == 0
    assert warm.tuning["store"]["hits"] == 1
    assert warm.tuning["agent_inferences"] == 0
    assert warm.prog.tiles == cold.prog.tiles
    ckpt = str(tmp_path / "ckpt")
    save_agent(make_agent("baseline", DEFAULT, device="cpu"), ckpt)
    res = serve.main(SERVE[:-1] + ["baseline", "--device", "cpu",
                                   "--agent-ckpt", ckpt])
    assert res.prog is not None and len(res.prog.tiles) == len(res.sites)


def test_serve_through_a_pool_of_the_real_cpu_runner(tmp_path):
    """serve --transport pool times in a worker running the port's runner
    on the CPU: the in-process run's DB keys and backend, nothing
    launched in this process."""
    from repro_torch.launch import serve
    keys = {}
    for transport in ("inproc", "pool"):
        db = tmp_path / f"{transport}.jsonl"
        res = serve.main(SERVE + [
            "--device", "cpu", "--measured", "--measure-reps", "1",
            "--transport", transport, "--workers", "1", "--measure-db",
            str(db)] if transport == "pool" else SERVE + [
            "--device", "cpu", "--measured", "--measure-reps", "1",
            "--measure-db", str(db)])
        assert res.tuning["health"] == "ok"
        assert res.tuning["stats"]["transport_failed_pairs_total"] == 0
        keys[transport] = {__import__("json").loads(x)["k"]
                           for x in open(db)}
    assert keys["pool"] == keys["inproc"]
    assert res.tuning["stats"]["pool_workers_count"] == 1
