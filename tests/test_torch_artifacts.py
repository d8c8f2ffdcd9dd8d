"""The port's artifact layer (``repro_torch.artifacts``) and the facade's
persistence, carried over from ``tests/test_artifacts.py:77-330`` (the
tests that need no tuning service), plus the cross-package format: a
reference agent or facade artifact loads into the port.

The invariant: ``load(save(nv)).tune_sites(S)`` is bitwise
``nv.tune_sites(S)``, and a second tune of the same site set through a
``ProgramStore`` performs zero agent inferences and zero oracle
evaluations.
"""
import json
import os

import numpy as np
import pytest

from repro_torch.api import (CostModelEnv, NeuroVecConfig, NeuroVectorizer,
                             TileProgram, make_agent)
from repro_torch.artifacts import (ArtifactError, ProgramStore,
                                   agent_fingerprint, load_agent,
                                   open_program_store, program_key,
                                   read_agent_state, save_agent,
                                   tune_through_store)
from repro_torch.core import dataset

NV = NeuroVecConfig(train_batch=64, sgd_minibatch=32, ppo_epochs=2)
ENV = CostModelEnv(NV)


def launchable(n, seed):
    """``n`` corpus sites with a tile the kernels launch: under the port's
    default rule (``legality="h100"``) an f32 site has none, and tuning
    it raises."""
    sites = dataset.generate(4 * n, seed=seed)
    ok = np.isfinite(ENV.cost_grid(sites)).any(1) & \
        np.isfinite(ENV.baseline_costs(sites))
    return [s for s, k in zip(sites, ok) if k][:n]


SITES = launchable(8, seed=21)
OTHER = launchable(5, seed=22)
CPU = {"device": "cpu"}


def carried_embed_fn(seed=0):
    """The port's embed_fn on the reference embedder's params."""
    import jax
    from repro.core import embedding as jemb
    from repro_torch import convert
    from repro_torch.core.agents import embed_fn_from_params
    p = jemb.embedder_init(jax.random.PRNGKey(seed))
    return embed_fn_from_params(convert.embedder_from_jax(
        {k: np.asarray(v) for k, v in p.items()}, device="cpu"))


class CountingOracle:
    """CostModelEnv wrapper counting every oracle evaluation."""

    def __init__(self, cfg):
        self._env = CostModelEnv(cfg)
        self.calls = 0

    def __getattr__(self, name):
        attr = getattr(self._env, name)
        if name in ("baseline_costs", "costs_batch", "rewards_batch",
                    "speedups_batch", "cost_grid", "tiles_costs"):
            def counted(*a, **k):
                self.calls += 1
                return attr(*a, **k)
            return counted
        return attr


class CountingAgent:
    """Protocol agent whose act() counts inferences."""

    name = "polly"

    def __init__(self, cfg):
        self._inner = make_agent("polly", cfg)
        self.act_calls = 0

    def fit(self, sites, oracle, **kw):
        self._inner.fit(sites, oracle, **kw)
        return self

    def act(self, sites, *, sample=False, legal=None):
        self.act_calls += 1
        return self._inner.act(sites, sample=sample, legal=legal)

    def state_dict(self):
        return self._inner.state_dict()

    def load_state(self, state):
        self._inner.load_state(state)
        return self


# ---------------------------------------------------------------------------
# agent checkpoint format
# ---------------------------------------------------------------------------

def test_agent_artifact_fingerprint_mismatch_rejected(tmp_path):
    agent = make_agent("ppo", NV, seed=0, **CPU).fit(SITES, ENV,
                                                     total_steps=64)
    art = str(tmp_path / "a")
    save_agent(agent, art)
    npz = os.path.join(art, "state.npz")
    data = bytearray(open(npz, "rb").read())
    data[len(data) // 2] ^= 0xFF
    with open(npz, "wb") as f:
        f.write(bytes(data))
    import zipfile
    import zlib
    with pytest.raises((ArtifactError, zipfile.BadZipFile, zlib.error,
                        OSError, ValueError)):
        load_agent(art, cfg=NV, seed=0, **CPU)


def test_agent_artifact_tampered_json_rejected(tmp_path):
    agent = make_agent("random", NV, seed=3).fit([], ENV)
    art = str(tmp_path / "a")
    save_agent(agent, art)
    sj = os.path.join(art, "state.json")
    state = json.load(open(sj))
    state["seed"] = 999
    with open(sj, "w") as f:
        json.dump(state, f)
    with pytest.raises(ArtifactError, match="fingerprint mismatch"):
        load_agent(art, cfg=NV, seed=3)


def test_agent_artifact_missing_manifest_not_restorable(tmp_path):
    agent = make_agent("baseline", NV).fit(SITES, ENV)
    art = str(tmp_path / "a")
    save_agent(agent, art)
    os.remove(os.path.join(art, "manifest.json"))
    with pytest.raises(ArtifactError, match="manifest.json missing"):
        read_agent_state(art)
    with pytest.raises(ArtifactError, match="no restorable"):
        load_agent(str(tmp_path / "never-written"))


def test_agent_state_name_version_validation():
    ppo = make_agent("ppo", NV, seed=0, **CPU)
    state = make_agent("random", NV, seed=0).state_dict()
    with pytest.raises(ValueError, match="cannot load into"):
        ppo.load_state(state)
    bad = ppo.state_dict()
    bad["version"] = 999
    with pytest.raises(ValueError, match="version"):
        ppo.load_state(bad)


def test_fit_changes_agent_fingerprint():
    a = make_agent("ppo", NV, seed=0, **CPU)
    fp0 = agent_fingerprint(a)
    a.fit(SITES, ENV, total_steps=64)
    assert agent_fingerprint(a) != fp0


def test_tensor_leaves_are_stored_as_numpy(tmp_path):
    """A state with torch tensors saves as numpy and fingerprints as the
    same numbers in numpy do."""
    import torch
    from repro_torch.artifacts import fingerprint_state
    st = {"name": "x", "version": 1, "w": torch.arange(6.).reshape(2, 3)}
    same = {"name": "x", "version": 1,
            "w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    assert fingerprint_state(st) == fingerprint_state(same)


def test_save_agent_resave_keeps_artifact_restorable(tmp_path):
    art = str(tmp_path / "a")
    agent = make_agent("ppo", NV, seed=0, **CPU)
    save_agent(agent, art)
    agent.fit(SITES, ENV, total_steps=64)
    fp2 = save_agent(agent, art)
    loaded = load_agent(art, cfg=NV, seed=0, **CPU)
    assert agent_fingerprint(loaded) == fp2
    assert not [d for d in os.listdir(tmp_path)
                if ".tmp-" in d or ".old-" in d]


# ---------------------------------------------------------------------------
# the ProgramStore
# ---------------------------------------------------------------------------

def test_program_store_roundtrip_and_last_wins(tmp_path):
    p = str(tmp_path / "progs.jsonl")
    store = ProgramStore(p)
    store.put("k1", TileProgram({"a|1": (128, 256, 512), "b|2": (64, 1, 1)}))
    store.put("k1", TileProgram({"a|1": (8, 128, 128)}))
    store.close()
    s2 = ProgramStore(p)
    assert len(s2) == 1
    got = s2.get("k1")
    assert got.tiles == {"a|1": (8, 128, 128)}
    assert all(isinstance(v, tuple) for v in got.tiles.values())
    assert s2.get("nope") is None
    assert s2.stats()["hits"] == 1 and s2.stats()["misses"] == 1


def test_program_store_corrupted_file_recovery(tmp_path):
    p = str(tmp_path / "progs.jsonl")
    good = {"k": "ok", "v": {"s|1": [16, 128, 128]}}
    with open(p, "w") as f:
        f.write(json.dumps(good) + "\n")
        f.write("not json at all\n")
        f.write('{"k": "torn", "v": {"s|1": [16,\n')
        f.write('{"no_key": 1}\n')
        f.write('{"k": "badv", "v": "not-a-mapping"}\n')
        f.write('{"k": "badtile", "v": {"s|1": ["x", 1, 2]}}\n')
    store = ProgramStore(p)
    assert store.skipped_lines == 5
    assert store.get("ok").tiles == {"s|1": (16, 128, 128)}
    store.put("fresh", TileProgram({"t|2": (8, 1, 1)}))
    store.close()
    assert ProgramStore(p).get("fresh").tiles == {"t|2": (8, 1, 1)}


def test_program_store_reads_the_references_file(tmp_path):
    """Both packages write and read one JSONL layout."""
    from repro.artifacts import ProgramStore as JProgramStore
    from repro.core.vectorizer import TileProgram as JTileProgram
    p = str(tmp_path / "p.jsonl")
    js = JProgramStore(p)
    js.put("k", JTileProgram({"s|1": (32, 128, 256)}))
    js.close()
    store = ProgramStore(p)
    assert store.get("k").tiles == {"s|1": (32, 128, 256)}
    store.put("k2", TileProgram({"s|2": (64, 256, 1)}))
    store.close()
    assert JProgramStore(p).get("k2").tiles == {"s|2": (64, 256, 1)}


def test_program_key_discriminates_all_three_coordinates():
    a1 = make_agent("polly", NV).fit([], ENV)
    k = program_key(SITES, a1, ENV)
    assert program_key(list(reversed(SITES)), a1, ENV) == k
    assert program_key(OTHER, a1, ENV) != k
    p0 = make_agent("ppo", NV, seed=0, **CPU)
    p1 = make_agent("ppo", NV, seed=0, **CPU)
    assert program_key(SITES, p0, ENV) == program_key(SITES, p1, ENV)
    p1.fit(SITES, ENV, total_steps=64)
    assert program_key(SITES, p0, ENV) != program_key(SITES, p1, ENV)
    other_env = CostModelEnv(NeuroVecConfig(illegal_slowdown=25.0))
    assert program_key(SITES, a1, other_env) != k
    # the port's two launch rules tune differently: their keys differ
    assert program_key(SITES, a1, CostModelEnv(NV,
                                               legality="tpu_v5e")) != k


def test_store_hit_performs_zero_inferences_and_zero_oracle_evals(tmp_path):
    store = ProgramStore(str(tmp_path / "p.jsonl"))
    agent = CountingAgent(NV)
    oracle = CountingOracle(NV)
    agent.fit(SITES, oracle)
    prog1, hit1 = tune_through_store(SITES, agent, ENV.space, oracle, store)
    assert not hit1 and agent.act_calls == 1
    oracle.calls = 0
    prog2, hit2 = tune_through_store(SITES, agent, ENV.space, oracle, store)
    assert hit2
    assert agent.act_calls == 1
    assert oracle.calls == 0
    assert prog2.tiles == prog1.tiles
    store.close()


def test_fleet_store_raises_not_ported(tmp_path):
    """The fleet store is ported now: a ``fleet://`` path opens a mirror
    of a ``serve-artifacts`` daemon's store, shared with a local writer
    of its file; with no daemon listening it raises as the reference
    does."""
    import socket

    from repro_torch.fleet import ArtifactServer, RemoteProgramStore
    p = str(tmp_path / "p.jsonl")
    with ArtifactServer(program_store=p) as art:
        art.start()
        store = open_program_store(f"fleet://{art.address}")
        assert isinstance(store, RemoteProgramStore)
        store.put("k", TileProgram({"s|1": (16, 128, 128)}))
        store.close()
    assert ProgramStore(p).get("k").tiles == {"s|1": (16, 128, 128)}
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with pytest.raises(ConnectionRefusedError):
        open_program_store(f"fleet://127.0.0.1:{port}")


# ---------------------------------------------------------------------------
# facade: save/load + program_store + close()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("ppo", "dtree", "nns", "brute", "random",
                                  "polly", "baseline"))
def test_facade_save_load_roundtrip_invariant(name, tmp_path):
    nv = NeuroVectorizer(NV, agent=name, seed=0, **CPU)
    fit_kw = {"total_steps": 96} if name == "ppo" else {}
    nv.fit(SITES, **fit_kw)
    p1 = nv.tune_sites(SITES)
    art = str(tmp_path / "facade")
    nv.save(art)
    nv2 = NeuroVectorizer.load(art, **CPU)
    assert nv2.cfg == NV
    assert nv2.tune_sites(SITES).tiles == p1.tiles


def test_facade_load_shares_program_store_across_facades(tmp_path):
    store_path = str(tmp_path / "progs.jsonl")
    art = str(tmp_path / "facade")
    nv = NeuroVectorizer(NV, agent="ppo", seed=0, program_store=store_path,
                         **CPU)
    nv.fit(SITES, total_steps=96)
    p1 = nv.tune_sites(SITES)
    assert nv.store_misses == 1 and nv.agent_inferences == len(SITES)
    nv.save(art)
    nv.close()
    nv2 = NeuroVectorizer.load(art, program_store=store_path, **CPU)
    p2 = nv2.tune_sites(SITES)
    assert p2.tiles == p1.tiles
    assert nv2.store_hits == 1 and nv2.agent_inferences == 0
    p3 = nv2.tune_sites(OTHER)
    assert nv2.store_misses == 1 and nv2.agent_inferences == len(OTHER)
    assert len(p3.tiles) == len(OTHER)
    nv2.close()


def test_facade_closed_raises_clear_runtime_error(tmp_path):
    nv = NeuroVectorizer(NV, agent="polly",
                         program_store=str(tmp_path / "p.jsonl"), **CPU)
    nv.fit(SITES)
    nv.close()
    nv.close()
    with pytest.raises(RuntimeError, match="closed"):
        nv.tune_sites(SITES)
    with pytest.raises(RuntimeError, match="closed"):
        nv.fit(SITES)


def test_facade_save_rejects_handbuilt_embedding_agent(tmp_path):
    agent = make_agent("nns", NV, seed=0, **CPU).fit(SITES, ENV)
    nv = NeuroVectorizer(NV, agent=agent, **CPU)
    with pytest.raises(ArtifactError, match="embed_fn"):
        nv.save(str(tmp_path / "f"))
    nv2 = NeuroVectorizer(NV, agent="nns", seed=0, **CPU)
    nv2.agent.load_state(agent.state_dict())
    art = str(tmp_path / "g")
    nv2.save(art)
    fresh = make_agent("nns", NV, seed=0, **CPU)
    nv3 = NeuroVectorizer.load(art, agent=fresh, **CPU)
    assert nv3.agent is fresh
    assert nv3.tune_sites(SITES).tiles == nv2.tune_sites(SITES).tiles


def test_facade_load_model_override_skips_transport_requirement(tmp_path):
    from repro_torch.measure import InProcessTransport

    class Spy:
        backend_key = "spy-backend"

        def __call__(self, sites, tiles):
            return np.full(len(sites), 1e-3)

    t = InProcessTransport(Spy())
    nv = NeuroVectorizer(NV, agent="polly", oracle="measured", transport=t,
                         **CPU)
    nv.fit(SITES)
    art = str(tmp_path / "f")
    nv.save(art)
    with pytest.raises(ArtifactError, match="hand-built"):
        NeuroVectorizer.load(art, **CPU)
    nv2 = NeuroVectorizer.load(art, oracle="model", **CPU)
    assert len(nv2.tune_sites(SITES).tiles) == len(SITES)
    t.close()


# ---------------------------------------------------------------------------
# the reference's facade artifacts in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("ppo", "dtree", "nns", "brute", "random",
                                  "polly", "baseline"))
def test_reference_facade_loads_into_the_port(name, tmp_path):
    """A facade the reference saved under ``oracle="model"`` loads in the
    port and tunes the reference's program under the reference's VMEM rule
    (nns and dtree on the carried embedder)."""
    from repro.api import NeuroVecConfig as JNeuroVecConfig
    from repro.api import NeuroVectorizer as JNeuroVectorizer
    from repro.core import dataset as jds
    kw = dict(train_batch=64, sgd_minibatch=32, ppo_epochs=2)
    keys = {s.key() for s in SITES}
    jsites = [s for s in jds.generate(32, seed=21) if s.key() in keys]
    assert [s.key() for s in jsites] == [s.key() for s in SITES]
    jnv = JNeuroVectorizer(JNeuroVecConfig(**kw), agent=name, seed=0)
    jnv.fit(jsites, **({"total_steps": 96} if name == "ppo" else {}))
    want = jnv.tune_sites(jsites).tiles
    art = str(tmp_path / "ref")
    jnv.save(art)
    agent = (make_agent(name, NV, seed=0, embed_fn=carried_embed_fn(), **CPU)
             if name in ("nns", "dtree") else None)
    nv = NeuroVectorizer.load(art, agent=agent, **CPU,
                              oracle=CostModelEnv(NV, legality="tpu_v5e"))
    assert nv.cfg == NV and nv.agent.name == name
    assert nv.tune_sites(SITES).tiles == want


def test_reference_measured_recipe_with_unknown_runner_option(tmp_path):
    """A measured recipe carrying the reference runner's ``interpret``
    raises ``ArtifactError`` naming it; under a model override it loads."""
    art = tmp_path / "ref"
    nv = NeuroVectorizer(NV, agent="brute", **CPU)
    nv.save(str(art))
    spec = json.loads((art / "facade.json").read_text())
    spec.update(oracle="measured", transport=None,
                oracle_kwargs={"reps": 1, "interpret": True})
    (art / "facade.json").write_text(json.dumps(spec))
    with pytest.raises(ArtifactError, match="interpret"):
        NeuroVectorizer.load(str(art), **CPU)
    assert NeuroVectorizer.load(str(art), oracle="model",
                                **CPU).agent.name == "brute"


def test_facade_measured_roundtrip_and_warm_db(tmp_path):
    """A measured facade (the plain versions on the CPU) saves, loads
    with the same DB, tunes the same program, and times nothing more."""
    cfg = NeuroVecConfig(bm_choices=(16, 32), bn_choices=(128,),
                         bk_choices=(128,), bq_choices=(64,),
                         bkv_choices=(128,), chunk_choices=(32,))
    from repro_torch.models.compute import KernelSite
    sites = [KernelSite(site="f.mm", kind="matmul", m=64, n=128, k=128,
                        dtype="bfloat16")]
    db = str(tmp_path / "m.jsonl")
    nv = NeuroVectorizer(cfg, agent="brute", oracle="measured", db_path=db,
                         oracle_kwargs=dict(reps=1, warmup=0), **CPU)
    prog = nv.fit(sites).tune_sites(sites)
    timed = nv.oracle.measure_fn.transport.stats()[
        "transport_timed_pairs_total"]
    assert timed > 0 and nv.health() == "ok"
    art = str(tmp_path / "f")
    nv.save(art)
    nv.close()
    nv2 = NeuroVectorizer.load(art, **CPU)
    assert nv2.fit(sites).tune_sites(sites).tiles == prog.tiles
    st = nv2.oracle.measure_fn.transport.stats()
    assert st["transport_timed_pairs_total"] == 0
    assert st["transport_hits_total"] >= timed
    nv2.close()
