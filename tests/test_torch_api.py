"""The port's facade (``repro_torch.api.NeuroVectorizer``) on the CPU:
the facade tests of ``tests/test_api.py:331-411`` carried over, the
reference and port facades giving the same ``TileProgram`` with ``brute``
and ``polly``, every option without a port layer raising
``NotImplementedError`` and the transport options reaching their
transports, and the port's quickstart at small steps.

On the CPU the facade runs with ``device="cpu"`` (its kernels' plain
versions); its default oracle prices tiles under the Hopper kernels'
launch rule (``legality="h100"``).
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.api import (AGENT_NAMES, Agent, CostModelEnv, MeasuredEnv,
                             NeuroVecConfig, NeuroVectorizer, Oracle,
                             TileProgram, make_agent)
from repro_torch.core import dataset
from repro_torch.kernels import ops
from repro_torch.models import compute
from repro_torch.models.compute import KernelSite

ROOT = pathlib.Path(__file__).resolve().parents[1]
NV = NeuroVecConfig(train_batch=64, sgd_minibatch=32, ppo_epochs=2)
CPU = {"device": "cpu"}
LATER = "queue 1 item 3"


def launchable(n, seed):
    """``n`` corpus sites with a baseline and a tile the kernels launch."""
    env = CostModelEnv(NV)
    sites = dataset.generate(4 * n, seed=seed)
    ok = np.isfinite(env.cost_grid(sites)).any(1) & \
        np.isfinite(env.baseline_costs(sites))
    return [s for s, k in zip(sites, ok) if k][:n]


def test_protocols_are_runtime_checkable():
    assert isinstance(CostModelEnv(NV), Oracle)
    assert isinstance(MeasuredEnv(NV), Oracle)
    for name in AGENT_NAMES:
        assert isinstance(make_agent(name, NV, **CPU), Agent)
    assert not isinstance(object(), Agent)


def test_facade_fit_tune_inject_speedup():
    nv = NeuroVectorizer(NV, agent="brute", seed=0, **CPU)
    sites = launchable(10, seed=9)
    prog = nv.fit(sites).tune_sites(sites)
    assert set(prog.tiles) == {s.key() for s in sites}
    assert all(ops.tile_ok(s, prog.tiles[s.key()]) for s in sites)
    assert nv.speedup(prog, sites) >= 1.0          # brute >= baseline
    assert nv.health() == "ok"

    def step(x, w):
        return compute.matmul(x, w, site="facade.mm")

    meta = (torch.empty((64, 96), dtype=torch.bfloat16, device="meta"),
            torch.empty((96, 128), dtype=torch.bfloat16, device="meta"))
    prog2 = nv.tune(step, meta)
    assert list(prog2.tiles) == ["matmul:facade.mm:m64n128k96b1:bfloat16:"
                                 "nn:f0"]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((64, 96), generator=gen).bfloat16()
    w = torch.randn((96, 128), generator=gen).bfloat16()
    y_ref = step(x, w)
    with nv.inject(prog2):
        y_tuned = step(x, w)
    # bf16 outputs of the same f32-accumulated sums, two summation orders
    rel = float((y_tuned.float() - y_ref.float()).abs().max()
                / y_ref.float().abs().max())
    assert rel < 2e-2
    nv.close()


def test_facade_tune_arch_and_baseline():
    nv = NeuroVectorizer(NV, agent="baseline", **CPU)
    prog = nv.tune_arch("stablelm_3b", batch=2, seq=128)
    assert prog.tiles and nv.agent_inferences == len(prog.tiles)
    sites = launchable(6, seed=3)
    base = nv.baseline(sites)
    assert nv.speedup(base, sites) == pytest.approx(1.0)
    nv.close()


def test_facade_accepts_prebuilt_agent_and_oracle():
    agent = make_agent("polly", NV)
    oracle = MeasuredEnv(NV)
    nv = NeuroVectorizer(NV, agent=agent, oracle=oracle, **CPU)
    assert nv.agent is agent and nv.oracle is oracle
    sites = launchable(5, seed=10)
    assert len(nv.fit(sites).tune_sites(sites).tiles) == 5


def test_facade_measured_oracle_string(tmp_path):
    from repro_torch.measure import CachedMeasureFn
    cfg = NeuroVecConfig(bm_choices=(16, 32), bn_choices=(128,),
                         bk_choices=(128,), bq_choices=(64,),
                         bkv_choices=(128,), chunk_choices=(32,))
    nv = NeuroVectorizer(cfg, agent="brute", oracle="measured",
                         db_path=str(tmp_path / "m.jsonl"),
                         oracle_kwargs=dict(reps=1, warmup=1), **CPU)
    assert isinstance(nv.oracle, MeasuredEnv)
    assert isinstance(nv.oracle.measure_fn, CachedMeasureFn)
    assert nv.oracle.measure_fn.runner.device.type == "cpu"
    sites = [KernelSite(site="f.mm", kind="matmul", m=32, n=128, k=128)]
    prog = nv.fit(sites).tune_sites(sites)
    assert len(prog.tiles) == 1
    assert nv.oracle.measure_fn.runner.timed_pairs > 0
    assert nv.health() == "ok"
    nv.close()
    assert nv.health() == "degraded"        # the transport is down
    with pytest.raises(ValueError, match="unknown oracle"):
        NeuroVectorizer(cfg, oracle="wat", **CPU)
    with pytest.raises(ValueError, match="oracle='measured'"):
        NeuroVectorizer(cfg, oracle="model", db_path="x", **CPU)


def test_facade_needs_the_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NeuroVectorizer(NV, agent="polly")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_agent("nns", NV)


FLEET = "fleet://{artifacts}"


@pytest.mark.parametrize("kw", [
    {"oracle": "surrogate"},
    {"oracle": "measured", "surrogate": "ckpt/"},
    {"oracle": "measured", "prune_topk": 4},
    {"oracle": "measured", "transport": "pool"},
    {"oracle": "measured", "transport": "socket"},
    {"oracle": "measured", "workers": 2},
    {"oracle": "measured", "hosts": ["localhost:7000"]},
    {"oracle": "measured", "db_path": FLEET},
    {"program_store": FLEET},
], ids=lambda kw: ",".join(kw))
def test_unported_options_raise(kw, tmp_path):
    """The surrogate and grid pruning are not ported and raise.  The
    transport options are: a pool of workers, and a ``fleet://`` DB or
    store against a live ``serve-artifacts``; where the reference raises
    for a combination (a socket fleet without hosts, ``workers=`` or
    ``hosts=`` with the in-process transport), the port raises the same
    class."""
    from repro.api import NeuroVectorizer as JNeuroVectorizer
    from repro_torch.fleet import (ArtifactServer, RemoteMeasureDB,
                                   RemoteProgramStore)
    from repro_torch.measure import WorkerPoolTransport
    if "surrogate" in kw.values() or {"surrogate", "prune_topk"} & set(kw):
        with pytest.raises(NotImplementedError, match=LATER):
            NeuroVectorizer(NV, agent="polly", **kw, **CPU)
        return
    if "workers" in kw or "hosts" in kw or kw.get("transport") == "socket":
        with pytest.raises(ValueError):
            NeuroVectorizer(NV, agent="polly", **kw, **CPU)
        with pytest.raises(ValueError):
            JNeuroVectorizer(agent="polly", **kw)
        return
    with ArtifactServer(measure_db=str(tmp_path / "m.jsonl"),
                        program_store=str(tmp_path / "p.jsonl")) as art:
        art.start()
        kw = {k: (v.format(artifacts=art.address) if isinstance(v, str)
                  else v) for k, v in kw.items()}
        with NeuroVectorizer(NV, agent="polly", **kw, **CPU) as nv:
            if kw.get("transport") == "pool":
                t = nv.oracle.measure_fn.transport
                assert isinstance(t, WorkerPoolTransport)
                assert t.workers == 2 and t.health() == "ok"
                assert t.runner_kwargs == {"device": "cpu"}
            elif "db_path" in kw:
                assert isinstance(nv.oracle.measure_fn.db, RemoteMeasureDB)
            else:
                assert isinstance(nv.program_store, RemoteProgramStore)
        if kw.get("transport") == "pool":
            assert t.health() == "down"      # close() released the workers


def test_unported_recipe_raises_on_load(tmp_path):
    """A saved recipe naming a surrogate oracle raises on load rather than
    dropping it; one naming a pool (the reference's ``transport="pool"``)
    loads into a pool of that many workers."""
    import json

    from repro_torch.measure import WorkerPoolTransport
    art = tmp_path / "f"
    NeuroVectorizer(NV, agent="polly", **CPU).save(str(art))
    spec = json.loads((art / "facade.json").read_text())
    (art / "facade.json").write_text(json.dumps({**spec,
                                                 "oracle": "surrogate"}))
    with pytest.raises(NotImplementedError, match=LATER):
        NeuroVectorizer.load(str(art), **CPU)
    (art / "facade.json").write_text(json.dumps(
        {**spec, "oracle": "measured", "transport": "pool", "workers": 1,
         "oracle_kwargs": {"reps": 1}}))
    with NeuroVectorizer.load(str(art), **CPU) as nv:
        t = nv.oracle.measure_fn.transport
        assert isinstance(t, WorkerPoolTransport) and t.workers == 1
        assert t.runner_kwargs == {"device": "cpu", "reps": 1}
        assert nv._spec["workers"] == 1


@pytest.mark.parametrize("name", ("brute", "polly"))
def test_reference_and_port_facades_give_the_same_program(name):
    """The same config, sites and seed through both facades: the same
    ``TileProgram`` under the reference's VMEM rule, on corpus sites of
    every kind and both dtypes."""
    from repro.api import NeuroVecConfig as JNeuroVecConfig
    from repro.api import NeuroVectorizer as JNeuroVectorizer
    from repro.api import TileProgram as JTileProgram
    from repro.core import dataset as jds
    kw = dict(train_batch=64, sgd_minibatch=32, ppo_epochs=2)
    sites, jsites = dataset.generate(60, seed=4), jds.generate(60, seed=4)
    jnv = JNeuroVectorizer(JNeuroVecConfig(**kw), agent=name, seed=0)
    want = jnv.fit(jsites).tune_sites(jsites).tiles
    nv = NeuroVectorizer(NeuroVecConfig(**kw), agent=name, seed=0,
                         oracle=CostModelEnv(NeuroVecConfig(**kw),
                                             legality="tpu_v5e"), **CPU)
    got = nv.fit(sites).tune_sites(sites).tiles
    assert got == want
    assert nv.speedup(TileProgram(got), sites) == pytest.approx(
        jnv.speedup(JTileProgram(want), jsites))


def test_quickstart_runs_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--steps", "500"])
    assert out["sites"] > 0 and out["rel_err"] < mod.DEMO_TOL
    assert np.isfinite(out["speedup"]) and out["speedup"] > 0
