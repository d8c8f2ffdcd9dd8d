"""The port's synthetic corpus (``core/dataset.py``) and its brute-force
and baseline agents against the JAX package's.

The corpus draws only from Python's ``random``, so for the same seed and
base the port's site keys are bitwise the reference's.  Brute-force labels
and costs are held bitwise under ``legality="tpu_v5e"`` (the reference's
VMEM rule: both packages evaluate the same float64 NumPy expressions in
the same order); the agents' greedy actions are equal, and survive a
``state_dict`` round trip.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs.neurovec import DEFAULT as JNV
from repro.core import dataset as jds
from repro.core.agents import baseline as jbaseline
from repro.core.agents import brute as jbrute
from repro.core.env import CostModelEnv as JCostModelEnv
from repro.core.extractor import extract_arch_sites as jextract_arch_sites
from repro_torch.configs.neurovec import DEFAULT
from repro_torch.core import dataset
from repro_torch.core.agents import (AGENT_NAMES, BaselineHeuristicAgent,
                                     BruteForceAgent, PPOAgent,
                                     brute_force_action, brute_force_costs,
                                     brute_force_labels, make_agent,
                                     n_evaluations)
from repro_torch.core.env import ActionSpace, CostModelEnv
from repro_torch.core.extractor import extract_arch_sites
from repro_torch.core.vectorizer import tune


def _keys(sites):
    return [s.key() for s in sites]


def _fields(sites):
    return [dataclasses.astuple(s) for s in sites]


@pytest.fixture(scope="module")
def stablelm_base():
    """The reference test's base: stablelm_3b's sites at batch 4, seq 512,
    extracted by each package."""
    jsites = jextract_arch_sites("stablelm_3b", batch=4, seq=512)
    tsites = extract_arch_sites("stablelm_3b", batch=4, seq=512)
    assert _keys(tsites) == _keys(jsites)
    return jsites, tsites


@pytest.fixture(scope="module")
def corpora(stablelm_base):
    jbase, tbase = stablelm_base
    return ((jds.generate(400, seed=0, base=jbase)
             + jds.generate(600, seed=7)),
            dataset.generate(400, seed=0, base=tbase)
            + dataset.generate(600, seed=7))


def test_generate_with_the_stablelm_base_is_the_reference(stablelm_base):
    jbase, tbase = stablelm_base
    j = jds.generate(400, seed=0, base=jbase)
    t = dataset.generate(400, seed=0, base=tbase)
    assert _keys(t) == _keys(j) and _fields(t) == _fields(j)
    assert len(t) == 400 and any(s.site.endswith(".v") for s in t)


@pytest.mark.parametrize("n,seed", [(600, 7), (40, 8), (250, 23)])
def test_generate_without_a_base_is_the_reference(n, seed):
    j, t = jds.generate(n, seed=seed), dataset.generate(n, seed=seed)
    assert _keys(t) == _keys(j) and _fields(t) == _fields(j)


def test_split_is_the_reference():
    j, t = jds.generate(600, seed=7), dataset.generate(600, seed=7)
    for frac, seed in ((0.2, 0), (0.5, 3)):
        (jtr, jte), (ttr, tte) = jds.split(j, frac, seed), dataset.split(
            t, frac, seed)
        assert _keys(ttr) == _keys(jtr) and _keys(tte) == _keys(jte)


@pytest.mark.parametrize("suite", ["twelve_benchmarks", "polybench",
                                   "mibench"])
def test_held_out_suites_are_the_reference(suite):
    j, t = getattr(jds, suite)(), getattr(dataset, suite)()
    assert [w.name for w in t] == [w.name for w in j]
    assert [w.fixed_frac for w in t] == [w.fixed_frac for w in j]
    assert [_keys(w.sites) for w in t] == [_keys(w.sites) for w in j]


def test_arch_sites_are_the_references_for_the_ported_archs():
    """``arch_sites`` walks the reference's list cut to the ported archs:
    its keys are the reference extractor's for those archs, in order."""
    want = [k for arch in ("qwen3_8b", "stablelm_3b", "xlstm_1_3b")
            for k in _keys(jextract_arch_sites(arch))]
    assert _keys(dataset.arch_sites()) == want


# ---------------------------------------------------------------------------
# brute force and the baseline heuristic
# ---------------------------------------------------------------------------

def _envs():
    return JCostModelEnv(JNV), CostModelEnv(DEFAULT, legality="tpu_v5e")


def test_brute_force_labels_and_costs_are_the_reference(corpora):
    jsites, tsites = corpora
    jenv, tenv = _envs()
    jl = jbrute.brute_force_labels(jenv, jsites)
    tl = brute_force_labels(tenv, tsites)
    assert tl.dtype == jl.dtype and np.array_equal(tl, jl)
    jc = jbrute.brute_force_costs(jenv, jsites)
    tc = brute_force_costs(tenv, tsites)
    assert np.array_equal(tc, jc)
    assert n_evaluations(tenv, tsites) == jbrute.n_evaluations(jenv, jsites)
    for j, t in list(zip(jsites, tsites))[::97]:
        ja, jcost = jbrute.brute_force_action(jenv, j)
        ta, tcost = brute_force_action(tenv, t)
        assert tuple(ta) == tuple(ja) and tcost == jcost


def test_brute_force_agent_acts_as_the_reference(corpora):
    jsites, tsites = corpora
    jenv, tenv = _envs()
    ja = jbrute.BruteForceAgent().fit(jsites, jenv).act(jsites)
    agent = BruteForceAgent().fit(tsites, tenv)
    ta = agent.act(tsites)
    assert ta.dtype == np.int64 and np.array_equal(ta, ja)
    state = agent.state_dict()
    assert state == jbrute.BruteForceAgent().state_dict()
    again = BruteForceAgent(oracle=tenv).load_state(state)
    assert np.array_equal(again.act(tsites), ta)
    with pytest.raises(ValueError, match="baseline"):
        again.load_state({"version": state["version"], "name": "baseline"})


def test_baseline_agent_acts_as_the_reference(corpora):
    jsites, tsites = corpora
    jenv, tenv = _envs()
    ja = jbaseline.BaselineHeuristicAgent().fit(jsites, jenv).act(jsites)
    agent = BaselineHeuristicAgent().fit(tsites, tenv)
    ta = agent.act(tsites)
    assert np.array_equal(ta, ja)
    state = agent.state_dict()
    again = BaselineHeuristicAgent(ActionSpace(DEFAULT)).load_state(state)
    assert np.array_equal(again.act(tsites), ta)
    with pytest.raises(ValueError, match="brute"):
        again.load_state({"version": state["version"], "name": "brute"})
    with pytest.raises(RuntimeError, match="before fit"):
        BaselineHeuristicAgent().act(tsites)


def test_make_agent_knows_the_ported_three():
    assert isinstance(make_agent("ppo", device="cpu"), PPOAgent)
    assert isinstance(make_agent("brute"), BruteForceAgent)
    base = make_agent("baseline")
    assert isinstance(base, BaselineHeuristicAgent) and base.space is not None
    for name in ("dtree", "nns", "polly", "random"):
        assert name in AGENT_NAMES
        with pytest.raises(NotImplementedError,
                           match="dtree, nns, random, polly"):
            make_agent(name)
    with pytest.raises(ValueError, match="unknown agent"):
        make_agent("llvm")


def test_brute_force_tunes_over_the_legal_tiles(stablelm_base):
    """Under the card's rule brute force picks the legal argmin of the
    cost grid at every StableLM-3B site; the baseline agent's tiles are
    legal there too."""
    _, sites = stablelm_base
    env = CostModelEnv(DEFAULT, legality="h100")
    grid = env.cost_grid(sites)
    prog = tune(sites, BruteForceAgent(oracle=env), env.space, env)
    for s, row in zip(sites, grid):
        tiles = prog.tiles[s.key()]
        assert env.tiles_costs([s], [tiles[:3]])[0] == row.min()
    base = tune(sites, make_agent("baseline"), env.space, env)
    assert all(np.isfinite(env.tiles_costs([s], [base.tiles[s.key()][:3]]))
               for s in sites)
