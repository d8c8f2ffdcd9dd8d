"""The port's seven decision methods against the JAX package's.

The shared agent contract of ``tests/test_api.py:34-72`` runs over all
seven registry names on the port, and each one's greedy actions are held
bitwise against the reference's on the same seeded sites, under
``legality="tpu_v5e"`` (the reference's VMEM rule) and with ``act``
called without ``legal=``, as the reference's ``tune`` calls it.  PPO acts
from the reference's trained state; ``nns`` and ``dtree`` embed with the
reference embedder's params carried across (``jax.random`` cannot be
reproduced by a ``torch.Generator``).  The decision tree is held node for
node when fitted on the reference's own embeddings, and the two embedders
to 1e-5.  Under the card's rule (``legality="h100"``) each method picks
only tiles the kernels launch.
"""
import numpy as np
import pytest

from repro.configs.neurovec import NeuroVecConfig as JNeuroVecConfig
from repro.core import dataset as jds
from repro.core import embedding as jemb
from repro.core.agents import default_embed_fn as jdefault_embed_fn
from repro.core.agents import make_agent as jmake_agent
from repro.core.agents import polly as jpolly
from repro.core.agents.dtree import _node_to_dict as j_node_to_dict
from repro.core.env import CostModelEnv as JCostModelEnv
from repro_torch import convert
from repro_torch.artifacts import agent_fingerprint, load_agent, save_agent
from repro_torch.configs.neurovec import NeuroVecConfig
from repro_torch.core import dataset
from repro_torch.core.agents import (AGENT_NAMES, embed_fn_from_params,
                                     make_agent)
from repro_torch.core.agents import polly
from repro_torch.core.agents.dtree import _node_to_dict
from repro_torch.core.env import CostModelEnv, set_strict_actions
from repro_torch.core.protocols import Agent
from repro_torch.core.vectorizer import tune
from repro_torch.kernels import ops

KW = dict(train_batch=64, sgd_minibatch=32, ppo_epochs=2)
NV, JNV = NeuroVecConfig(**KW), JNeuroVecConfig(**KW)
ENV = CostModelEnv(NV, legality="tpu_v5e")
JENV = JCostModelEnv(JNV)
CORPUS, JCORPUS = dataset.generate(24, seed=7), jds.generate(24, seed=7)
HELDOUT, JHELDOUT = dataset.generate(12, seed=8), jds.generate(12, seed=8)
FIT_KW = {"ppo": {"total_steps": 128}}


def _ref_embedder_params(seed=0):
    import jax
    p = jemb.embedder_init(jax.random.PRNGKey(seed))
    return {k: np.asarray(v) for k, v in p.items()}


def carried_embed_fn(seed=0):
    """The port's embed_fn on the reference embedder's params."""
    return embed_fn_from_params(convert.embedder_from_jax(
        _ref_embedder_params(seed), device="cpu"))


def port_agent(name, seed=0):
    kw = {"embed_fn": carried_embed_fn(seed)} if name in ("nns",
                                                          "dtree") else {}
    return make_agent(name, NV, seed=seed, device="cpu", **kw)


@pytest.fixture(scope="module")
def ref_fitted():
    """Each reference agent fitted on the corpus under its cost model."""
    return {n: jmake_agent(n, JNV, seed=0).fit(JCORPUS, JENV,
                                               **FIT_KW.get(n, {}))
            for n in AGENT_NAMES}


def _port_fitted(name, ref_fitted):
    agent = port_agent(name)
    if name == "ppo":       # the reference's trained policy, carried over
        return agent.load_state(ref_fitted["ppo"].state_dict())
    return agent.fit(CORPUS, ENV)


def _same_sites():
    assert [s.key() for s in CORPUS] == [s.key() for s in JCORPUS]
    assert [s.key() for s in HELDOUT] == [s.key() for s in JHELDOUT]


@pytest.mark.parametrize("name", AGENT_NAMES)
def test_agent_contract(name, ref_fitted, tmp_path):
    """``tests/test_api.py``'s shared contract on the port, with the
    reference's greedy actions, bitwise."""
    _same_sites()
    agent = _port_fitted(name, ref_fitted)
    assert isinstance(agent, Agent)
    assert agent.name == name
    a1 = np.asarray(agent.act(HELDOUT, sample=False))
    assert a1.shape == (len(HELDOUT), 3)
    assert np.issubdtype(a1.dtype, np.integer)
    for s, a in zip(HELDOUT, a1):
        for d, n in enumerate(ENV.space.valid_sizes(s.kind)):
            assert 0 <= a[d] < n, (name, s.kind, d, a)
    np.testing.assert_array_equal(a1, agent.act(HELDOUT, sample=False))
    # the reference's greedy actions, bitwise
    ja = np.asarray(ref_fitted[name].act(JHELDOUT, sample=False))
    np.testing.assert_array_equal(a1, ja)
    set_strict_actions(True)
    try:
        sp = ENV.speedups_batch(HELDOUT, a1)
    finally:
        set_strict_actions(False)
    assert sp.shape == (len(HELDOUT),) and (sp > 0).all()
    assert np.asarray(agent.act(HELDOUT, sample=True)).shape == \
        (len(HELDOUT), 3)
    # save -> load -> act is bitwise; the fingerprint is stable
    art = str(tmp_path / "agent")
    fp = save_agent(agent, art)
    kw = {"embed_fn": carried_embed_fn()} if name in ("nns", "dtree") else {}
    loaded = load_agent(art, cfg=NV, seed=0, device="cpu", **kw)
    if name == "brute":
        loaded.oracle = ENV
    np.testing.assert_array_equal(a1, loaded.act(HELDOUT, sample=False))
    assert agent_fingerprint(loaded) == fp == agent_fingerprint(agent)


def test_make_agent_registry_smoke():
    for name in AGENT_NAMES:
        agent = make_agent(name, NV, seed=0, device="cpu")
        assert isinstance(agent, Agent) and agent.name == name
    with pytest.raises(ValueError, match="unknown agent"):
        make_agent("definitely-not-an-agent", NV)


@pytest.mark.parametrize("name", [n for n in AGENT_NAMES if n != "ppo"])
def test_fingerprint_equals_the_references(name, ref_fitted):
    """The reference agent's state loaded into the port fingerprints as
    the reference's does (PPO's state carries the reference's
    ``rng_key``, which the port drops: it is held by a cross-load)."""
    from repro.artifacts import agent_fingerprint as jagent_fingerprint
    ref = ref_fitted[name]
    agent = port_agent(name).load_state(ref.state_dict())
    assert agent_fingerprint(agent) == jagent_fingerprint(ref)


@pytest.mark.parametrize("name", AGENT_NAMES)
def test_reference_artifact_loads_into_the_port(name, ref_fitted, tmp_path):
    """A reference ``save_agent`` artifact loads through the port's
    ``load_agent`` and acts as the reference agent does."""
    from repro.artifacts import save_agent as jsave_agent
    art = str(tmp_path / "ref")
    jsave_agent(ref_fitted[name], art)
    kw = {"embed_fn": carried_embed_fn()} if name in ("nns", "dtree") else {}
    agent = load_agent(art, cfg=NV, seed=0, device="cpu", **kw)
    if name == "brute":
        agent.oracle = ENV
    np.testing.assert_array_equal(
        agent.act(HELDOUT, sample=False),
        ref_fitted[name].act(JHELDOUT, sample=False))


def test_embedders_agree():
    """The port's embedder on the carried params against the reference's
    ``default_embed_fn`` at the same seed, to 1e-5."""
    sites, jsites = dataset.generate(64, seed=3), jds.generate(64, seed=3)
    np.testing.assert_allclose(carried_embed_fn(0)(sites),
                               jdefault_embed_fn(0)(jsites), atol=1e-5)


def test_ppo_code_vectors_are_the_references(ref_fitted):
    """The trained policy's embedder (the paper's frozen-after-RL
    ``embed_fn``) from the reference's state, to 1e-5."""
    agent = port_agent("ppo").load_state(ref_fitted["ppo"].state_dict())
    np.testing.assert_allclose(agent.code_vectors(HELDOUT),
                               ref_fitted["ppo"].code_vectors(JHELDOUT),
                               atol=1e-5)


def test_default_embed_fn_is_seeded_torch():
    """The port's own default embedder: deterministic at a seed, another
    stream at another seed (not the reference's: see its docstring)."""
    from repro_torch.core.agents import default_embed_fn
    a = default_embed_fn(0, device="cpu")(HELDOUT)
    assert a.shape == (len(HELDOUT), 340) and a.dtype == np.float32
    np.testing.assert_array_equal(a, default_embed_fn(0, "cpu")(HELDOUT))
    assert not np.array_equal(a, default_embed_fn(1, "cpu")(HELDOUT))


def test_dtree_equals_the_references_node_for_node():
    """On the reference's numpy embeddings the port grows the reference's
    tree: same features, thresholds and labels at every node."""
    x = jdefault_embed_fn(0)(JCORPUS)
    ref = jmake_agent("dtree", JNV, seed=0).fit(JCORPUS, JENV)
    port = make_agent("dtree", NV, seed=0, device="cpu",
                      embed_fn=lambda sites: x).fit(CORPUS, ENV)

    def strip(d):
        out = {k: d[k] for k in ("f", "t", "label")}
        for side in ("left", "right"):
            if side in d:
                out[side] = strip(d[side])
        return out
    assert set(port.trees) == set(ref.trees)
    for kind in ref.trees:
        assert strip(_node_to_dict(port.trees[kind])) == \
            j_node_to_dict(ref.trees[kind])
        # each node's majority label heads its ranking
        node = port.trees[kind]
        assert node.ranked[0] == node.label


def test_polly_grid_matches_scalar_walk():
    """The vectorized mem-only grid's argmin is the scalar walk's, and
    both are the reference's."""
    space = ENV.space
    sites = dataset.generate(40, seed=11)
    jsites = jds.generate(40, seed=11)
    acts = make_agent("polly", NV).act(sites)
    for s, js, a in zip(sites, jsites, acts):
        np.testing.assert_array_equal(a, polly._polly_action_ref(space, s))
        np.testing.assert_array_equal(
            a, jpolly._polly_action_ref(JENV.space, js))
    for kind in ("matmul", "attention", "chunk_scan"):
        sub = [s for s in sites if s.kind == kind]
        jsub = [s for s in jsites if s.kind == kind]
        if sub:
            np.testing.assert_array_equal(
                polly.mem_only_grid_kind(space, sub, kind),
                jpolly.mem_only_grid_kind(JENV.space, jsub, kind))


def test_random_draw_is_seeded_and_the_references():
    a = make_agent("random", NV, seed=5)
    j = jmake_agent("random", JNV, seed=5)
    np.testing.assert_array_equal(a.act(HELDOUT), j.act(JHELDOUT))
    np.testing.assert_array_equal(a.act(HELDOUT), a.act(HELDOUT))
    assert not np.array_equal(a.act(HELDOUT),
                              make_agent("random", NV, seed=6).act(HELDOUT))
    # the exploration stream advances
    s1, s2 = a.act(HELDOUT, sample=True), a.act(HELDOUT, sample=True)
    assert s1.shape == s2.shape == (len(HELDOUT), 3)


@pytest.fixture(scope="module")
def h100_case():
    """The corpus of the main-path loop, half of it sites the kernels
    refuse, and bf16 sites the kernels launch, under the card's rule."""
    env = CostModelEnv(NV, legality="h100")
    corpus = dataset.generate(200, seed=0)
    legal = np.isfinite(env.cost_grid(corpus))
    sites = [s for s, row in zip(corpus, legal) if row.any()][:40]
    return env, corpus, sites


@pytest.mark.parametrize("name", AGENT_NAMES)
def test_every_method_tunes_to_launchable_tiles(name, h100_case):
    """Under ``legality="h100"``, ``tune`` passes the legal mask and every
    method's program holds only tiles ``ops.tile_ok`` admits."""
    env, corpus, sites = h100_case
    agent = make_agent(name, NV, seed=0, device="cpu")
    fit_kw = {"total_steps": 128} if name == "ppo" else {}
    agent.fit(corpus, env, **fit_kw)
    if name == "baseline":
        # the heuristic has no other pick: keep the sites where it is legal
        base = np.isfinite(env.baseline_costs(sites))
        sites = [s for s, ok in zip(sites, base) if ok]
    prog = tune(sites, agent, env.space, env)
    bad = [s.key() for s in sites if not ops.tile_ok(s, prog.tiles[s.key()])]
    assert not bad


def test_masked_picks_follow_each_methods_rule():
    """With a mask, polly takes its argmin over the legal set, random
    keeps its draw where legal, nns the nearest neighbour with a legal
    label, dtree the most frequent legal label of the leaf; an all-illegal
    site raises."""
    env = ENV
    sites = HELDOUT
    grid = env.cost_grid(sites)
    legal = np.isfinite(grid)
    legal[:, 0] = False                     # take action 0 away everywhere
    p = make_agent("polly", NV)
    pick = p.act(sites, legal=legal)
    for i, s in enumerate(sites):
        g = polly.mem_only_grid_kind(env.space, [s], s.kind)[0]
        ok = legal[i, :len(g)]
        want = int(np.argmin(np.where(ok, g, polly._ILLEGAL)))
        if g[want] == polly._ILLEGAL or not ok[want]:
            want = int(np.argmax(ok))
        assert tuple(pick[i]) == env.space.unflatten(s.kind, want)
    r = make_agent("random", NV, seed=2)
    free = r.act(sites)
    masked = r.act(sites, legal=np.ones_like(legal))
    np.testing.assert_array_equal(free, masked)     # all legal: unchanged
    for name in ("random", "polly", "nns", "dtree"):
        agent = port_agent(name).fit(CORPUS, env)
        acts = agent.act(sites, legal=legal)
        for i, s in enumerate(sites):
            _, s1, s2 = env.space.valid_sizes(s.kind)
            a = acts[i]
            assert legal[i, (a[0] * s1 + a[1]) * s2 + a[2]], (name, i)
        none = legal.copy()
        none[0] = False
        with pytest.raises(ValueError, match="legal"):
            agent.act(sites, legal=none)


def test_nns_masked_pick_is_the_nearest_legal_neighbour():
    agent = port_agent("nns").fit(CORPUS, ENV)
    legal = np.isfinite(ENV.cost_grid(HELDOUT))
    legal[:, ::2] = False
    lab, keep = agent.labels, []
    for i, s in enumerate(HELDOUT):
        _, s1, s2 = ENV.space.valid_sizes(s.kind)
        flat = (lab[:, 0] * s1 + lab[:, 1]) * s2 + lab[:, 2]
        ok = (agent.train_kinds == s.kind) & legal[i, np.minimum(
            flat, legal.shape[1] - 1)]
        if ok.any():
            keep.append((i, ok))
    assert keep
    sites = [HELDOUT[i] for i, _ in keep]
    acts = agent.act(sites, legal=legal[[i for i, _ in keep]])
    sims = agent._norm(agent.embed_fn(sites)) @ agent.keys.T
    for j, (_, ok) in enumerate(keep):
        want = lab[int(np.argmax(np.where(ok, sims[j], -np.inf)))]
        np.testing.assert_array_equal(acts[j], want)
