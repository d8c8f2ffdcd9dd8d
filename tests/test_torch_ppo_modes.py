"""PPO's action-space modes of the paper's Fig. 6 on the port
(``cont1``, ``cont2``, ``two_agents``) against the JAX package's.

Weights come from the reference: a reference agent fitted briefly under
its cost model, its ``state_dict()`` loaded into the port's agent of the
same mode.  The pure functions take the same inputs (the Gaussian draw
``eps`` from the reference's key, since ``jax.random`` cannot drive a
``torch.Generator``) and agree within 1e-6; one PPO minibatch step's
loss and every gradient within 1e-5; greedy ``act`` bitwise, with and
without an all-true ``legal``.  The masked pick of the continuous modes
is the port's own rule (the reference has no ``legal``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.neurovec import NeuroVecConfig as JNeuroVecConfig
from repro.core import dataset as jds
from repro.core.agents import make_agent as jmake_agent
from repro.core.agents import ppo as jppo
from repro.core.env import CostModelEnv as JCostModelEnv
from repro_torch.artifacts import load_agent, save_agent
from repro_torch.configs.neurovec import NeuroVecConfig
from repro_torch.core import dataset
from repro_torch.core.agents import make_agent, ppo
from repro_torch.core.agents.ppo import MODES, PPOAgent
from repro_torch.core.env import CostModelEnv

KW = dict(train_batch=64, sgd_minibatch=32, ppo_epochs=2)
NV, JNV = NeuroVecConfig(**KW), JNeuroVecConfig(**KW)
CORPUS, JCORPUS = dataset.generate(24, seed=7), jds.generate(24, seed=7)
HELDOUT, JHELDOUT = dataset.generate(16, seed=8), jds.generate(16, seed=8)
NEW_MODES = ("cont1", "cont2", "two_agents")


@pytest.fixture(scope="module")
def ref_agents():
    """A reference agent of each mode, fitted on the corpus."""
    env = JCostModelEnv(JNV)
    return {m: jmake_agent("ppo", JNV, seed=0, mode=m).fit(
        JCORPUS, env, total_steps=128) for m in NEW_MODES}


def carried(mode, ref_agents):
    return PPOAgent(NV, mode=mode, device="cpu").load_state(
        ref_agents[mode].state_dict())


def _np(x):
    return np.asarray(x, np.float64)


def test_modes_are_all_four():
    assert MODES == ("discrete", "cont1", "cont2", "two_agents")
    with pytest.raises(ValueError, match="mode"):
        PPOAgent(NV, mode="cont3", device="cpu")


@pytest.mark.parametrize("mode", NEW_MODES)
def test_agent_init_shapes_are_the_references(mode, ref_agents):
    port = PPOAgent(NV, mode=mode, device="cpu")
    ref = ref_agents[mode]
    got = [tuple(t.shape) for t in ppo._leaves(port.params)]
    want = [tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(ref.params)]
    assert got == want


@pytest.mark.parametrize("mode", NEW_MODES)
def test_policy_forward_within_1e6(mode, ref_agents):
    ref = ref_agents[mode]
    port = carried(mode, ref_agents)
    jctx, jmask, jvs = ref.feats(JHELDOUT)
    out_j, v_j = jppo.policy_forward(ref.params, JNV, ref.head_sizes, jctx,
                                     jmask, jvs, mode)
    ctx, mask, vs = port.feats(HELDOUT)
    out_p, v_p = ppo.policy_forward(port.params, port.head_sizes, ctx, mask,
                                    vs, mode)
    np.testing.assert_allclose(_np(v_p), _np(v_j), atol=1e-6, rtol=0)
    if mode == "two_agents":
        for a, b in zip(out_p, out_j):
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-6, rtol=0)
    else:
        assert out_p.shape == (len(HELDOUT), 2 if mode == "cont1" else 6)
        np.testing.assert_allclose(_np(out_p), _np(out_j), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("mode", ["cont1", "cont2"])
def test_cont_decode_sample_and_logp_match(mode, ref_agents):
    ref = ref_agents[mode]
    port = carried(mode, ref_agents)
    jctx, jmask, jvs = ref.feats(JHELDOUT)
    out_j, _ = jppo.policy_forward(ref.params, JNV, ref.head_sizes, jctx,
                                   jmask, jvs, mode)
    out = torch.as_tensor(np.array(out_j))
    vs = torch.as_tensor(np.array(jvs), dtype=torch.long)
    n = 1 if mode == "cont1" else 3
    # the decode, at the mean and over a wide spread of raw values
    rng = np.random.default_rng(0)
    for raw in (np.asarray(out_j)[:, :n],
                rng.normal(0, 3, (len(HELDOUT), n)).astype(np.float32)):
        want = np.asarray(jppo._cont_decode(JNV, ref.head_sizes,
                                            jnp.asarray(raw), jvs, mode))
        got = ppo._cont_decode(torch.as_tensor(raw), vs, mode).numpy()
        np.testing.assert_array_equal(got, want)
    # a draw with the reference's eps
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, (len(HELDOUT), n)))
    raw_j, logp_j, ent_j = jppo.sample_continuous(key, out_j, jvs, mode)
    raw_p, logp_p, ent_p = ppo.sample_continuous(out, vs, mode,
                                                 torch.as_tensor(eps))
    for a, b in ((raw_p, raw_j), (logp_p, logp_j), (ent_p, ent_j)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6, rtol=0)
    lp_j, e_j = jppo.logp_continuous(out_j, raw_j, mode, 3)
    lp_p, e_p = ppo.logp_continuous(out, torch.as_tensor(np.asarray(raw_j)),
                                    mode, 3)
    np.testing.assert_allclose(_np(lp_p), _np(lp_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(e_p), _np(e_j), atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode", NEW_MODES)
def test_one_minibatch_step_loss_and_gradients_within_1e5(mode, ref_agents):
    """The PPO loss of one minibatch and its gradient leaf by leaf, from
    the same parameters and the same sampled minibatch."""
    ref = ref_agents[mode]
    port = carried(mode, ref_agents)
    jfeats = ref.feats(JHELDOUT)
    a, raw, logp, _ = ref.sample_actions(JHELDOUT, feats=jfeats)
    rewards = np.random.default_rng(1).normal(size=len(HELDOUT)).astype(
        np.float32)
    (loss_j, _), g_j = jax.value_and_grad(ref._loss_fn, has_aux=True)(
        ref.params, *jfeats, jnp.asarray(a), jnp.asarray(raw),
        jnp.asarray(logp), jnp.asarray(rewards))
    ctx, mask, vs = port.feats(HELDOUT)
    leaves = ppo._leaves(port.params)
    for p in leaves:
        p.requires_grad_(True)
    loss_p = port._loss(ctx, mask, vs, torch.as_tensor(a).long(),
                        torch.as_tensor(np.asarray(raw)),
                        torch.as_tensor(np.asarray(logp)),
                        torch.as_tensor(rewards))
    g_p = torch.autograd.grad(loss_p, leaves)
    assert abs(float(loss_p.detach()) - float(loss_j)) < 1e-5
    want = jax.tree_util.tree_leaves(g_j)
    assert len(want) == len(g_p)
    for gp, gj in zip(g_p, want):
        np.testing.assert_allclose(_np(gp), _np(gj), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", NEW_MODES)
def test_greedy_act_is_the_references_bitwise(mode, ref_agents):
    port = carried(mode, ref_agents)
    want = np.asarray(ref_agents[mode].act(JHELDOUT, sample=False))
    got = port.act(HELDOUT)
    np.testing.assert_array_equal(got, want)
    every = np.ones(CostModelEnv(NV).cost_grid(HELDOUT).shape, bool)
    np.testing.assert_array_equal(port.act(HELDOUT, legal=every), want)


@pytest.mark.parametrize("mode", NEW_MODES)
def test_masked_pick_is_legal_and_raises_without_one(mode, ref_agents):
    port = carried(mode, ref_agents)
    env = CostModelEnv(NV, legality="h100")
    sites = [s for s in HELDOUT if np.isfinite(env.cost_grid([s])).any()]
    greedy = port.act(sites)
    # forbid each site's greedy action and a random half of the rest,
    # keeping one legal action a row
    rng = np.random.default_rng(5)
    grid_ok = np.isfinite(env.cost_grid(sites))
    legal = grid_ok & (rng.random(grid_ok.shape) < 0.5)
    for i, s in enumerate(sites):
        s0, s1, s2 = port.space.valid_sizes(s.kind)
        a = greedy[i]
        g = (a[0] * s1 + a[1]) * s2 + a[2]
        legal[i, g] = False
        if not legal[i, :s0 * s1 * s2].any():
            legal[i, next(f for f in range(s0 * s1 * s2)
                          if f != g and grid_ok[i, f])] = True
    picks = port.act(sites, legal=legal)
    for i, s in enumerate(sites):
        s0, s1, s2 = port.space.valid_sizes(s.kind)
        flat = (picks[i][0] * s1 + picks[i][1]) * s2 + picks[i][2]
        assert legal[i, flat], (s.key(), picks[i])
        assert not np.array_equal(picks[i], greedy[i])
    none = legal.copy()
    none[2] = False
    with pytest.raises(ValueError, match="no legal action"):
        port.act(sites, legal=none)


def test_continuous_masked_pick_is_the_densest_legal_bin_centre(ref_agents):
    """The rule written out for one cont2 row: among the legal flat
    actions the highest Gaussian log-density at the bin centres
    ``logit((a + 0.5) / n)``, head by head."""
    port = carried("cont2", ref_agents)
    site = next(s for s in HELDOUT if s.kind == "matmul")
    sizes = port.space.valid_sizes("matmul")
    ctx, mask, vs = port.feats([site])
    out, _ = ppo.policy_forward(port.params, port.head_sizes, ctx, mask, vs,
                                "cont2")
    mu = out[0, :3].double().detach().numpy()
    logstd = np.clip(out[0, 3:].double().detach().numpy(), -3.0, 1.0)
    dens = {}
    for flat in range(int(np.prod(sizes))):
        a = (flat // (sizes[1] * sizes[2]), (flat // sizes[2]) % sizes[1],
             flat % sizes[2])
        d = 0.0
        for h in range(3):
            u = (a[h] + 0.5) / sizes[h]
            c = np.log(u) - np.log1p(-u)
            d += -0.5 * ((c - mu[h]) / np.exp(logstd[h])) ** 2 - logstd[h]
        dens[flat] = (d, a)
    g = tuple(port.act([site])[0])
    legal = np.ones((1, int(np.prod(sizes))), bool)
    legal[0, (g[0] * sizes[1] + g[1]) * sizes[2] + g[2]] = False
    best = max((f for f in dens if legal[0, f]), key=lambda f: dens[f][0])
    assert tuple(port.act([site], legal=legal)[0]) == dens[best][1]


@pytest.mark.parametrize("mode", MODES)
def test_act_bucketed_equals_act(mode, ref_agents):
    port = (PPOAgent(NV, mode=mode, device="cpu") if mode == "discrete"
            else carried(mode, ref_agents))
    legal = np.isfinite(CostModelEnv(NV, legality="cpu").cost_grid(HELDOUT))
    for kw in ({}, {"legal": legal}):
        want = port.act(HELDOUT, **kw)
        for bucket in (None, len(HELDOUT), 32, 64):
            np.testing.assert_array_equal(
                port.act_bucketed(HELDOUT, bucket=bucket, **kw), want)


@pytest.mark.parametrize("mode", NEW_MODES)
def test_state_round_trips_through_both_artifact_layers(mode, ref_agents,
                                                        tmp_path):
    from repro.artifacts import load_agent as jload_agent
    from repro.artifacts import save_agent as jsave_agent
    ref = ref_agents[mode]
    want = np.asarray(ref.act(JHELDOUT, sample=False))
    jsave_agent(ref, str(tmp_path / "ref"))
    port = load_agent(str(tmp_path / "ref"), cfg=NV, seed=0, device="cpu",
                      mode=mode)
    assert port.mode == mode
    np.testing.assert_array_equal(port.act(HELDOUT), want)
    port.fit(CORPUS, CostModelEnv(NV, legality="tpu_v5e"), total_steps=64)
    save_agent(port, str(tmp_path / "port"))
    back = jload_agent(str(tmp_path / "port"), cfg=JNV, seed=0, mode=mode)
    assert back.mode == mode
    np.testing.assert_array_equal(np.asarray(back.act(JHELDOUT,
                                                      sample=False)),
                                  port.act(HELDOUT))


@pytest.mark.parametrize("mode", NEW_MODES)
def test_mode_mismatch_raises(mode, ref_agents):
    other = "discrete"
    with pytest.raises(ValueError, match="mode"):
        make_agent("ppo", NV, seed=0, mode=other, device="cpu").load_state(
            ref_agents[mode].state_dict())
    with pytest.raises(ValueError, match="mode"):
        PPOAgent(NV, mode=mode, device="cpu").load_state(
            PPOAgent(NV, mode=other, device="cpu").state_dict())


@pytest.mark.parametrize("mode", NEW_MODES)
def test_fit_trains_each_mode_and_keeps_tiles_legal(mode):
    env = CostModelEnv(NV, legality="cpu")
    agent = PPOAgent(NV, mode=mode, device="cpu").fit(CORPUS, env,
                                                      total_steps=128)
    assert len(agent.history) == 2
    assert all(np.isfinite(h["loss"]) for h in agent.history)
    from repro_torch.core.vectorizer import tune
    prog = tune(CORPUS, agent, agent.space, env=env)
    assert set(prog.tiles) == {s.key() for s in CORPUS}
