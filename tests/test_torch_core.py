"""The port's core (site keys, TilePrograms, cost model, environment,
embedder, PPO) against the JAX package on the same inputs.

Bitwise: site keys, TileProgram JSON, features, greedy actions from a
loaded agent state.  Cost grids under ``legality="tpu_v5e"``: 1e-9 relative
(both are float64 NumPy in the same evaluation order) with the same ``inf``
positions.  Training only statistically: JAX's and torch's random streams
differ.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.neurovec import NeuroVecConfig as JNeuroVecConfig
from repro.core import costmodel as jcm
from repro.core import costmodel_vec as jcv
from repro.core import dataset
from repro.core import embedding as jemb
from repro.core import vectorizer as jvec
from repro.core.agents import PPOAgent as JPPOAgent
from repro.core.env import CostModelEnv as JCostModelEnv
from repro_torch.configs.neurovec import DEFAULT, NeuroVecConfig
from repro_torch.core import costmodel as tcm
from repro_torch.core import costmodel_vec as tcv
from repro_torch.core import embedding as temb
from repro_torch.core import vectorizer as tvec
from repro_torch.core.agents.ppo import PPOAgent
from repro_torch.core.env import ActionSpace, CostModelEnv
from repro_torch.kernels import ops
from repro_torch.models.compute import KernelSite

NV_SMALL = dict(train_batch=256, sgd_minibatch=64, ppo_epochs=4)
RTOL = 1e-9


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


def _same_costs(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(np.isinf(a), np.isinf(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=0)


# ---------------------------------------------------------------------------
# site keys and tile programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_site_keys_are_byte_identical(seed):
    jsites, tsites = _corpus(200, seed)
    assert [s.key() for s in tsites] == [s.key() for s in jsites]
    assert {s.kind for s in tsites} == {"matmul", "attention", "chunk_scan"}


def test_tileprogram_json_loads_in_both_packages(tmp_path):
    jsites, tsites = _corpus(40, 3)
    jprog = jvec.baseline_program(jsites)
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    jprog.save(str(jpath))
    tprog = tvec.TileProgram.load(str(jpath))
    assert tprog.tiles == jprog.tiles
    tvec.baseline_program(tsites).save(str(tpath))
    assert tpath.read_bytes() == jpath.read_bytes()
    assert jvec.TileProgram.load(str(tpath)).tiles == jprog.tiles


# ---------------------------------------------------------------------------
# cost model under the parity profile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_cost_grid_matches_reference(seed):
    jsites, tsites = _corpus(300, seed)
    jspace = JCostModelEnv(JNeuroVecConfig()).space
    tspace = ActionSpace(DEFAULT)
    _same_costs(tcv.cost_grid(tspace, tsites, "tpu_v5e"),
                jcv.cost_grid(jspace, jsites))


@pytest.mark.parametrize("seed", [0, 7])
def test_costs_for_actions_match_reference(seed):
    jsites, tsites = _corpus(300, seed)
    jspace = JCostModelEnv(JNeuroVecConfig()).space
    acts = np.random.default_rng(seed).integers(0, 7, size=(300, 3))
    acts = np.minimum(acts, [[6, 4, 5]])
    _same_costs(tcv.costs_for_actions(ActionSpace(DEFAULT), tsites, acts,
                                      "tpu_v5e"),
                jcv.costs_for_actions(jspace, jsites, acts))


def test_baseline_costs_match_reference():
    jsites, tsites = _corpus(300, 11)
    _same_costs(tcv.baseline_costs(tsites, "tpu_v5e"),
                jcv.baseline_costs(jsites))
    for js, ts in zip(jsites[:40], tsites[:40]):
        assert tcm.baseline_tiles(ts) == jcm.baseline_tiles(js)
        np.testing.assert_allclose(tcm.baseline_cost(ts, "tpu_v5e"),
                                   jcm.baseline_cost(js), rtol=RTOL)


def test_scalar_costs_match_reference():
    jsites, tsites = _corpus(30, 13)
    jspace = JCostModelEnv(JNeuroVecConfig()).space
    for js, ts in zip(jsites, tsites):
        for flat in range(jspace.n_actions(js.kind)):
            a = jspace.unflatten(js.kind, flat)
            tiles = jspace.tiles(js.kind, a)
            cj = jcm.site_cost(js, tiles)
            ct = tcm.site_cost(ts, tiles, "tpu_v5e")
            assert (cj is None) == (ct is None)
            if cj is not None:
                np.testing.assert_allclose(ct, cj, rtol=RTOL)


def test_env_rewards_and_speedups_match_reference():
    jsites, tsites = _corpus(200, 17)
    acts = np.minimum(np.random.default_rng(1).integers(0, 7, (200, 3)),
                      [[6, 4, 5]])
    jenv = JCostModelEnv(JNeuroVecConfig())
    tenv = CostModelEnv(DEFAULT, legality="tpu_v5e")
    np.testing.assert_array_equal(tenv.rewards_batch(tsites, acts),
                                  jenv.rewards_batch(jsites, acts))
    np.testing.assert_allclose(tenv.speedups_batch(tsites, acts),
                               jenv.speedups_batch(jsites, acts), rtol=RTOL)
    for i in range(0, 200, 25):
        assert tenv.reward(tsites[i], acts[i]) == pytest.approx(
            jenv.reward(jsites[i], acts[i]), rel=1e-7)


def test_program_speedup_matches_reference():
    jsites, tsites = _corpus(60, 19)
    rng = np.random.default_rng(2)
    jspace = JCostModelEnv(JNeuroVecConfig()).space
    tiles = {}
    for s in jsites:
        a = rng.integers(0, 7, 3)
        tiles[s.key()] = jspace.tiles(s.kind, np.minimum(a, [6, 4, 5]))
    got = tvec.program_speedup(tvec.TileProgram(tiles), tsites,
                               CostModelEnv(DEFAULT, legality="tpu_v5e"))
    want = jvec.program_speedup(jvec.TileProgram(tiles), jsites)
    assert got == pytest.approx(want, rel=RTOL)


# ---------------------------------------------------------------------------
# the h100 legality profile
# ---------------------------------------------------------------------------

def test_h100_legality_is_the_kernel_predicate():
    """Under ``legality="h100"`` a tile is priced inf exactly when the
    kernel cannot launch it; the time of a legal tile is the TPU v5e
    formula, unchanged."""
    _, tsites = _corpus(150, 23)
    tsites = [s for s in tsites if s.kind != "chunk_scan"]
    space = ActionSpace(DEFAULT)
    h100 = tcv.cost_grid(space, tsites, "h100")
    v5e = tcv.cost_grid(space, tsites, "tpu_v5e")
    for i, s in enumerate(tsites):
        for flat in range(space.n_actions(s.kind)):
            tiles = space.tiles(s.kind, space.unflatten(s.kind, flat))
            ok = ops.tile_ok(s, tiles)
            assert np.isfinite(h100[i, flat]) == ok
            if ok and np.isfinite(v5e[i, flat]):
                assert h100[i, flat] == v5e[i, flat]
            assert (tcm.site_cost(s, tiles, "h100") is None) == (not ok)


def test_h100_env_penalises_unlaunchable_tiles():
    s = KernelSite("attn.q", "matmul", m=2048, n=4096, k=4096)
    env = CostModelEnv(DEFAULT, legality="h100")
    bad = (DEFAULT.bm_choices.index(256), DEFAULT.bn_choices.index(256), 0)
    assert env.cost(s, bad) is None
    assert env.reward(s, bad) == DEFAULT.fail_penalty
    assert CostModelEnv(DEFAULT, legality="tpu_v5e").cost(s, bad) is not None


def test_baseline_tiles_launch_at_every_serve_site():
    from repro_torch.configs import get_config
    from repro_torch.core.extractor import extract_serve_sites
    from repro_torch.models.lm import build_model
    sites = extract_serve_sites(build_model(get_config("qwen3_8b")), 4, 512,
                                16)
    assert len(sites) == 17
    for s in sites:
        assert ops.tile_ok(s, tcm.baseline_tiles(s)), s.key()
    assert np.isfinite(CostModelEnv(DEFAULT).baseline_costs(sites)).all()


def test_unknown_legality_raises():
    with pytest.raises(ValueError, match="legality"):
        CostModelEnv(DEFAULT, legality="a100")


def test_strict_actions_raise():
    space = ActionSpace(NeuroVecConfig(strict_actions=True))
    with pytest.raises(IndexError):
        space.tiles("attention", (0, 0, 3))
    assert ActionSpace(DEFAULT).tiles("attention", (0, 0, 3)) == (64, 128, 1)


# ---------------------------------------------------------------------------
# embedder and PPO
# ---------------------------------------------------------------------------

def test_featurize_batch_is_bitwise_equal():
    jsites, tsites = _corpus(300, 29)
    cj, mj = jemb.featurize_batch(jsites)
    ct, mt = temb.featurize_batch(tsites)
    assert cj.dtype == ct.dtype and mj.dtype == mt.dtype
    assert np.array_equal(cj, ct) and np.array_equal(mj, mt)


def test_embedding_matches_reference():
    jsites, _ = _corpus(64, 31)
    pj = jemb.embedder_init(jax.random.PRNGKey(0))
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    ctx, mask = jemb.featurize_batch(jsites)
    want = np.asarray(jemb.embed_sites(pj, ctx, mask))
    ct, mt = torch.from_numpy(ctx).long(), torch.from_numpy(mask)
    got = temb.embed_sites(pt, ct, mt).numpy()
    ref = temb.embed_sites_ref(pt, ct, mt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ref, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_agent():
    """A JAX PPO agent trained a little, so its policy is not the init."""
    jsites = dataset.generate(200, seed=37)
    env = JCostModelEnv(JNeuroVecConfig(**NV_SMALL))
    agent = JPPOAgent(JNeuroVecConfig(**NV_SMALL), lr=5e-4, seed=4)
    agent.train(jsites, env, total_steps=768)
    return agent


def test_greedy_actions_match_a_loaded_jax_agent(jax_agent):
    jsites, tsites = _corpus(300, 41)
    state = jax_agent.state_dict()
    port = PPOAgent(NeuroVecConfig(**NV_SMALL), device="cpu")
    port.load_state(state)
    want = jax_agent.act(jsites, sample=False)
    got = port.act(tsites, sample=False)
    assert np.array_equal(got, want)
    assert len({tuple(a) for a in got}) > 1      # not a constant policy
    jp = jvec.tune(jsites, jax_agent, jax_agent.space)
    tp = tvec.tune(tsites, port, port.space)
    assert tp.tiles == jp.tiles


def test_greedy_over_legal_actions(jax_agent):
    """With every action legal, the masked greedy pick is the plain
    argmax; with the cost model's mask, ``tune`` picks only legal tiles."""
    _, tsites = _corpus(300, 41)
    nv = NeuroVecConfig(**NV_SMALL)
    port = PPOAgent(nv, device="cpu").load_state(jax_agent.state_dict())
    env = CostModelEnv(nv, legality="tpu_v5e")
    grid = env.cost_grid(tsites)
    assert np.array_equal(port.act(tsites, legal=np.ones(grid.shape, bool)),
                          port.act(tsites))
    tsites = [s for s, row in zip(tsites, grid) if np.isfinite(row).any()]
    prog = tvec.tune(tsites, port, port.space, env)
    assert all(tcm.site_cost(s, prog.tiles[s.key()], "tpu_v5e") is not None
               for s in tsites)
    with pytest.raises(ValueError, match="no legal action"):
        port.act(tsites[:1], legal=np.zeros((1, grid.shape[1]), bool))


def test_loaded_state_roundtrips(jax_agent):
    _, tsites = _corpus(50, 43)
    a = PPOAgent(NeuroVecConfig(**NV_SMALL), device="cpu")
    a.load_state(jax_agent.state_dict())
    b = PPOAgent(NeuroVecConfig(**NV_SMALL), seed=9, device="cpu")
    b.load_state(a.state_dict())
    assert np.array_equal(a.act(tsites), b.act(tsites))
    assert int(b.opt["t"]) == int(np.asarray(jax_agent.opt["t"]))


def test_load_state_rejects_other_agents():
    a = PPOAgent(DEFAULT, device="cpu")
    state = a.state_dict()
    with pytest.raises(ValueError, match="nns"):
        a.load_state(dict(state, name="nns"))
    with pytest.raises(ValueError, match="version"):
        a.load_state(dict(state, version=99))
    with pytest.raises(ValueError, match="structure"):
        PPOAgent(NeuroVecConfig(hidden=(32, 32)), device="cpu").load_state(
            state)


def test_ppo_training_raises_mean_reward():
    """The reference's convergence check (tests/test_core.py): the mean
    reward rises by more than 1 and ends positive (beats the baseline)."""
    _, tsites = _corpus(400, 11)
    nv = NeuroVecConfig(**NV_SMALL)
    agent = PPOAgent(nv, lr=5e-4, seed=0, device="cpu")
    hist = agent.train(tsites, CostModelEnv(nv, legality="tpu_v5e"),
                       total_steps=6000)
    first = np.mean([h["reward_mean"] for h in hist[:2]])
    last = np.mean([h["reward_mean"] for h in hist[-2:]])
    assert last > first + 1.0, (first, last)
    assert last > 0.0


def test_agent_without_cuda_needs_the_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        PPOAgent(DEFAULT)


def test_strict_actions_switch():
    from repro_torch.core import env as tenv
    space = ActionSpace(DEFAULT)
    try:
        tenv.set_strict_actions(True)
        with pytest.raises(IndexError):
            space.tiles("matmul", (7, 0, 0))
    finally:
        tenv.set_strict_actions(False)
    assert space.tiles("matmul", (7, 0, 0)) == (512, 128, 128)


def test_neurovec_config_dict_matches_reference():
    from repro.configs.neurovec import cfg_to_dict as jcfg_to_dict
    from repro_torch.configs.neurovec import cfg_from_dict, cfg_to_dict
    d = cfg_to_dict(NeuroVecConfig(**NV_SMALL))
    assert d == jcfg_to_dict(JNeuroVecConfig(**NV_SMALL))
    assert cfg_from_dict(d) == NeuroVecConfig(**NV_SMALL)
    with pytest.raises(ValueError, match="unknown"):
        cfg_from_dict(dict(d, vf_choices=[1]))


def test_tune_step_fn_matches_extract_then_tune(jax_agent):
    """``tune_step_fn`` extracts on ``meta`` tensors and tunes the sites;
    with the loaded JAX agent its program equals the JAX package's."""
    from repro.core.extractor import extract_arch_sites
    from repro_torch.configs import get_config
    from repro_torch.core.extractor import meta_batch
    from repro_torch.models.lm import build_model
    model = build_model(get_config("qwen3_8b"))
    port = PPOAgent(NeuroVecConfig(**NV_SMALL), device="cpu")
    port.load_state(jax_agent.state_dict())
    prog = tvec.tune_step_fn(lambda p, b: model.train_loss(p, b),
                             (model.init(device="meta"), meta_batch(4, 512)),
                             port, NeuroVecConfig(**NV_SMALL))
    jsites = extract_arch_sites("qwen3_8b", batch=4, seq=512)
    assert prog.tiles == jvec.tune(jsites, jax_agent, jax_agent.space).tiles
