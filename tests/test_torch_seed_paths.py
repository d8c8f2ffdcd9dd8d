"""The seed's reference paths on the port against the JAX package's: the
scalar ``CostModelEnv(vectorized=False)``, PPO's un-fused update
(``PPOAgent(fused=False)``: features without the memo, the un-factored
embedder, the tail minibatch dropped), and the runner's shape caps and
input seed (``MeasureRunner(max_dim=, max_batch=, seed=)``, ``serve-worker
--max-dim/--max-batch``).

The scalar env is held bitwise to the reference's under
``legality="tpu_v5e"`` over the ten-arch corpus with numpy-seeded actions,
and to the port's vectorized path within ``tests/test_costmodel_vec.py``'s
tolerance.  PPO is held to the reference from carried parameters:
features bitwise, the forward within 1e-6, one minibatch step (loss,
parameters after Adam) within 1e-5; sampling cannot be held (the port
draws from a ``torch.Generator``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.neurovec import NeuroVecConfig as JNeuroVecConfig
from repro.core import dataset as jds
from repro.core import embedding as jemb
from repro.core.agents import ppo as jppo
from repro.core.env import CostModelEnv as JCostModelEnv
from repro.measure.runner import MeasureRunner as JMeasureRunner
from repro.models.compute import KernelSite as JKernelSite
from repro_torch.configs.neurovec import NeuroVecConfig
from repro_torch.core import embedding as emb
from repro_torch.core.agents.ppo import PPOAgent, _leaves, policy_forward
from repro_torch.core.env import ActionSpace, CostModelEnv
from repro_torch.measure.runner import MeasureRunner
from repro_torch.models.compute import KernelSite

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU tensors: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    """The ten-arch corpus, the reference's sites and the port's."""
    jsites = jds.arch_sites()
    return jsites, [KernelSite(**dataclasses.asdict(s)) for s in jsites]


def _actions(sites, seed=0):
    """Numpy-seeded actions over the full heads (clamped per kind)."""
    rng = np.random.default_rng(seed)
    heads = ActionSpace(NeuroVecConfig()).head_sizes
    return rng.integers(0, heads, size=(len(sites), 3))


# ---------------------------------------------------------------------------
# CostModelEnv(vectorized=False)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_scalar_env_is_the_references_bitwise(corpus, noise):
    """Each scalar entry point in the same order on both packages, so
    the noise streams meet the same draws."""
    jsites, sites = corpus
    acts = _actions(sites)
    env = CostModelEnv(NeuroVecConfig(reward_noise=noise), seed=3,
                       legality="tpu_v5e", vectorized=False)
    jenv = JCostModelEnv(JNeuroVecConfig(reward_noise=noise), seed=3,
                         vectorized=False)
    for s, js, a in zip(sites, jsites, acts):
        assert env.reward(s, a) == jenv.reward(js, a)
        assert env.speedup(s, a) == jenv.speedup(js, a)
    for name in ("costs_batch", "rewards_batch", "speedups_batch"):
        got = getattr(env, name)(sites, acts)
        want = getattr(jenv, name)(jsites, acts)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert not env._baseline_cache, "the scalar path filled the cache"


@pytest.mark.parametrize("legality", ["tpu_v5e", "h100"])
@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_scalar_env_equals_the_vectorized_path(corpus, legality, noise):
    """The two paths of the port on one corpus, seeded alike: rewards
    within test_costmodel_vec's rtol 1e-6/atol 1e-7, costs and speedups
    within 1e-9, the illegal entries alike.  An f32 attention site,
    every tile of it illegal under ``h100`` (its baseline too), is
    added."""
    _, sites = corpus
    sites = sites + [KernelSite(site="f32.attn", kind="attention", m=128,
                                n=64, k=128, batch=2, dtype="float32")]
    acts = _actions(sites, seed=1)
    cfg = NeuroVecConfig(reward_noise=noise)
    vec = CostModelEnv(cfg, seed=7, legality=legality)
    scl = CostModelEnv(cfg, seed=7, legality=legality, vectorized=False)
    np.testing.assert_allclose(vec.rewards_batch(sites, acts),
                               scl.rewards_batch(sites, acts),
                               rtol=1e-6, atol=1e-7)
    cv, cs = vec.costs_batch(sites, acts), scl.costs_batch(sites, acts)
    np.testing.assert_array_equal(np.isinf(cv), np.isinf(cs))
    np.testing.assert_allclose(cv[np.isfinite(cv)], cs[np.isfinite(cs)],
                               rtol=1e-9)
    np.testing.assert_allclose(vec.speedups_batch(sites, acts),
                               scl.speedups_batch(sites, acts), rtol=1e-9)
    for s, a in zip(sites[:20], acts[:20]):
        assert vec.speedup(s, a) == pytest.approx(scl.speedup(s, a),
                                                  rel=1e-9)
    assert np.isinf(vec.baseline_costs(sites)[-1]) == (legality == "h100")


def test_measured_env_stays_vectorized():
    from repro_torch.core.env import MeasuredEnv
    assert MeasuredEnv(NeuroVecConfig(), legality="tpu_v5e").vectorized


# ---------------------------------------------------------------------------
# PPOAgent(fused=False)
# ---------------------------------------------------------------------------

NV = dict(train_batch=32, sgd_minibatch=16, ppo_epochs=2, lr=5e-4)


def _agents(seed=0):
    """The reference's seed path and the port's, the port carrying the
    reference's parameters and Adam state."""
    jag = jppo.PPOAgent(JNeuroVecConfig(**NV), seed=seed, fused=False)
    ag = PPOAgent(NeuroVecConfig(**NV), seed=seed, fused=False, **CPU)
    ag.load_state(jag.state_dict())
    return jag, ag


def test_featurize_without_the_memo_is_bitwise_and_leaves_it(corpus):
    jsites, sites = corpus
    before = dict(emb._FEAT_CACHE)
    ctx, mask = emb.featurize_batch(sites, cache=False)
    jctx, jmask = jemb.featurize_batch(jsites, cache=False)
    np.testing.assert_array_equal(ctx, jctx)
    np.testing.assert_array_equal(mask, jmask)
    assert ctx.dtype == jctx.dtype and mask.dtype == jmask.dtype
    assert emb._FEAT_CACHE.keys() == before.keys()
    assert all(emb._FEAT_CACHE[k] is v for k, v in before.items())
    one, _ = emb.featurize(sites[0], cache=False)
    assert one.flags.writeable
    np.testing.assert_array_equal(one, emb.featurize(sites[0])[0])


def test_policy_forward_with_the_unfactored_embedder(corpus):
    jsites, sites = corpus
    jag, ag = _agents()
    ctx, mask, vs = ag.feats(sites)
    jctx, jmask, jvs = jag.feats(jsites)
    out, v = policy_forward(ag.params, ag.head_sizes, ctx, mask, vs,
                            fast_embed=False)
    jout, jv = jppo.policy_forward(jag.params, jag.nv, jag.head_sizes, jctx,
                                   jmask, jvs, "discrete", fast_embed=False)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6)
    for lg, jlg in zip(out, jout):
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-6)
    fast, _ = policy_forward(ag.params, ag.head_sizes, ctx, mask, vs)
    for lg, flg in zip(out, fast):      # the two embedders, the same math
        np.testing.assert_allclose(lg.numpy(), flg.numpy(), atol=1e-5)


def test_one_legacy_minibatch_step_is_the_references(corpus):
    """From carried parameters and one index set: the reference's
    ``_jit_grads`` and ``adam_update`` against the port's step."""
    jsites, sites = corpus
    jag, ag = _agents()
    n = 40
    rng = np.random.default_rng(5)
    acts = _actions(sites[:n], seed=2)
    vs = np.array([ag.space.valid_sizes(s.kind) for s in sites[:n]])
    acts = np.minimum(acts, vs - 1)
    raw = acts.astype(np.float32)
    old_logp = rng.normal(-3.0, 0.5, n).astype(np.float32)
    rewards = rng.normal(0.0, 1.0, n).astype(np.float32)
    sl = rng.permutation(n)[:16]
    jctx, jmask, jvs = jag.feats(jsites[:n])
    loss, grads = jag._jit_grads(
        jag.params, jctx[sl], jmask[sl], jvs[sl], jnp.asarray(acts)[sl],
        jnp.asarray(raw)[sl], jnp.asarray(old_logp)[sl],
        jnp.asarray(rewards)[sl])
    want, _ = jppo.adam_update(jag.params, grads, jag.opt, jag._lr)
    ctx, mask, tvs = ag.feats(sites[:n])
    data = (ctx, mask, tvs, torch.as_tensor(acts).long(),
            torch.as_tensor(raw), torch.as_tensor(old_logp),
            torch.as_tensor(rewards))
    got_loss = ag._step(data, torch.as_tensor(sl))
    assert got_loss == pytest.approx(float(loss), abs=1e-5)
    jl = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, want))
    # both trees flatten with dict keys sorted
    for got, w in zip(_leaves(ag.params), jl):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5)
    assert int(ag.opt["t"]) == 1


@pytest.mark.parametrize("fused,want", [(False, 2 * (37 // 16)),
                                        (True, 2 * 3)])
def test_minibatch_count(corpus, fused, want):
    _, sites = corpus
    ag = PPOAgent(NeuroVecConfig(**NV), seed=0, fused=fused, **CPU)
    n = 37
    a, raw, logp, _ = ag.sample_actions(sites[:n])
    loss = ag.update(sites[:n], a, raw, logp, np.zeros(n, np.float32))
    assert ag.last_minibatch_count == want
    assert isinstance(loss, float) and np.isfinite(loss)


def _demo_sites():
    return [KernelSite(site="ex.qkv", kind="matmul", m=64, n=128, k=256),
            KernelSite(site="ex.ffn", kind="matmul", m=128, n=128, k=128),
            KernelSite(site="ex.attn", kind="attention", m=128, n=64,
                       k=128, batch=2, causal=True),
            KernelSite(site="ex.scan", kind="chunk_scan", m=64, n=32,
                       k=16, batch=2)]


def test_legacy_fit_is_legal_and_fused_is_unchanged():
    """A seed-path fit against the scalar env leaves legal greedy tiles
    and its featurization memo untouched; ``fused=True`` stays the
    default and trains bit for bit as an agent built without it."""
    sites = _demo_sites()
    cfg = NeuroVecConfig(**NV)
    env = CostModelEnv(cfg, legality="tpu_v5e", vectorized=False)
    legacy = PPOAgent(cfg, seed=0, fused=False, **CPU)
    legacy.fit(sites, env, total_steps=96)
    greedy = legacy.act(sites)
    assert np.isfinite(env.costs_batch(sites, greedy)).all()
    assert legacy.last_minibatch_count == cfg.ppo_epochs * (32 // 16)
    a = PPOAgent(cfg, seed=0, **CPU)
    b = PPOAgent(cfg, seed=0, fused=True, **CPU)
    assert a.fused
    for ag in (a, b):
        ag.fit(sites, CostModelEnv(cfg, legality="tpu_v5e"),
               total_steps=64)
    for x, y in zip(*(_leaves([ag.params, ag.opt["m"]]) for ag in (a, b))):
        assert torch.equal(x, y)
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    state = legacy.state_dict()
    assert "fused" not in state
    again = PPOAgent(cfg, seed=1, fused=False, **CPU).load_state(state)
    np.testing.assert_array_equal(again.act(sites), greedy)


# ---------------------------------------------------------------------------
# MeasureRunner(max_dim=, max_batch=, seed=)
# ---------------------------------------------------------------------------

_MAT_SITES = [
    KernelSite(site="c.mm", kind="matmul", m=100, n=48, k=300),
    KernelSite(site="c.attn", kind="attention", m=200, n=64, k=96,
               batch=6, causal=True),
    KernelSite(site="c.scan", kind="chunk_scan", m=64, n=40, k=16,
               batch=3),
]
_TILES = {"matmul": (16, 128, 128), "attention": (64, 128, 1),
          "chunk_scan": (32, 1, 1)}


def _shapes(build, ops_mod, monkeypatch, site):
    seen = []
    for name in ("matmul", "flash_attention", "chunk_scan"):
        monkeypatch.setattr(ops_mod, name, lambda *a, _n=name, **k:
                            seen.append((_n, [tuple(x.shape) for x in a])))
    build(site, _TILES[site.kind])()
    return seen


@pytest.mark.parametrize("i", range(len(_MAT_SITES)))
def test_capped_shapes_are_the_references(i, monkeypatch):
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops
    site = _MAT_SITES[i]
    r = MeasureRunner(max_dim=32, max_batch=1, reps=1, **CPU)
    jr = JMeasureRunner(max_dim=32, max_batch=1, interpret=True)
    for v in (1, 7, 32, 33, 100, 4096):
        assert r._cap(v) == jr._cap(v) and r._cap_b(v) == jr._cap_b(v)
    jsite = JKernelSite(**dataclasses.asdict(site))
    got = _shapes(r._build, ops, monkeypatch, site)
    want = _shapes(jr._build, jops, monkeypatch, jsite)
    assert got == want and got


def test_default_caps_and_the_db_key(monkeypatch):
    plain = MeasureRunner(**CPU)
    assert (plain.max_dim, plain.max_batch, plain.seed) == (128, 2, 0)
    assert plain.backend_key.endswith(":cpu:plain(dim<=128,b<=2)")
    capped = MeasureRunner(max_dim=32, max_batch=1, **CPU)
    assert capped.backend_key.endswith(":cpu:plain(dim<=32,b<=1)")
    seeded = MeasureRunner(seed=3, **CPU)
    assert seeded.backend_key == plain.backend_key + ":seed3"
    uncapped = MeasureRunner(max_dim=0, max_batch=0, **CPU)
    assert uncapped.backend_key.endswith(":cpu:plain(dim<=0,b<=0)")
    # on the card: an uncapped runner at seed 0 keeps the key it had
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "H100")
    card = MeasureRunner(max_dim=0, max_batch=0, **CPU)
    card.device = torch.device("cuda")
    head = f"torch{torch.__version__}:cuda{torch.version.cuda or '-'}:H100"
    assert card.backend_key == f"{head}:kernels"
    card.max_dim, card.max_batch = 32, 1
    assert card.backend_key == f"{head}:kernels(dim<=32,b<=1)"
    card.seed = 2
    assert card.backend_key == f"{head}:kernels(dim<=32,b<=1):seed2"


def test_the_seed_draws_the_inputs(monkeypatch):
    from repro_torch.kernels import ops
    site = _MAT_SITES[0]
    vals = {}
    for seed in (0, 0, 5):
        seen = []
        monkeypatch.setattr(ops, "matmul", lambda x, w, **k: seen.append(
            x.clone()))
        MeasureRunner(seed=seed, **CPU)._build(site, _TILES["matmul"])()
        vals.setdefault(seed, []).append(seen[0])
    assert torch.equal(*vals[0])
    assert not torch.equal(vals[0][0], vals[5][0])


def test_serve_worker_caps_reach_the_runner(monkeypatch, capsys):
    from repro_torch.fleet import __main__ as fleet_main
    servers = []
    monkeypatch.setattr(fleet_main, "_serve",
                        lambda server, what: servers.append(server) or 0)
    assert fleet_main.main(["serve-worker", "--port", "0", "--transport",
                            "inproc", "--device", "cpu", "--max-dim", "32",
                            "--max-batch", "1"]) == 0
    assert "plain(dim<=32,b<=1)" in capsys.readouterr().out
    assert fleet_main.main(["serve-worker", "--port", "0", "--transport",
                            "inproc", "--device", "cpu"]) == 0
    assert "plain(dim<=128,b<=2)" in capsys.readouterr().out
    assert len(servers) == 2
