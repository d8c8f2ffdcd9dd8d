"""The one launch rule of the port's kernels (``kernels/ops.py``): its
dtype, head-dim and tile clauses, shared by ``tile_ok``, both
``CostModelEnv(legality="h100")`` paths, the launch plans and ``tune``.

The rule is written out below as the oracle.  Over every site of the
corpus the main-path test trains on, and every tile of the action space,
the port agrees with it; at every Qwen3-8B and xLSTM-1.3B serve site the
legal set is the parent's rule, also written out.  Exact (booleans).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.neurovec import DEFAULT
from repro_torch.core import costmodel as tcm
from repro_torch.core import costmodel_vec as tcv
from repro_torch.core import dataset
from repro_torch.core.agents import BruteForceAgent, PPOAgent
from repro_torch.core.env import ActionSpace, CostModelEnv
from repro_torch.core.extractor import (extract_arch_sites,
                                        extract_serve_sites)
from repro_torch.core.vectorizer import tune
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.models.compute import KernelSite
from repro_torch.models.lm import build_model

SPACE = ActionSpace(DEFAULT)


def _pow2(v, lo):
    p = 1
    while p < v:
        p *= 2
    return max(lo, p)


def _parent_rule(site, tiles):
    """The rule before dtype and head dim entered it: tile shapes
    only, K2's accumulator counted at the site's own head dim."""
    if site.kind == "matmul":
        bm, bn, bk = tiles
        rows = _pow2(min(bm, -(-site.m // 8) * 8), 16)
        cols = _pow2(min(bn, -(-site.n // 128) * 128), 128)
        return rows <= 256 and cols <= 512 and rows * cols <= 128 * 256
    if site.kind == "attention":
        Sq, Skv, D = site.m, site.k, site.n
        bq, bkv = tiles[:2]
        if Sq == 1:
            return True
        bq_e, bkv_e = min(bq, Sq), min(bkv, Skv)
        return bq_e * D <= 128 * 128 and Sq % bq_e == 0 and Skv % bkv_e == 0
    Q, S, N = tiles[0], site.batch * site.m, site.k
    return min(Q, S) <= 1024 and 8 <= N <= 1024 and N % 8 == 0


def _refused(site):
    """The sites the kernels take no tile of: not bf16, or prefill
    attention at a head dim that is not a multiple of 8 up to 128."""
    return site.dtype != "bfloat16" or (
        site.kind == "attention" and site.m > 1
        and (site.n % 8 or not 8 <= site.n <= 128))


def _rule(site, tiles):
    """The rule written out: the dtype and head-dim clauses, then the
    parent's tile clause with K2's accumulator at the padded head dim."""
    if _refused(site):
        return False
    if site.kind == "attention" and site.m > 1:
        site = KernelSite(site.site, "attention", m=site.m, n=128, k=site.k)
    return _parent_rule(site, tiles)


def _action_tiles(site):
    return [SPACE.tiles(site.kind, SPACE.unflatten(site.kind, f))
            for f in range(SPACE.n_actions(site.kind))]


@pytest.fixture(scope="module")
def corpus():
    base = extract_arch_sites("stablelm_3b", batch=4, seq=512)
    return (dataset.generate(400, seed=0, base=base)
            + dataset.generate(600, seed=7))


def _serve_sites(arch):
    return extract_serve_sites(build_model(get_config(arch)), 4, 512, 16)


def test_tile_ok_is_the_rule_over_the_corpus(corpus):
    """At every corpus site and action tile ``tile_ok`` is the rule; a
    refused site (about half the corpus is f32; head dims are jittered)
    has no legal tile, and a site the dtype and head-dim clauses admit
    has none only where no action's blocks divide its sequence."""
    n_refused = n_shape = 0
    for s in corpus:
        got = [ops.tile_ok(s, t) for t in _action_tiles(s)]
        assert got == [_rule(s, t) for t in _action_tiles(s)], s.key()
        if _refused(s):
            n_refused += 1
            assert not any(got)
        elif not any(got):
            n_shape += 1
            assert s.kind == "attention" and s.m > 1, s.key()
    assert 300 < n_refused < 700 and n_shape < 20


def test_h100_cost_grid_is_finite_exactly_where_tile_ok(corpus):
    """Both env paths, the batched grid and the scalar cost, call the
    rule: finite exactly where ``tile_ok`` is true."""
    env = CostModelEnv(DEFAULT, legality="h100")
    grid = env.cost_grid(corpus)
    for i, s in enumerate(corpus):
        tiles = _action_tiles(s)
        ok = np.array([ops.tile_ok(s, t) for t in tiles])
        assert np.array_equal(np.isfinite(grid[i, :len(tiles)]), ok)
        assert np.isinf(grid[i, len(tiles):]).all()
        if i % 25 == 0:
            assert [tcm.site_cost(s, t, "h100") is not None
                    for t in tiles] == list(ok)
            assert [env.cost(s, SPACE.unflatten(s.kind, f)) is not None
                    for f in range(len(tiles))] == list(ok)


def test_env_trains_over_refused_sites_and_tune_raises_at_them(corpus):
    """A refused site has an infinite baseline and earns the penalty for
    every action, so PPO trains over the whole corpus; ``tune`` under the
    rule raises "no legal action" there, whichever agent."""
    env = CostModelEnv(DEFAULT, legality="h100")
    bad = next(s for s in corpus if s.dtype == "float32")
    assert np.isinf(env.baseline_costs([bad])[0])
    assert env.baseline_cost(bad) == np.inf
    acts = np.zeros((1, 3), np.int64)
    assert env.rewards_batch([bad], acts)[0] == DEFAULT.fail_penalty
    assert env.reward(bad, (0, 0, 0)) == DEFAULT.fail_penalty
    agent = PPOAgent(DEFAULT, seed=0, device="cpu")
    agent.train(corpus[:200], env, total_steps=64, batch=64)
    good = next(s for s in corpus if not _refused(s))
    for a in (agent, BruteForceAgent(oracle=env)):
        with pytest.raises(ValueError, match="no legal action"):
            tune([good, bad], a, env.space, env)
    head = KernelSite("attn.core", "attention", m=512, n=20, k=512,
                      batch=64, causal=True)
    with pytest.raises(ValueError, match="no legal action"):
        tune([head], agent, env.space, env)


@pytest.mark.parametrize("arch", ["qwen3_8b", "xlstm_1_3b"])
def test_serve_sites_keep_the_parents_legal_sets(arch):
    """All bf16, attention at head dim 128: the rule's legal set at every
    serve site is the parent's, tile by tile."""
    sites = _serve_sites(arch)
    assert {s.dtype for s in sites} == {"bfloat16"}
    n = 0
    for s in sites:
        for t in _action_tiles(s):
            assert ops.tile_ok(s, t) == _parent_rule(s, t), (s.key(), t)
            n += ops.tile_ok(s, t)
    assert n > 0


def test_stablelm_sites_launch_at_head_dim_80():
    """StableLM-3B's prefill attention (D = 80) launches K2 at the blocks
    the parent's rule admitted, now with a plan sized at the padded 128;
    its baseline tiles launch at every serve site."""
    sites = _serve_sites("stablelm_3b")
    att = next(s for s in sites if s.kind == "attention" and s.m > 1)
    assert (att.m, att.n, att.k, att.dtype) == (512, 80, 512, "bfloat16")
    for s in sites:
        assert ops.tile_ok(s, tcm.baseline_tiles(s)), s.key()
        for t in _action_tiles(s):
            assert ops.tile_ok(s, t) == _parent_rule(s, t), (s.key(), t)
    p = ops.attention_launch_plan(512, 512, 80, 128, 512)
    assert (p.variant, p.warpgroups, p.stage_keys, p.ring) == (
        "tma_wgmma", 2, 128, 2)
    assert p.smem == 2 * 2 * 64 * 128 * 2 + 2 * 4 * 128 * 128 + 1024
    for d in (20, 136, 192):
        assert ops.attention_launch_plan(512, 512, d, 128, 512) is None


def test_cpu_route_is_the_rule_without_its_dtype_clause(corpus):
    """``legality="cpu"`` (serve on the CPU, the plain versions) prices a
    site as the card's rule prices the same site in bf16."""
    sites = corpus[:300]
    as_bf16 = [dataclasses.replace(s, dtype="bfloat16") for s in sites]
    cpu = np.isfinite(tcv.cost_grid(SPACE, sites, "cpu"))
    card = np.isfinite(tcv.cost_grid(SPACE, as_bf16, "h100"))
    assert np.array_equal(cpu, card)
    assert not np.array_equal(cpu, np.isfinite(
        tcv.cost_grid(SPACE, sites, "h100")))


def test_kernels_refuse_what_the_rule_refuses():
    """The kernels' own argument checks call the rule: a CUDA wrapper
    raises on a dtype the rule refuses before it touches the device."""
    assert ops.torch_dtype_ok(torch.ones(2, dtype=torch.bfloat16))
    assert not ops.torch_dtype_ok(torch.ones(2))
    assert not ops.torch_dtype_ok(torch.ones(2, dtype=torch.bfloat16),
                                  torch.ones(2))
    assert list(ops.head_dim_ok([8, 16, 20, 64, 80, 96, 128, 136])) == [
        True, True, False, True, True, True, True, False]
    q = torch.ones((1, 2, 16, 80))
    with pytest.raises(TypeError, match="bfloat16"):
        kfa.flash_attention_cuda(q, q, q, causal=True, scale=0.1, bq=16,
                                 bkv=16)


@pytest.mark.parametrize("d", [80, 64, 96, 16])
def test_padding_the_head_dim_to_128_keeps_the_function(d):
    """K2's design at D < 128: q, k and v padded with zero columns to 128,
    the scale at the true D, and the output's first D columns kept, is
    the plain version's function at D (the padded columns add nothing to
    Q.K^T, and P.V's columns past D are dropped)."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, 4, 128, d), dtype=np.float32)) for _ in range(3))
    want = kfa.flash_attention_plain(q, k, v, causal=True, scale=d ** -0.5,
                                     bq=64, bkv=128)
    pad = [torch.nn.functional.pad(t, (0, 128 - d)) for t in (q, k, v)]
    got = kfa.flash_attention_plain(*pad, causal=True, scale=d ** -0.5,
                                    bq=64, bkv=128)
    assert float(got[..., d:].abs().max()) == 0.0
    np.testing.assert_allclose(got[..., :d].numpy(), want.numpy(),
                               atol=1e-6, rtol=0)
