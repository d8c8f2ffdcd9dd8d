"""The measured oracle's circuit breaker at a threshold of the caller's
(``MeasuredEnv(..., breaker_threshold=k)``), ``CostModelEnv``'s
``clear_baseline_cache`` and PPO's ``log_every``, in both packages: the
reference's breaker cases (``tests/test_faults.py``) at k = 1, 2 and 3,
with the breaker opening at the same batch in each."""
import dataclasses

import numpy as np
import pytest

from repro.configs.neurovec import DEFAULT as JDEFAULT
from repro.core.agents.ppo import PPOAgent as JPPOAgent
from repro.core.env import CostModelEnv as JCostModelEnv
from repro.core.env import MeasuredEnv as JMeasuredEnv
from repro.models.compute import KernelSite as JKernelSite
from repro_torch.configs.neurovec import DEFAULT
from repro_torch.core.agents.ppo import PPOAgent
from repro_torch.core.env import CostModelEnv, MeasuredEnv
from repro_torch.models.compute import KernelSite

PACKAGES = {
    "reference": (JMeasuredEnv, JCostModelEnv, JKernelSite, JDEFAULT),
    "port": (MeasuredEnv, CostModelEnv, KernelSite, DEFAULT),
}


def _sites(KS):
    return [KS(site="f.mm", kind="matmul", m=32, n=128, k=128),
            KS(site="f.mm2", kind="matmul", m=64, n=128, k=128)]


def _actions(i):
    """Batch ``i``'s actions: a bm index of its own, so every batch
    sends the hook fresh (site, tile) pairs."""
    return np.array([[i, 0, 0], [i, 0, 0]], np.int64)


def _trip_batch(pkg, k, fail_batches, n_batches):
    """The 1-based batch at which the breaker opened (None if it never
    did), the batches' finiteness and the final health, with a hook that
    fails every pair of the first ``fail_batches`` batches."""
    Env, _, KS, nv = PACKAGES[pkg]
    seen = {"n": 0}

    def hook(sites, tiles):
        seen["n"] += 1
        if seen["n"] <= fail_batches:
            return np.full(len(sites), np.nan)
        return np.full(len(sites), 1e-5)

    env = Env(nv, measure_fn=hook, breaker_threshold=k)
    assert env.breaker_threshold == k
    tripped, finite = None, []
    for i in range(n_batches):
        c = env.costs_batch(_sites(KS), _actions(i))
        finite.append(bool(np.isfinite(c).all()))
        if env.breaker_open and tripped is None:
            tripped = i + 1
    return tripped, finite, env.health()


@pytest.mark.parametrize("k", [1, 2, 3])
def test_breaker_trips_after_k_consecutive_all_failed_batches(k):
    out = {pkg: _trip_batch(pkg, k, fail_batches=k + 1, n_batches=k + 1)
           for pkg in PACKAGES}
    assert out["port"] == out["reference"]
    tripped, finite, health = out["port"]
    assert tripped == k and health == "degraded"
    # the batches before the trip are honest failures; the tripping one
    # is priced by the cost model
    assert finite == [False] * (k - 1) + [True, True]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_breaker_not_tripped_by_fewer_than_k_failed_batches(k):
    out = {pkg: _trip_batch(pkg, k, fail_batches=k - 1, n_batches=k + 1)
           for pkg in PACKAGES}
    assert out["port"] == out["reference"]
    tripped, finite, health = out["port"]
    assert tripped is None and health == "ok"
    assert finite == [False] * (k - 1) + [True, True]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_breaker_threshold_below_one_raises(pkg):
    Env, _, _, nv = PACKAGES[pkg]
    with pytest.raises(ValueError, match="breaker_threshold"):
        Env(nv, breaker_threshold=0)


def test_port_breaker_threshold_is_keyword_only():
    with pytest.raises(TypeError):
        MeasuredEnv(DEFAULT, None, 0, "tpu_v5e", None, None, 3)
    assert not hasattr(MeasuredEnv, "BREAKER_THRESHOLD")


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_clear_baseline_cache_empties_it(pkg):
    _, CostEnv, KS, nv = PACKAGES[pkg]
    env = CostEnv(nv)
    sites = _sites(KS)
    first = env.baseline_costs(sites)
    assert len(env._baseline_cache) == 2
    env.clear_baseline_cache()
    assert env._baseline_cache == {}
    np.testing.assert_array_equal(env.baseline_costs(sites), first)


def test_ppo_takes_log_every_as_the_reference_does():
    nv = dataclasses.replace(DEFAULT, train_batch=8)
    jnv = dataclasses.replace(JDEFAULT, train_batch=8)
    agents = {"port": (PPOAgent(nv, seed=0, device="cpu"), CostModelEnv(nv),
                       _sites(KernelSite)),
              "reference": (JPPOAgent(jnv, seed=0), JCostModelEnv(jnv),
                            _sites(JKernelSite))}
    for agent, env, sites in agents.values():
        assert agent.fit(sites, env, total_steps=8, log_every=5) is agent
        agent.train(sites, env, total_steps=8, log_every=3)
