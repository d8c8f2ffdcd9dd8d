"""The paper's main-path test on the port: the steps of
``tests/test_system.py::test_end_to_end_vectorization_pipeline`` (Fig. 3:
extract -> train PPO on the corpus -> tune -> inject), with its asserts.

StableLM-3B's sites at full width, PPO trained on
``dataset.generate(400, seed=0, base=sites)``, the tuned program faster
than the baseline under the cost model (``program_speedup > 1``, the TPU
v5e time formula: a modelled number), and the program injected into the
reduced config's training loss, within ``rtol=5e-3`` of eager mode and of
the JAX model's loss (the reference's tolerance; both are f32 here and
differ by summation order).  On the CPU the kernels' plain versions stand
in for the reference's interpret mode.  The oracle prices legality as
the reference's does (``legality="tpu_v5e"``, its VMEM rule): under the
card's launch rule this budget of 2500 steps leaves the agent's legal
greedy picks at about 0.95x (the under-trained agent of ROADMAP queue 3;
the card's tuning is checked with brute force in ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models.lm import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.configs.neurovec import NeuroVecConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import dataset
from repro_torch.core.agents import PPOAgent
from repro_torch.core.env import CostModelEnv
from repro_torch.core.extractor import (META, extract_arch_sites,
                                        extract_sites)
from repro_torch.core.vectorizer import inject, program_speedup, tune
from repro_torch.models.lm import build_model

NV = NeuroVecConfig(train_batch=256, sgd_minibatch=64, ppo_epochs=4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU tensors: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_end_to_end_vectorization_pipeline():
    env = CostModelEnv(NV, legality="tpu_v5e")
    # 1. extract kernel sites from a real model step ("loop extractor")
    sites = extract_arch_sites("stablelm_3b", batch=4, seq=512)
    assert sites, "extractor found no tunable sites"

    # 2. train the agent on the synthetic corpus (paper §3.2)
    corpus = dataset.generate(400, seed=0, base=sites)
    agent = PPOAgent(NV, lr=5e-4, seed=0, device="cpu")
    agent.train(corpus, env, total_steps=2500)

    # 3. tune the extracted sites (greedy inference — paper §4.2)
    prog = tune(sites, agent, env.space)
    sp = program_speedup(prog, sites, env)
    assert sp > 1.0, f"tuned program slower than baseline: {sp}"

    # 4. inject: model math must be unchanged by the tiles
    jcfg = jget_config("stablelm_3b").reduced()
    cfg = get_config("stablelm_3b").reduced()
    jmodel, model = jbuild_model(jcfg), build_model(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    ones = np.ones((2, 16), np.int32)
    loss_jax, _ = jmodel.train_loss(jparams, {"tokens": jnp.asarray(ones),
                                              "targets": jnp.asarray(ones)})
    batch = {"tokens": torch.ones((2, 16), dtype=torch.long),
             "targets": torch.ones((2, 16), dtype=torch.long)}
    loss_eager, _ = model.train_loss(params, batch)
    meta = {k: v.to(META) for k, v in batch.items()}
    small_sites = extract_sites(lambda p, b: model.train_loss(p, b)[0],
                                model.init(device=META), meta)
    small_prog = tune(small_sites, agent, env.space)
    with inject(small_prog):
        loss_tuned, _ = model.train_loss(params, batch)
    np.testing.assert_allclose(float(loss_tuned), float(loss_eager),
                               rtol=5e-3)
    np.testing.assert_allclose(float(loss_tuned), float(loss_jax),
                               rtol=5e-3)
