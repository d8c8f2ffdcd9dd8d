"""The slice as a whole: the port's serve path on the CPU against the JAX
package's prefill and greedy decode under the same weights and the same
``TileProgram``.

The port tunes a program with PPO (``--autotune ppo``) and runs with
``--inject``; the JAX model then runs under ``inject(prog,
interpret=True)``, its Pallas kernels interpreted.  Both are f32 (the
reduced config), so the greedy tokens must be equal and the prefill logits
agree within 1e-4 absolute (summation order only).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import vectorizer as jvec
from repro.models.lm import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve

B, PROMPT, GEN = 2, 16, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU tensors: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(*extra):
    return ["--device", "cpu", "--batch", str(B), "--prompt-len",
            str(PROMPT), "--gen", str(GEN), *extra]


def _prompts(seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, PROMPT),
                                                dtype=np.int32)


@pytest.fixture(scope="module")
def weights():
    jm = jbuild_model(jget_config("qwen3_8b").reduced())
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp),
                         get_config("qwen3_8b").reduced(), device="cpu")
    return jm, jp, tp


def _jax_serve(jm, jp, prompts, prog):
    """The reference's prefill + greedy decode loop under a program."""
    cache = jm.make_cache(B, PROMPT + GEN, jnp.float32)
    with jvec.inject(prog, interpret=True):
        logits, cache = jax.jit(jm.prefill)(
            jp, {"tokens": jnp.asarray(prompts)}, cache)
        first = np.asarray(logits)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        out = [tok]
        step = jax.jit(jm.decode_step)
        for i in range(GEN - 1):
            logits, cache = step(jp, tok, jnp.int32(PROMPT + i), cache)
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            out.append(tok)
    return first, np.asarray(jnp.concatenate(out, 1))


def test_slice_end_to_end_matches_jax(weights, tmp_path):
    jm, jp, tp = weights
    prompts = _prompts()
    res = serve.run(serve.parse_args(_argv(
        "--autotune", "ppo", "--autotune-steps", "300", "--inject")),
        params=tp, prompts=torch.from_numpy(prompts))
    assert len(res.sites) == 17 and set(res.prog.tiles) == {
        s.key() for s in res.sites}
    path = tmp_path / "tiles.json"
    res.prog.save(str(path))
    jprog = jvec.TileProgram.load(str(path))
    logits, seq = _jax_serve(jm, jp, prompts, jprog)
    assert np.array_equal(res.seq.numpy(), seq)
    np.testing.assert_allclose(res.prefill_logits.numpy(), logits,
                               atol=1e-4, rtol=0)
    # the CPU ran every site through the kernels' plain versions
    none = {"matmul": 0, "flash_attention": 0, "chunk_scan": 0}
    assert res.launches == {"prefill": none, "decode": none}


def test_saved_program_reloads_and_serves_the_same_tokens(weights,
                                                          tmp_path):
    _, _, tp = weights
    prompts = torch.from_numpy(_prompts(2))
    path = str(tmp_path / "t.json")
    a = serve.run(serve.parse_args(_argv(
        "--autotune", "ppo", "--autotune-steps", "128", "--save-tiles", path,
        "--inject")), params=tp, prompts=prompts)
    with open(path) as f:
        assert len(json.load(f)) == 17
    b = serve.run(serve.parse_args(_argv("--tiles", path, "--inject")),
                  params=tp, prompts=prompts)
    c = serve.run(serve.parse_args(_argv()), params=tp, prompts=prompts)
    assert torch.equal(a.seq, b.seq) and torch.equal(a.seq, c.seq)
    assert a.prog.tiles == b.prog.tiles


def test_eager_serve_from_seeded_weights():
    res = serve.main(_argv())
    assert res.seq.shape == (B, GEN) and res.seq.dtype == torch.long
    assert res.prefill_logits.shape == (B, 256)
    assert torch.isfinite(res.prefill_logits).all()
    assert res.prog is None and res.prefill_ms > 0
    assert len(res.prefill_ms_runs) == serve.PREFILL_REPS
    assert len(res.decode_tok_s_runs) == serve.DECODE_REPS
    assert min(res.prefill_ms_runs) <= res.prefill_ms <= max(
        res.prefill_ms_runs)


def test_tuned_tiles_all_launch_even_when_the_policy_favours_others():
    """``tune`` with serve's h100 env takes the greedy pick over the legal
    tiles only, so the program serve injects never names a tile the kernels
    cannot launch; a legal greedy pick is kept as it was."""
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.core.agents.ppo import PPOAgent
    from repro_torch.core.env import CostModelEnv
    from repro_torch.core.extractor import extract_serve_sites
    from repro_torch.core.vectorizer import tune
    from repro_torch.kernels import ops
    from repro_torch.models.lm import build_model
    sites = extract_serve_sites(build_model(get_config("qwen3_8b")), 4, 512,
                                16)
    agent = PPOAgent(DEFAULT, device="cpu")
    # the bm head prefers 512, which no prefill matmul site can launch
    agent.params["pi"][-1]["b"][DEFAULT.bm_choices.index(512)] = 1e3
    env = CostModelEnv(DEFAULT, legality="h100")
    plain = tune(sites, agent, env.space).tiles
    prog = tune(sites, agent, env.space, env).tiles
    assert sum(not ops.tile_ok(s, plain[s.key()]) for s in sites) >= 7
    assert all(ops.tile_ok(s, prog[s.key()]) for s in sites)
    for s in sites:
        if ops.tile_ok(s, plain[s.key()]):
            assert prog[s.key()] == plain[s.key()]


@pytest.mark.parametrize("argv", [
    ["--inject"],
    ["--autotune", "ppo", "--tiles", "x.json"],
    ["--gen", "0"],
    ["--autotune", "dtree"],
])
def test_bad_flags_are_refused(argv):
    with pytest.raises(SystemExit):
        serve.parse_args(argv)


def test_serve_without_cuda_needs_the_cpu_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--batch", "1", "--prompt-len", "4", "--gen", "1"])
