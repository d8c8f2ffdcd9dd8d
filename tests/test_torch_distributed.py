"""The port on several ranks, over gloo process groups on the CPU: the
train driver's mesh path (DTensor state placed by the sharding rules,
the step under the sharding hints) against the one-card path and the
JAX package's ``train_step`` without a mesh; microbatches placed by
``mb_specs``; a checkpoint written on a mesh resumed on one process; and
``compressed_psum`` against the JAX package's.

Each multi-process case spawns its ranks (``test_torch_dist_helpers``)
with a time limit of its own, so a hang fails instead of stalling the
suite."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_dist_helpers import psum_target, run_ranks, train_target

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
LOSS_RTOL = 1e-5
LEAF_ATOL = 1e-4
PARAM_ATOL = 5e-5        # tests/test_torch_train.py's, against the reference


def _argv(arch, steps=STEPS, accum=1, extra=()):
    return ["--arch", arch, "--steps", str(steps), "--batch", "4", "--seq",
            "32", "--accum", str(accum), "--device", "cpu", *extra]


_ONE_CARD = {}


def _one_card(arch, accum=1):
    """The port's one-card driver run (no process group), once."""
    key = (arch, accum)
    if key not in _ONE_CARD:
        assert "WORLD_SIZE" not in os.environ
        _ONE_CARD[key] = train_target(0, _argv(arch, accum=accum), None)
        assert _ONE_CARD[key]["mesh"] is None
    return _ONE_CARD[key]


def _assert_same_run(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    assert np.isfinite(got["grad_norms"]).all()
    assert got["leaves"].keys() == want["leaves"].keys()
    for k, w in want["leaves"].items():
        np.testing.assert_allclose(got["leaves"][k], w, atol=LEAF_ATOL,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("arch,dims", [
    ("qwen3_8b", (2, 2)), ("llama4_maverick_400b", (2, 2)),
    ("qwen3_8b", (1, 2)), ("llama4_maverick_400b", (1, 2))])
def test_sharded_train_matches_one_card(arch, dims):
    world = dims[0] * dims[1]
    res = run_ranks(train_target, world,
                    _argv(arch, extra=("--model-parallel", str(dims[1]))),
                    None, timeout=110)
    assert res[0]["mesh"] == ("data", "model")
    for r in res[1:]:
        assert r["losses"] == res[0]["losses"]
    _assert_same_run(res[0], _one_card(arch))


def test_sharded_train_with_an_uneven_vocab_matches_one_card():
    """A vocab TP does not divide (250 over 4): the head's spec leaves it
    replicated, and the logits are sharded unevenly, as GSPMD pads them."""
    argv = _argv("qwen3_8b")
    res = run_ranks(train_target, 4, argv + ["--model-parallel", "4"],
                    {"vocab_size": 250}, timeout=110)
    _assert_same_run(res[0], train_target(0, argv, {"vocab_size": 250}))


@pytest.mark.parametrize("arch", ["qwen3_8b", "llama4_maverick_400b"])
def test_one_card_driver_matches_reference_train_step(arch):
    """The weights and batches the mesh runs train on, through the JAX
    package's ``train_step`` (no mesh: its train driver fails on the
    installed jax, ROADMAP's caveats)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.models.lm import build_model as jbuild_model
    from repro.optim import adamw as jadamw
    from repro.train import steps as jsteps
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.distributed import sharding
    from repro_torch.launch import train
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import make_train_state

    args = train.parse_args(_argv(arch))
    cfg = get_config(arch).reduced()
    state = make_train_state(build_model(cfg), 0, AdamWConfig(),
                             device="cpu")
    jstate = {"params": sharding.map_with_path(
        lambda _, t: jnp.asarray(t.numpy()), state["params"])}
    jstate["opt"] = jadamw.init(jstate["params"])
    jstate["step"] = jnp.zeros((), jnp.int32)
    opt = jadamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                             warmup_steps=max(1, args.steps // 10))
    step = jax.jit(jsteps.make_train_step(
        jbuild_model(jget_config(arch).reduced()), opt))
    pipe = SyntheticPipeline(cfg, ShapeConfig("cli", args.seq, args.batch,
                                              "train"), DataConfig(seed=0),
                             device="cpu")
    losses = []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v.numpy().astype(np.int32))
                 for k, v in pipe.batch_at(i).items()}
        jstate, m = step(jstate, batch)
        losses.append(float(m["loss"]))
    got = _one_card(arch)
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate["params"])
    for path, w in flat:
        k = "params/" + "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                                 for p in path)
        np.testing.assert_allclose(got["leaves"][k], np.asarray(w),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_sharded_accum_with_mb_specs_matches_accum_1():
    res = run_ranks(train_target, 4,
                    _argv("qwen3_8b", accum=2,
                          extra=("--model-parallel", "2")), None,
                    timeout=110)
    _assert_same_run(res[0], _one_card("qwen3_8b", accum=1))


def test_checkpoint_from_a_mesh_resumes_on_one_process(tmp_path):
    """Two steps on a (2, 2) mesh, checkpointed, then a third on one
    process from that checkpoint: the same as from a one-card run's."""
    resumed = {}
    for where, ranks in (("mesh", 4), ("one", 1)):
        ckpt = str(tmp_path / where)
        first = _argv("qwen3_8b", steps=2,
                      extra=("--ckpt-dir", ckpt, "--ckpt-every", "2"))
        if ranks > 1:
            run_ranks(train_target, ranks, first + ["--model-parallel", "2"],
                      None, timeout=110)
        else:
            train_target(0, first, None)
        resumed[where] = train_target(
            0, _argv("qwen3_8b", steps=STEPS, extra=("--ckpt-dir", ckpt)),
            None)
        assert len(resumed[where]["losses"]) == 1
    _assert_same_run(resumed["mesh"], resumed["one"])


_REF_PSUM = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, sys
sys.path.insert(0, "src")
import jax, numpy as np
import jax.experimental.shard_map as sm
# the installed jax cannot infer the replicated output of the
# reference's shard_map (its check postdates the reference's pin)
_shard_map = sm.shard_map
sm.shard_map = lambda f, **kw: _shard_map(f, check_rep=False, **kw)
from repro.distributed.compression import compressed_psum
x = np.asarray(json.loads(sys.stdin.read()), np.float32)
mesh = jax.make_mesh((4,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
print(json.dumps(np.asarray(compressed_psum(x, mesh)).tolist()))
"""


def _round_trip(x):
    s = np.float32(max(np.abs(x).max(), 1e-12)) / np.float32(127.0)
    return np.clip(np.round(x / s), -127, 127).astype(np.float32) * s


def test_compressed_psum_over_gloo_matches_reference():
    rng = np.random.default_rng(0)
    same = rng.standard_normal((6, 10)).astype(np.float32)
    per_rank = [rng.standard_normal((6, 10)).astype(np.float32)
                for _ in range(4)]
    got_same = run_ranks(psum_target, 4, [same] * 4, timeout=100)
    got_each = run_ranks(psum_target, 4, per_rank, timeout=100)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REF_PSUM],
                       input=json.dumps(same.tolist()), capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=100)
    assert r.returncode == 0, r.stderr[-2000:]
    want_same = np.asarray(json.loads(r.stdout.strip().splitlines()[-1]),
                           np.float32)
    want_each = sum(_round_trip(x) for x in per_rank)
    for rank in range(4):
        np.testing.assert_allclose(got_same[rank], want_same, atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(got_each[rank], want_each, atol=1e-6,
                                   rtol=0)
