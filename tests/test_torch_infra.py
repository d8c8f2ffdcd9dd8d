"""The port's training substrate against the reference's tests of it
(``tests/test_infra.py``): checkpoints (and reading each other's f32
checkpoints), the data pipeline, fault tolerance, int8 error-feedback
compression, the in-place AdamW and the train driver on the CPU.

Each test states its check; the trainer tests are the reference's
``test_trainer_restart_reproduces_loss`` and
``test_train_driver_runs_and_loss_decreases`` with its arguments and
asserts (the reference's own fail on the installed jax: ``ROADMAP.md``).
"""
import json
import os
import shutil
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import SHAPES as JSHAPES
from repro.distributed.compression import make_compressor as jcompressor
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.extractor import extract_sites, meta_batch
from repro_torch.core.vectorizer import baseline_program
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.distributed.compression import make_compressor
from repro_torch.ft.monitor import (PreemptionHandler, StepMonitor,
                                    plan_elastic_mesh)
from repro_torch.launch import train as train_mod
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU tensors: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def _tiny_state():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "blocks": ({"a": torch.ones((2, 2))},)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_zeros_like(v) for v in tree)
    return torch.zeros_like(tree)


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _tiny_state()
    mgr.save(state, 10)
    restored, step = mgr.restore(_zeros_like(state))
    assert step == 10
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert int(restored["step"]) == 7


def test_checkpoint_resume_latest_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    state = _tiny_state()
    for s in (10, 20, 30):
        mgr.save(state, s)
    assert mgr.complete_steps() == [20, 30]   # GC kept 2
    assert mgr.latest_step() == 30


def test_checkpoint_async_and_partial_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _tiny_state()
    mgr.save_async(state, 5)
    # the save copied to the host before returning: an in-place update now
    # (the optimizer's) does not reach the checkpoint
    state["params"]["w"].add_(100.0)
    mgr.wait()
    os.makedirs(tmp_path / "step_000000099", exist_ok=True)
    os.makedirs(tmp_path / "step_000000100.tmp-0", exist_ok=True)
    assert mgr.latest_step() == 5
    restored, _ = mgr.restore(_zeros_like(state))
    assert torch.equal(restored["params"]["w"],
                       torch.arange(6.0).reshape(2, 3))


def test_checkpoint_keeps_bf16_bits(tmp_path):
    """A bf16 leaf is stored as its uint16 bits and named in the manifest;
    it restores bitwise."""
    w = torch.randn((3, 5), generator=torch.Generator().manual_seed(0))
    state = {"w": w.bfloat16(), "m": w.clone()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 1)
    with open(tmp_path / "step_000000001" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["keys"] == ["['m']", "['w']"]
    assert manifest["dtypes"] == ["float32", "bfloat16"]
    data = np.load(tmp_path / "step_000000001" / "host_0.npz")
    assert data["['w']"].dtype == np.uint16
    restored, _ = mgr.restore(_zeros_like(state))
    assert torch.equal(restored["w"].view(torch.int16),
                       state["w"].view(torch.int16))


def test_f32_checkpoints_read_across_both_ways(tmp_path):
    """The reference's CheckpointManager writes, the port's reads, and the
    other way round: same layout, same keys, same numbers."""
    jstate = {"params": {"w": jnp.arange(6.0).reshape(2, 3),
                         "blocks": ({"a": jnp.full((2, 2), 3.0)},)},
              "step": jnp.int32(7)}
    JCheckpointManager(str(tmp_path / "ref")).save(jstate, 4)
    got, step = CheckpointManager(str(tmp_path / "ref")).restore(
        _zeros_like(_tiny_state()))
    assert step == 4 and int(got["step"]) == 7
    np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                  np.asarray(jstate["params"]["w"]))
    np.testing.assert_array_equal(got["params"]["blocks"][0]["a"].numpy(),
                                  np.full((2, 2), 3.0, np.float32))

    CheckpointManager(str(tmp_path / "port")).save(_tiny_state(), 8)
    back, step = JCheckpointManager(str(tmp_path / "port")).restore(
        jax.tree.map(jnp.zeros_like, jstate))
    assert step == 8 and int(back["step"]) == 7
    np.testing.assert_array_equal(np.asarray(back["params"]["w"]),
                                  np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(np.asarray(back["params"]["blocks"][0]["a"]),
                                  np.ones((2, 2)))


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_data_determinism_and_restart():
    cfg = get_config("qwen3_8b").reduced()
    shape = ShapeConfig("t", 64, 8, "train")
    p1 = SyntheticPipeline(cfg, shape, DataConfig(seed=3))
    p2 = SyntheticPipeline(cfg, shape, DataConfig(seed=3))
    b1, b2 = p1.batch_at(17), p2.batch_at(17)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], p1.batch_at(18)["tokens"])
    assert not torch.equal(b1["tokens"], SyntheticPipeline(
        cfg, shape, DataConfig(seed=4)).batch_at(17)["tokens"])
    assert b1["tokens"].shape == (8, 64) and b1["tokens"].dtype == torch.long
    assert torch.equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])


def test_data_host_sharding_differs():
    cfg = get_config("qwen3_8b").reduced()
    shape = ShapeConfig("t", 64, 8, "train")
    a = SyntheticPipeline(cfg, shape, DataConfig(seed=3, host_index=0,
                                                 host_count=2))
    b = SyntheticPipeline(cfg, shape, DataConfig(seed=3, host_index=1,
                                                 host_count=2))
    assert a.local_batch == 4 and a.batch_at(0)["tokens"].shape == (4, 64)
    assert not torch.equal(a.batch_at(0)["tokens"], b.batch_at(0)["tokens"])
    with pytest.raises(ValueError):
        SyntheticPipeline(cfg, shape, DataConfig(host_count=3))


def test_data_follows_the_affine_rule_nine_times_in_ten():
    """The share of next tokens that follow ``(prev * 5 + 7) % V`` lies in
    0.85-0.95 (p = 0.9, plus the rare noise draw that lands on it), and
    every token is in the vocabulary."""
    cfg = get_config("stablelm_3b").reduced()
    b = SyntheticPipeline(cfg, ShapeConfig("t", 256, 16, "train"),
                          DataConfig(seed=0)).batch_at(0)
    tok, tgt = b["tokens"], b["targets"]
    share = float(((tok * 5 + 7) % cfg.vocab_size == tgt).float().mean())
    assert 0.85 <= share <= 0.95, share
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab_size


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_step_monitor_flags_straggler():
    mon = StepMonitor(warmup=3, z_thresh=2.0)
    for i in range(10):
        mon.start()
        mon._t0 -= 0.01           # simulate 10ms steps without sleeping
        assert mon.stop(i) is None
    mon.start()
    mon._t0 -= 1.0                # a 1s step: 100x the mean
    ev = mon.stop(99)
    assert ev is not None and ev["kind"] == "straggler"


def test_preemption_handler():
    h = PreemptionHandler(signals=(signal.SIGUSR1,))
    assert not h.should_stop
    os.kill(os.getpid(), signal.SIGUSR1)
    time.sleep(0.05)
    assert h.should_stop
    h.restore()


def test_elastic_plan():
    p = plan_elastic_mesh(healthy_chips=256, model_parallel=16,
                          global_batch=256)
    assert p.mesh_shape == (16, 16) and p.dropped_chips == 0
    p = plan_elastic_mesh(healthy_chips=250, model_parallel=16,
                          global_batch=256)      # lost 6 chips
    assert p.mesh_shape == (8, 16)               # largest pow2 DP that fits
    assert p.global_batch % p.mesh_shape[0] == 0
    with pytest.raises(AssertionError):
        plan_elastic_mesh(healthy_chips=8, model_parallel=16,
                          global_batch=256)


# ---------------------------------------------------------------------------
# gradient compression, optimizer, shapes
# ---------------------------------------------------------------------------

def test_compression_error_feedback_converges_as_the_references():
    """Over 50 steps the quantized stream integrates to the true sum
    (the reference's check, 1e-2), and each step's output equals the
    reference's compressor's within 1e-6 (f32 rounding of the scale)."""
    rng = np.random.default_rng(0)
    g_np = rng.normal(size=(32,)).astype(np.float32)
    comp = make_compressor({"w": torch.zeros(32)})
    jcomp = jcompressor({"w": jnp.zeros((32,))})
    total = torch.zeros(32)
    for _ in range(50):
        deq, m = comp({"w": torch.from_numpy(g_np)})
        jdeq, jm = jcomp({"w": jnp.asarray(g_np)})
        np.testing.assert_allclose(deq["w"].numpy(), np.asarray(jdeq["w"]),
                                   atol=1e-6)
        np.testing.assert_allclose(float(m["compress_err_sq"]),
                                   float(jm["compress_err_sq"]),
                                   rtol=1e-4, atol=1e-9)
        total = total + deq["w"]
    np.testing.assert_allclose((total / 50).numpy(), g_np, atol=1e-2)


def test_in_place_adamw_chunks_bitwise_and_update_copies(monkeypatch):
    """``update_`` over chunks smaller than a leaf writes, bitwise, what
    it writes over whole leaves, for bf16 matrices (decayed, one gradient
    a transposed view) and f32 vectors; two steps, the second with warm
    moments.  ``update`` gives the same numbers on copies and leaves its
    arguments as they were."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((4, 9), generator=g).bfloat16(),
              "h": torch.randn((3, 5), generator=g).bfloat16(),
              "b": (torch.randn((5,), generator=g),)}
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)

    def fresh():
        p = {k: (v[0].clone(),) if k == "b" else v.clone()
             for k, v in params.items()}
        return p, adamw.init(p)
    whole_p, whole_s = fresh()
    chunk_p, chunk_s = fresh()
    ref_p, ref_s = fresh()
    for _ in range(2):
        grads = {"w": torch.randn((4, 9), generator=g).bfloat16() * 3,
                 "h": torch.randn((5, 3), generator=g).bfloat16().T,
                 "b": (torch.randn((5,), generator=g),)}
        whole_m = adamw.update_(cfg, grads, whole_s, whole_p)
        with monkeypatch.context() as mp:
            mp.setattr(adamw, "CHUNK", 7)
            chunk_m = adamw.update_(cfg, grads, chunk_s, chunk_p)
        before = [t.clone() for t in adamw._leaves((ref_p, ref_s))]
        new_p, new_s, ref_m = adamw.update(cfg, grads, ref_s, ref_p)
        for a, b in zip(adamw._leaves((ref_p, ref_s)), before):
            assert torch.equal(a, b)
        ref_p, ref_s = new_p, new_s
        for p_, s_, m_ in ((chunk_p, chunk_s, chunk_m),
                           (ref_p, ref_s, ref_m)):
            for a, b in zip(adamw._leaves((p_, s_)),
                            adamw._leaves((whole_p, whole_s))):
                assert torch.equal(a, b)
            assert torch.equal(m_["grad_norm"], whole_m["grad_norm"])
            assert torch.equal(m_["lr"], whole_m["lr"])
    assert int(whole_s["step"]) == 2


def test_shapes_are_the_references():
    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in JSHAPES.items()}


# ---------------------------------------------------------------------------
# the train driver on the CPU
# ---------------------------------------------------------------------------

def test_trainer_restart_reproduces_loss(tmp_path):
    """FT end-to-end: train 6 steps; kill; resume from ckpt at 4 and verify
    the loss trajectory matches an uninterrupted run."""
    args = ["--arch", "stablelm_3b", "--steps", "6", "--batch", "4",
            "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--device", "cpu"]
    losses_full = train_mod.main(args)
    # wipe later checkpoints so the resume starts at step 4
    mgr = CheckpointManager(str(tmp_path))
    for s in mgr.complete_steps():
        if s > 4:
            shutil.rmtree(mgr._step_dir(s))
    losses_resumed = train_mod.main(args)
    np.testing.assert_allclose(losses_resumed, losses_full[4:], rtol=1e-4)


def test_train_driver_runs_and_loss_decreases():
    losses = train_mod.main(["--arch", "stablelm_3b", "--steps", "30",
                             "--batch", "8", "--seq", "64",
                             "--lr", "1e-3", "--device", "cpu"])
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_train_driver_accumulates_as_one_batch():
    """--accum 2 takes the same first step as one batch of 4 (the
    reference's test_grad_accum_matches_single_batch, through the
    driver): the loss within 1e-5, every parameter within 2e-5."""
    base = ["--arch", "qwen3_8b", "--steps", "1", "--batch", "4", "--seq",
            "16", "--device", "cpu"]
    r1 = train_mod.run(train_mod.parse_args(base))
    r2 = train_mod.run(train_mod.parse_args(base + ["--accum", "2"]))
    np.testing.assert_allclose(r2.losses, r1.losses, rtol=1e-5)
    for a, b in zip(adamw._leaves(r1.state["params"]),
                    adamw._leaves(r2.state["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)
    assert r1.step_ms == [] and r1.peak_bytes is None     # no card


def test_train_driver_tune_raises_the_kernels_error(tmp_path):
    """--tune injects the program; the first step then raises, as the
    reference's Pallas kernels do under jax.grad, and nothing trains."""
    cfg = get_config("stablelm_3b").reduced()
    model = build_model(cfg)
    sites = extract_sites(lambda p, b: model.train_loss(p, b),
                          model.init(device="meta"), meta_batch(4, 16))
    path = tmp_path / "prog.json"
    baseline_program(sites).save(str(path))
    with pytest.raises(NotImplementedError, match="has no backward"):
        train_mod.main(["--arch", "stablelm_3b", "--steps", "2", "--batch",
                        "4", "--seq", "16", "--tune", str(path),
                        "--device", "cpu"])


def test_train_driver_refuses_several_cards_and_needs_one():
    # a model axis of 2 needs 2 ranks: one process has one, and no
    # process group is left behind
    import torch.distributed as dist
    with pytest.raises(ValueError, match="does not divide the 1 ranks"):
        train_mod.main(["--model-parallel", "2", "--device", "cpu"])
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_mod.main(["--arch", "stablelm_3b", "--steps", "1"])


def test_autotune_and_train_example_on_the_cpu(tmp_path):
    """``examples/torch_autotune_and_train.py``: tunes through the facade,
    saves the program, trains eagerly and the loss falls."""
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "torch_autotune_and_train.py")
    spec = importlib.util.spec_from_file_location("torch_autotune_and_train",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main(["--device", "cpu", "--rl-steps", "300", "--steps", "30",
                    "--out-dir", str(tmp_path)])
    assert res["sites"] > 0 and res["losses"][-1] < res["losses"][0]
    assert (tmp_path / "tiles.json").exists()
    assert (tmp_path / "ckpt").is_dir()     # a save every 50 steps: none
