"""The port's dense decoder (reduced qwen3_8b, f32) against the JAX model.

Weights come from JAX ``model.init`` and are carried across with
``repro_torch.convert.params_from_jax``; token ids are numpy from a fixed
seed.  The JAX model runs in its default ``xla`` mode.  Tolerances: the
training loss within 1e-4 relative, logits within 1e-4 absolute (both
compute in f32 and differ only in summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import extractor as jextractor
from repro.models import common as jcommon
from repro.models import compute as jcompute
from repro.models.lm import build_model as jbuild_model
from repro.train import steps as jsteps
from repro_torch.configs import BlockDesc, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import extractor
from repro_torch.core.vectorizer import TileProgram, baseline_program, inject
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.models import common, compute
from repro_torch.models.lm import build_model

LOGIT_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU tensors: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(n_layers=2):
    jcfg = jget_config("qwen3_8b").reduced(n_layers=n_layers)
    tcfg = get_config("qwen3_8b").reduced(n_layers=n_layers)
    jm, tm = jbuild_model(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def models():
    return _models()


def _tokens(seed, B, S, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


# ---------------------------------------------------------------------------
# weights and forward numerics
# ---------------------------------------------------------------------------

def test_converted_weights_are_the_same_numbers(models):
    jm, jp, tm, tp = models
    assert np.array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))
    wq = jp["blocks"][0]["mixer"]["wq"]
    assert tp["blocks"][0]["mixer"]["wq"].shape == wq.shape
    assert np.array_equal(tp["blocks"][0]["mixer"]["wq"].numpy(),
                          np.asarray(wq))


def test_convert_rejects_a_tree_of_another_shape(models):
    jm, jp, tm, tp = models
    bad = jax.tree.map(np.asarray, jp)
    bad["head"] = bad["head"][:, :8]
    with pytest.raises(ValueError, match="head"):
        params_from_jax(bad, tm.cfg, device="cpu")


def test_convert_without_cuda_needs_the_cpu_asked_for(models):
    jm, jp, tm, tp = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(jax.tree.map(np.asarray, jp), tm.cfg)


def test_train_loss_matches_jax(models):
    jm, jp, tm, tp = models
    tok, tgt = _tokens(0, 2, 16), _tokens(1, 2, 16)
    lj, _ = jm.train_loss(jp, {"tokens": jnp.asarray(tok),
                               "targets": jnp.asarray(tgt)})
    lt, _ = tm.train_loss(tp, {"tokens": torch.from_numpy(tok).long(),
                               "targets": torch.from_numpy(tgt).long()})
    assert float(lt) == pytest.approx(float(lj), rel=1e-4)


def test_prefill_and_decode_logits_match_jax(models):
    """Prefill of 12 tokens, then 4 greedy decode steps on the cache."""
    jm, jp, tm, tp = models
    B, S, n_dec = 2, 12, 4
    tok = _tokens(2, B, S)
    jc = jm.make_cache(B, S + n_dec, jnp.float32)
    tc = tm.make_cache(B, S + n_dec, device="cpu")
    lj, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tok)}, jc)
    with torch.no_grad():
        lt, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok).long()}, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_ATOL,
                               rtol=0)
    # prefill wrote the fresh k/v into the first S slots of the cache
    np.testing.assert_allclose(tc["caches"][0]["k"].numpy(),
                               np.asarray(jc["caches"][0]["k"]),
                               atol=1e-5, rtol=0)
    dec = jax.jit(jm.decode_step)
    for i in range(n_dec):
        nxt = np.array(jnp.argmax(lj, -1), np.int32)[:, None]
        lj, jc = dec(jp, jnp.asarray(nxt), jnp.int32(S + i), jc)
        with torch.no_grad():
            lt, tc = tm.decode_step(tp, torch.from_numpy(nxt).long(), S + i,
                                    tc)
        assert lt.dtype == torch.float32 and lt.shape == (B, 256)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   atol=LOGIT_ATOL, rtol=0)


def test_kernel_mode_matches_eager_mode_on_cpu(models):
    """Under ``inject`` the CPU takes the kernels' plain versions; the
    logits agree with eager mode."""
    _, _, tm, tp = models
    tok = torch.from_numpy(_tokens(3, 2, 16)).long()
    sites = extractor.extract_serve_sites(tm, 2, 16, 1)
    with torch.no_grad():
        le, _ = tm.prefill(tp, {"tokens": tok}, tm.make_cache(2, 17, device="cpu"))
        with inject(baseline_program(sites)):
            lk, _ = tm.prefill(tp, {"tokens": tok},
                               tm.make_cache(2, 17, device="cpu"))
    np.testing.assert_allclose(lk.numpy(), le.numpy(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# compute wrappers and layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_decode_attention_branch_matches_jax(hq, hkv):
    """Sq == 1 over a cache, masked to positions <= base_offset."""
    q = _normal(0, 2, hq, 1, 16)
    k, v = _normal(1, 2, hkv, 20, 16), _normal(2, 2, hkv, 20, 16)
    yj = jcompute.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), site="a", causal=True,
                                  base_offset=11)
    yt = compute.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), site="a", causal=True,
                                 base_offset=11)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_prefill_attention_matches_jax(causal):
    q = _normal(3, 2, 8, 32, 16)
    k, v = _normal(4, 2, 2, 32, 16), _normal(5, 2, 2, 32, 16)
    yj = jcompute.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), site="a", causal=causal,
                                  q_chunk=16, kv_chunk=8)
    yt = compute.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), site="a",
                                 causal=causal, q_chunk=16, kv_chunk=8)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=2e-6)


def test_rope_and_norms_match_jax():
    x = _normal(6, 2, 4, 9, 16)
    pos = np.arange(3, 12)
    np.testing.assert_allclose(
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          1e6).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      1e6)), atol=1e-5)
    scale = _normal(7, 16)
    np.testing.assert_allclose(
        common.rms_head_norm(torch.from_numpy(x),
                             torch.from_numpy(scale)).numpy(),
        np.asarray(jcommon.rms_head_norm(jnp.asarray(x),
                                         jnp.asarray(scale))), atol=1e-6)
    h = _normal(8, 2, 5, 64)
    p = {"scale": _normal(9, 64)}
    np.testing.assert_allclose(
        common.apply_norm({"scale": torch.from_numpy(p["scale"])},
                          torch.from_numpy(h)).numpy(),
        np.asarray(jcommon.apply_norm(jget_config("qwen3_8b").reduced(),
                                      {"scale": jnp.asarray(p["scale"])},
                                      jnp.asarray(h))), atol=1e-6)


def test_site_keys_use_the_jax_dtype_names():
    rec = compute.SiteRecorder()
    x = torch.empty((3, 8, 64), dtype=torch.bfloat16, device="meta")
    w = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
    with compute.compute_mode("eager", recorder=rec):
        compute.matmul(x, w, site="mlp.up")
    (s,) = rec.unique_sites()
    assert s.key() == "matmul:mlp.up:m24n32k64b1:bfloat16:nn:f0"


def test_recording_in_kernel_mode_never_reaches_a_wrapper():
    """Extraction on ``meta`` tensors records sites and launches nothing,
    whatever the mode."""
    before = (kmm.launches, kfa.launches)
    rec = compute.SiteRecorder()
    q = torch.empty((1, 4, 8, 16), device="meta")
    with compute.compute_mode("kernel", tiles={}, recorder=rec):
        compute.matmul(torch.empty((8, 16), device="meta"),
                       torch.empty((16, 4), device="meta"), site="m")
        compute.flash_attention(q, q, q, site="a", causal=True)
    assert len(rec.unique_sites()) == 2
    assert (kmm.launches, kfa.launches) == before


def test_unknown_mode_and_arch_raise():
    with pytest.raises(ValueError, match="mode"):
        with compute.compute_mode("pallas"):
            pass
    with pytest.raises(ValueError, match="not ported"):
        get_config("starcoder2_7b")


@pytest.mark.parametrize("change", [dict(mla=True), dict(act="gelu"),
                                    dict(rope="2d"),
                                    dict(period=(BlockDesc("mamba",
                                                           "dense"),))])
def test_unported_model_paths_are_refused(change):
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen3_8b").reduced(), **change)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_model(cfg)


# ---------------------------------------------------------------------------
# site extraction (meta tensors vs jax.eval_shape)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,seq", [(8, 2048), (4, 512)])
def test_train_site_keys_match_jax(batch, seq):
    want = {s.key() for s in jextractor.extract_arch_sites(
        "qwen3_8b", batch=batch, seq=seq)}
    got = {s.key() for s in extractor.extract_arch_sites(
        "qwen3_8b", batch=batch, seq=seq)}
    assert got == want


def _jax_serve_sites(cfg, B, prompt, gen):
    model = jbuild_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: model.make_cache(B, prompt + gen,
                                                    jnp.dtype(cfg.dtype)))
    sds = jax.ShapeDtypeStruct
    sites = {s.key() for s in jextractor.extract_sites(
        jsteps.make_prefill_step(model), params,
        {"tokens": sds((B, prompt), jnp.int32)}, cache)}
    sites |= {s.key() for s in jextractor.extract_sites(
        jsteps.make_serve_step(model), params, sds((B, 1), jnp.int32),
        jnp.int32(0), cache)}
    return sites


@pytest.mark.parametrize("B,prompt,gen", [(4, 512, 16), (2, 64, 8)])
def test_serve_site_keys_match_jax_at_full_width(B, prompt, gen):
    want = _jax_serve_sites(jget_config("qwen3_8b"), B, prompt, gen)
    got = {s.key() for s in extractor.extract_serve_sites(
        build_model(get_config("qwen3_8b")), B, prompt, gen)}
    assert got == want
    assert len(got) == 17


def test_serve_program_from_jax_sites_covers_the_port(tmp_path):
    """A TileProgram keyed by the JAX serve sites names every port site."""
    keys = _jax_serve_sites(jget_config("qwen3_8b").reduced(), 2, 16, 4)
    prog = TileProgram({k: (8, 128, 128) for k in keys})
    prog.save(str(tmp_path / "p.json"))
    sites = extractor.extract_serve_sites(
        build_model(get_config("qwen3_8b").reduced()), 2, 16, 4)
    loaded = TileProgram.load(str(tmp_path / "p.json"))
    assert {s.key() for s in sites} == set(loaded.tiles)
