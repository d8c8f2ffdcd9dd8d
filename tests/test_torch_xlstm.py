"""The port's xLSTM-1.3B (mLSTM and sLSTM blocks, LayerNorm, tied head)
against the JAX model.

Weights come from JAX ``model.init`` through
``repro_torch.convert.params_from_jax``; tokens are numpy from a fixed
seed.  The reduced config is f32, so the tolerances are slice 1's for
Qwen3: the loss within 1e-4 relative, logits within 1e-4 absolute
(summation order only), greedy tokens equal.  Site keys are bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import extractor as jextractor
from repro.core import vectorizer as jvec
from repro.models import xlstm as jxlstm
from repro.models.lm import build_model as jbuild_model
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import extractor
from repro_torch.launch import serve
from repro_torch.models import xlstm
from repro_torch.models.lm import build_model

ARCH = "xlstm_1_3b"
LOGIT_ATOL = 1e-4
B, PROMPT, GEN = 2, 16, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU tensors: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jm = jbuild_model(jget_config(ARCH).reduced())
    tcfg = get_config(ARCH).reduced()
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, build_model(tcfg), tp


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 256, (b, s),
                                                dtype=np.int32)


def _t(a):
    return torch.from_numpy(np.array(a)).long()


def test_converted_tree_is_the_reference_tree(models):
    jm, jp, tm, tp = models
    assert "head" not in tp and "bias" in tp["final_norm"]
    jleaves = jax.tree.leaves(jp)
    tleaves = jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy(), tp, is_leaf=lambda x: isinstance(x,
                                                              torch.Tensor)))
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert np.array_equal(np.asarray(a), b)


def test_train_loss_and_prefill_logits_match_jax(models):
    jm, jp, tm, tp = models
    tok, tgt = _tokens(0, B, 20), _tokens(1, B, 20)   # 20: a padded chunk
    lj, _ = jm.train_loss(jp, {"tokens": jnp.asarray(tok),
                               "targets": jnp.asarray(tgt)})
    lt, _ = tm.train_loss(tp, {"tokens": _t(tok), "targets": _t(tgt)})
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-4)
    cj = jm.make_cache(B, 24, jnp.float32)
    ct = tm.make_cache(B, 24, device="cpu")
    gj, cj = jm.prefill(jp, {"tokens": jnp.asarray(tok)}, cj)
    gt, ct = tm.prefill(tp, {"tokens": _t(tok)}, ct)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=LOGIT_ATOL)
    # the recurrent state the prefill leaves, then one decode step
    for slot in (0, 7):
        for k, v in cj["caches"][slot].items():
            np.testing.assert_allclose(ct["caches"][slot][k].numpy(),
                                       np.asarray(v), rtol=1e-4, atol=1e-4)
    nxt = np.asarray(jnp.argmax(gj, -1))[:, None]
    dj, _ = jm.decode_step(jp, jnp.asarray(nxt, jnp.int32), jnp.int32(20), cj)
    dt, _ = tm.decode_step(tp, _t(nxt), 20, ct)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=LOGIT_ATOL)


def test_mlstm_chunkwise_matches_step_by_step_decode():
    """As ``tests/test_models.py:149-160``: the chunkwise form and the O(1)
    decode recurrence compute the same block."""
    cfg = get_config(ARCH).reduced()
    gen = torch.Generator().manual_seed(0)
    p = xlstm.mlstm_init(cfg, gen, torch.float32, "cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    cache = xlstm.make_mlstm_cache(cfg, 2, "cpu")
    y_chunk = xlstm.apply_mlstm(cfg, p, x, cache=cache, chunk=8)
    state = xlstm.make_mlstm_cache(cfg, 2, "cpu")
    ys = [xlstm.apply_mlstm(cfg, p, x[:, t:t + 1], cache=state,
                            decode_pos=t) for t in range(16)]
    np.testing.assert_allclose(y_chunk.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=1e-3, atol=1e-4)
    for k in cache:                      # the same final state, in place
        np.testing.assert_allclose(cache[k].numpy(), state[k].numpy(),
                                   rtol=1e-3, atol=1e-4)


def test_slstm_block_matches_jax():
    cfg = get_config(ARCH).reduced()
    jcfg = jget_config(ARCH).reduced()
    jp = jxlstm.slstm_init(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal((2, 9, cfg.d_model),
                                                 dtype=np.float32)
    yj, cj = jxlstm.apply_slstm(jcfg, jp, jnp.asarray(x),
                                cache=jxlstm.make_slstm_cache(jcfg, 2))
    cache = xlstm.make_slstm_cache(cfg, 2, "cpu")
    yt = xlstm.apply_slstm(cfg, tp, torch.from_numpy(x), cache=cache)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(cj[k]),
                                   rtol=1e-5, atol=1e-5)


def _jax_serve_sites(cfg, b, prompt, gen):
    model = jbuild_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: model.make_cache(b, prompt + gen,
                                                    jnp.dtype(cfg.dtype)))
    sds = jax.ShapeDtypeStruct
    sites = {s.key() for s in jextractor.extract_sites(
        jsteps.make_prefill_step(model), params,
        {"tokens": sds((b, prompt), jnp.int32)}, cache)}
    sites |= {s.key() for s in jextractor.extract_sites(
        jsteps.make_serve_step(model), params, sds((b, 1), jnp.int32),
        jnp.int32(0), cache)}
    return sites


def test_full_config_site_keys_match_jax():
    """The full xLSTM-1.3B, extracted on ``meta``: train sites and serve
    sites bitwise the reference's."""
    want = {s.key() for s in jextractor.extract_arch_sites(ARCH)}
    got = {s.key() for s in extractor.extract_arch_sites(ARCH)}
    assert got == want and len(got) == 10
    want = _jax_serve_sites(jget_config(ARCH), 4, 512, 16)
    got = {s.key() for s in extractor.extract_serve_sites(
        build_model(get_config(ARCH)), 4, 512, 16)}
    assert got == want and len(got) == 18
    assert "chunk_scan:mlstm.chunk_scan:m256n1024k1024b32:bfloat16:nn:f0" \
        in got


def test_serve_gives_the_greedy_tokens_of_jax(models, tmp_path):
    """``--autotune ppo --inject`` on the CPU, then the JAX model under the
    same program with its Pallas kernels interpreted: same prefill logits
    and greedy tokens."""
    jm, jp, tm, tp = models
    prompts = _tokens(5, B, PROMPT)
    res = serve.run(serve.parse_args([
        "--device", "cpu", "--arch", ARCH, "--batch", str(B), "--prompt-len",
        str(PROMPT), "--gen", str(GEN), "--autotune", "ppo",
        "--autotune-steps", "128", "--inject"]),
        params=tp, prompts=torch.from_numpy(prompts))
    assert len(res.prog.tiles) == 18
    cache = jm.make_cache(B, PROMPT + GEN, jnp.float32)
    with jvec.inject(jvec.TileProgram(dict(res.prog.tiles)), interpret=True):
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
    np.testing.assert_allclose(res.prefill_logits.numpy(), first,
                               atol=LOGIT_ATOL)
    assert np.array_equal(res.seq.numpy(),
                          np.asarray(jnp.concatenate(out, 1)))


def test_inject_guard_checks_the_extracted_sites():
    """``--inject`` on the card needs a tile the kernels launch at every
    site (the launch rule: bf16, and at prefill attention a head dim that
    is a multiple of 8 up to 128): the full xLSTM-1.3B (head_dim 512, no
    attention site) and a bf16 qwen3_8b at head dim 16 pass, the reduced
    f32 configs and a bf16 head dim of 20 are refused."""
    full = get_config(ARCH)
    serve._check_kernel_sites(full, extractor.extract_serve_sites(
        build_model(full), 4, 512, 16))
    for arch in (ARCH, "qwen3_8b"):
        cfg = get_config(arch).reduced()
        sites = extractor.extract_serve_sites(build_model(cfg), 2, 16, 4)
        with pytest.raises(ValueError, match="--full"):
            serve._check_kernel_sites(cfg, sites)
    qwen = get_config("qwen3_8b").reduced(dtype="bfloat16")
    serve._check_kernel_sites(qwen, extractor.extract_serve_sites(
        build_model(qwen), 2, 16, 4))
    qwen = get_config("qwen3_8b").reduced(dtype="bfloat16", head_dim=20)
    with pytest.raises(ValueError, match="head dims \\[20\\]"):
        serve._check_kernel_sites(qwen, extractor.extract_serve_sites(
            build_model(qwen), 2, 16, 4))
