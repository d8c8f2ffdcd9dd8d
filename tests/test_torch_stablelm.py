"""The port's StableLM-3B (LayerNorm with bias, gated SiLU, 1-D RoPE at
head dim 80, MHA) against the JAX model.

Weights come from JAX ``model.init`` through
``repro_torch.convert.params_from_jax``; tokens are numpy from a fixed
seed.  The reduced config is f32, so the tolerances are
``tests/test_torch_models.py``'s for Qwen3: the training loss within 1e-4
relative, logits within 1e-4 absolute (summation order only), greedy
tokens equal.  Site keys at full width are bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import extractor as jextractor
from repro.core import vectorizer as jvec
from repro.models import common as jcommon
from repro.models.lm import build_model as jbuild_model
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import extractor
from repro_torch.launch import serve
from repro_torch.models import common
from repro_torch.models.lm import build_model

ARCH = "stablelm_3b"
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


def test_config_is_the_references():
    t, j = get_config(ARCH), jget_config(ARCH)
    for f in dataclasses.fields(t):
        if f.name == "period":
            assert [(b.kind, b.mlp) for b in t.period] == \
                [(b.kind, b.mlp) for b in j.period]
        else:
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.head_dim,
            t.d_ff, t.vocab_size, t.norm, t.dtype) == (
        32, 2560, 32, 32, 80, 6912, 50304, "layernorm", "bfloat16")


def test_full_width_site_keys_match_jax():
    """Train sites at the reference test's batch 4, seq 512, and serve
    sites at batch 4, prompt 512, 16 generated, extracted on ``meta``."""
    want = [s.key() for s in jextractor.extract_arch_sites(ARCH, batch=4,
                                                           seq=512)]
    got = [s.key() for s in extractor.extract_arch_sites(ARCH, batch=4,
                                                         seq=512)]
    assert got == want
    assert "attention:attn.core:m512n80k512b128:bfloat16:nn:c:f0" in got
    jcfg = jget_config(ARCH)
    model = jbuild_model(jcfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: model.make_cache(4, 528,
                                                    jnp.dtype(jcfg.dtype)))
    sds = jax.ShapeDtypeStruct
    want = {s.key() for s in jextractor.extract_sites(
        jsteps.make_prefill_step(model), params,
        {"tokens": sds((4, 512), jnp.int32)}, cache)}
    want |= {s.key() for s in jextractor.extract_sites(
        jsteps.make_serve_step(model), params, sds((4, 1), jnp.int32),
        jnp.int32(0), cache)}
    got = {s.key() for s in extractor.extract_serve_sites(
        build_model(get_config(ARCH)), 4, 512, 16)}
    assert got == want and len(got) == 17


def test_rope_at_half_width_40_matches_jax():
    """1-D RoPE over head dim 80: 40 interleaved pairs."""
    x = np.random.default_rng(3).standard_normal((2, 4, 12, 80),
                                                 dtype=np.float32)
    pos = np.arange(5, 17)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_train_loss_and_logits_match_jax(models):
    jm, jp, tm, tp = models
    tok, tgt = _tokens(0, B, 16), _tokens(1, B, 16)
    lj, _ = jm.train_loss(jp, {"tokens": jnp.asarray(tok),
                               "targets": jnp.asarray(tgt)})
    lt, _ = tm.train_loss(tp, {"tokens": _t(tok), "targets": _t(tgt)})
    assert float(lt) == pytest.approx(float(lj), rel=1e-4)
    jc = jm.make_cache(B, 20, jnp.float32)
    tc = tm.make_cache(B, 20, device="cpu")
    gj, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tok)}, jc)
    with torch.no_grad():
        gt, tc = tm.prefill(tp, {"tokens": _t(tok)}, tc)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=LOGIT_ATOL,
                               rtol=0)
    dec = jax.jit(jm.decode_step)
    for i in range(3):
        nxt = np.array(jnp.argmax(gj, -1), np.int32)[:, None]
        gj, jc = dec(jp, jnp.asarray(nxt), jnp.int32(16 + i), jc)
        with torch.no_grad():
            gt, tc = tm.decode_step(tp, _t(nxt), 16 + i, tc)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj),
                                   atol=LOGIT_ATOL, rtol=0)


def test_serve_gives_the_greedy_tokens_of_jax(models):
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
    assert len(res.prog.tiles) == 17
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
