"""The port's StarCoder2-7B, ChatGLM3-6B, Phi-3-Vision-4.2B and
SeamlessM4T-medium against the JAX package's, on the CPU.

What these four bring: the plain GELU MLP (StarCoder2, SeamlessM4T),
GLM's 2-D RoPE (ChatGLM3), the vision frontend's projected prefix
(Phi-3) and the encoder-decoder with cross-attention (SeamlessM4T).
Weights come from JAX ``model.init`` through
``repro_torch.convert.params_from_jax``; inputs are numpy from a fixed
seed, fed to both.  Tolerances (f32, summation order only): logits within
``LOGIT_ATOL`` = 1e-4 absolute, as ``tests/test_torch_models.py``; the
loss within 1e-5 relative and every gradient leaf within 1e-4 absolute,
as ``tests/test_torch_train.py``; site keys bitwise.

Two reference caveats the port keeps: the reference's serve sizes its
cache without Phi-3's frontend prefix (so its own ``prefill`` and
``decode_step`` are run here with a cache of ``n_pre + prompt + gen``
positions), and its decode cross-attention reads the whole memory cache,
zero-padded past the source (held here as it is).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import extractor as jextractor
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models.lm import build_model as jbuild_model
from repro.train import steps as jsteps
from repro_torch.api import NeuroVectorizer
from repro_torch.checkpoint.checkpoint import _flat
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.configs.base import PORTED_ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core import extractor
from repro_torch.core.env import CostModelEnv
from repro_torch.configs.neurovec import DEFAULT
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.launch import serve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention, common
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw

ARCHS = ("starcoder2_7b", "chatglm3_6b", "phi3_vision_4_2b",
         "seamless_m4t_medium")
LOGIT_ATOL = 1e-4
GRAD_ATOL = 1e-4
LOSS_RTOL = 1e-5
B, S, N_DEC = 2, 12, 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU tensors: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _models(arch):
    """(JAX model, JAX params, port model, port params), built once."""
    if arch not in _MODELS:
        jm = jbuild_model(jget_config(arch).reduced())
        tcfg = get_config(arch).reduced()
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                             device="cpu")
        _MODELS[arch] = (jm, jp, build_model(tcfg), tp)
    return _MODELS[arch]


def _batch(cfg, seed, b=B, s=S, targets=False):
    """The same batch for both packages: ``s`` text tokens, a vision
    frontend's embeddings, an encoder-decoder's ``s`` source positions."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (b, s),
                                     dtype=np.int32)}
    if targets:
        arrays["targets"] = rng.integers(0, cfg.vocab_size, (b, s),
                                         dtype=np.int32)
    if cfg.frontend == "vision":
        arrays["frontend_embeds"] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)
    if cfg.enc_dec:
        arrays["src_embeds"] = 0.5 * rng.standard_normal(
            (b, s, cfg.d_model), dtype=np.float32)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: (torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v)) for k, v in arrays.items()}
    return jb, tb


# ---------------------------------------------------------------------------
# the new layers against the reference's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["2d", "1d", "none"])
def test_rope_matches_the_reference(mode):
    x = np.random.default_rng(0).standard_normal((2, 3, 7, 16),
                                                 dtype=np.float32)
    pos = np.arange(5, 12)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0,
                              mode)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10_000.0, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    if mode == "2d":        # the second half passes through untouched
        assert np.array_equal(got[..., 8:].numpy(), x[..., 8:])


@pytest.mark.parametrize("arch", ["starcoder2_7b", "qwen3_8b"])
def test_mlp_matches_the_reference(arch):
    """The plain GELU MLP (``wi``, ``wo``) and the gated SiLU one."""
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jp = jcommon.mlp_init(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert set(tp) == set(common.mlp_init(tcfg, None, torch.float32,
                                          "meta"))
    assert ("wg" in tp) == (tcfg.act == "silu")
    x = np.random.default_rng(1).standard_normal((2, 5, 64),
                                                 dtype=np.float32)
    want = jcommon.apply_mlp(jcfg, jp, jnp.asarray(x))
    got = common.apply_mlp(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_cross_attention_matches_the_reference_in_prefill_and_decode():
    """Prefill: k/v from the memory, written into the first S_src slots of
    a zeroed cache of ctx slots, attention over the memory.  Decode: the
    whole cache, its zero slots included (the reference's caveat)."""
    jcfg = jget_config("seamless_m4t_medium").reduced()
    tcfg = get_config("seamless_m4t_medium").reduced()
    jp = jattention.attn_init(jcfg, jax.random.PRNGKey(5), jnp.float32,
                              cross=True)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 6, 64), dtype=np.float32)
    mem = rng.standard_normal((B, 9, 64), dtype=np.float32)
    ctx = 14
    y_j, kv_j = jattention.apply_cross_attn(jcfg, jp, jnp.asarray(x),
                                            memory=jnp.asarray(mem))
    cache = {k: torch.from_numpy(v) for k, v in jax.tree.map(
        np.array, jattention.make_attn_cache(jcfg, B, ctx,
                                               jnp.float32)).items()}
    y_t = attention.apply_cross_attn(tcfg, tp, torch.from_numpy(x),
                                     memory=torch.from_numpy(mem),
                                     mem_cache=cache)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                               atol=LOGIT_ATOL, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k][:, :, :9].numpy(),
                                   np.asarray(kv_j[k]), atol=1e-5, rtol=0)
        assert not cache[k][:, :, 9:].any()
    # decode over the padded cache, as the reference's decode reads it
    padded = {k: jnp.asarray(cache[k].numpy()) for k in ("k", "v")}
    x1 = rng.standard_normal((B, 1, 64), dtype=np.float32)
    y1_j, _ = jattention.apply_cross_attn(jcfg, jp, jnp.asarray(x1),
                                          mem_cache=padded)
    y1_t = attention.apply_cross_attn(tcfg, tp, torch.from_numpy(x1),
                                      mem_cache=cache)
    np.testing.assert_allclose(y1_t.numpy(), np.asarray(y1_j),
                               atol=LOGIT_ATOL, rtol=0)


def test_cross_attention_has_no_qk_norm():
    cfg = get_config("qwen3_8b").reduced()
    assert "q_norm" in attention.attn_init(cfg, None, torch.float32, "meta")
    assert set(attention.attn_init(cfg, None, torch.float32, "meta",
                                   cross=True)) == {"wq", "wk", "wv", "wo"}


# ---------------------------------------------------------------------------
# each arch at the reduced config: weights, logits, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    """Prefill, then N_DEC greedy decode steps on the cache, each step's
    logits against the reference's.  Phi-3's cache holds its prefix too
    (``n_pre + S + N_DEC`` positions), given to both."""
    jm, jp, tm, tp = _models(arch)
    cfg = tm.cfg
    n_pre = cfg.n_prefix
    ctx = n_pre + S + N_DEC
    jb, tb = _batch(cfg, 3)
    jc = jm.make_cache(B, ctx, jnp.float32)
    tc = tm.make_cache(B, ctx, device="cpu")
    lj, jc = jax.jit(jm.prefill)(jp, jb, jc)
    with torch.no_grad():
        lt, tc = tm.prefill(tp, tb, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_ATOL,
                               rtol=0)
    step = jax.jit(jm.decode_step)
    for i in range(N_DEC):
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)[:, None]
        assert np.array_equal(lt.argmax(-1).numpy(), tok[:, 0])
        pos = n_pre + S + i
        lj, jc = step(jp, jnp.asarray(tok), jnp.int32(pos), jc)
        with torch.no_grad():
            lt, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), pos,
                                    tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   atol=LOGIT_ATOL, rtol=0, err_msg=str(i))
    for name, tree in tc.items():
        for (k, got), (_, want) in zip(_flat(tree),
                                       _flat(jax.tree.map(np.asarray,
                                                          jc[name]))):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4,
                                       rtol=0, err_msg=f"{name}{k}")


def _port_grads(model, params, batch):
    leaves = adamw._leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = model.train_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), adamw._unflatten(params, iter(grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    jm, jp, tm, tp = _models(arch)
    jb, tb = _batch(tm.cfg, 4, targets=True)
    (lj, _), gj = jax.value_and_grad(jm.train_loss, has_aux=True)(jp, jb)
    lt, gt = _port_grads(tm, tp, tb)
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
    want = _flat(jax.tree.map(np.asarray, gj))
    got = _flat(gt)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_trees_match_the_reference(arch):
    """Leaf for leaf, with the depth of each stack (SeamlessM4T: 12
    encoder and 12 decoder layers, where ``n_periods`` says 24)."""
    jshapes = jax.eval_shape(jbuild_model(jget_config(arch)).init,
                             jax.random.PRNGKey(0))
    want = [(k, tuple(v.shape), str(v.dtype))
            for k, v in _flat(jshapes)]
    meta = build_model(get_config(arch)).init(device="meta")
    got = [(k, tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in _flat(meta)]
    assert got == want


# ---------------------------------------------------------------------------
# site keys at full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_site_keys_match_jax_at_full_width(arch):
    want = [s.key() for s in jextractor.extract_arch_sites(arch, batch=4,
                                                           seq=512)]
    got = [s.key() for s in extractor.extract_arch_sites(arch, batch=4,
                                                         seq=512)]
    assert got == want


def _jax_serve_sites(arch, b, prompt, gen):
    """The reference's serve sites, its batch as its serve builds it, at a
    cache of ``n_pre + prompt + gen`` positions (caveat 1)."""
    cfg = jget_config(arch)
    model = jbuild_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    ctx = get_config(arch).n_prefix + prompt + gen
    cache = jax.eval_shape(lambda: model.make_cache(b, ctx,
                                                    jnp.dtype(cfg.dtype)))
    sds = jax.ShapeDtypeStruct
    batch = {"tokens": sds((b, prompt), jnp.int32)}
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = sds((b, cfg.n_frontend_tokens,
                                        cfg.d_model), jnp.float32)
    if cfg.enc_dec:
        batch["src_embeds"] = sds((b, prompt, cfg.d_model), jnp.float32)
    keys = [s.key() for s in jextractor.extract_sites(
        jsteps.make_prefill_step(model), params, batch, cache)]
    keys += [s.key() for s in jextractor.extract_sites(
        jsteps.make_serve_step(model), params, sds((b, 1), jnp.int32),
        jnp.int32(0), cache)]
    return list(dict.fromkeys(keys))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_site_keys_match_jax_at_full_width(arch):
    want = _jax_serve_sites(arch, 4, 512, 16)
    got = [s.key() for s in extractor.extract_serve_sites(
        build_model(get_config(arch)), 4, 512, 16)]
    assert sorted(got) == sorted(want) and len(got) == len(want)


def test_arch_sites_walk_the_seven_ported_archs_in_the_references_order():
    """All ten of the reference's archs are ported (DeepSeek-V2 last), so
    ``arch_sites`` walks the whole list, in its order, leaving none out."""
    from repro_torch.core.dataset import _ARCHS
    assert [a for a in _ARCHS if a in PORTED_ARCHS] == [
        "starcoder2_7b", "qwen3_8b", "stablelm_3b", "chatglm3_6b",
        "deepseek_v2_236b", "llama4_maverick_400b", "xlstm_1_3b",
        "phi3_vision_4_2b", "seamless_m4t_medium", "jamba_v0_1_52b"]
    assert [a for a in _ARCHS if a not in PORTED_ARCHS] == []
    assert list(PORTED_ARCHS) == list(_ARCHS)


# ---------------------------------------------------------------------------
# serve, the pipeline, the train driver and the facade
# ---------------------------------------------------------------------------

def test_phi3_serve_matches_the_references_prefill_and_decode():
    """The port's serve (cache ``n_pre + prompt + gen``, decode at
    ``n_pre + prompt + i``) against the reference's own ``prefill`` and
    ``decode_step`` at that cache size; the reference's serve sizes it
    ``prompt + gen`` and fails here (caveat 1)."""
    jm, jp, tm, tp = _models("phi3_vision_4_2b")
    cfg = tm.cfg
    prompt, gen = 4, 3
    jb, tb = _batch(cfg, 6, s=prompt)
    res = serve.run(serve.parse_args(
        ["--arch", "phi3_vision_4_2b", "--device", "cpu", "--batch", str(B),
         "--prompt-len", str(prompt), "--gen", str(gen)]), params=tp,
        prompts=tb["tokens"], frontend_embeds=tb["frontend_embeds"])
    n_pre = cfg.n_frontend_tokens
    cache = jm.make_cache(B, n_pre + prompt + gen, jnp.float32)
    logits, cache = jax.jit(jm.prefill)(jp, jb, cache)
    np.testing.assert_allclose(res.prefill_logits.numpy(),
                               np.asarray(logits), atol=LOGIT_ATOL, rtol=0)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    out = [tok]
    for i in range(gen - 1):
        logits, cache = jm.decode_step(jp, tok, jnp.int32(n_pre + prompt + i),
                                       cache)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        out.append(tok)
    assert np.array_equal(res.seq.numpy(),
                          np.asarray(jnp.concatenate(out, 1)))


def test_seamless_serve_runs_on_the_reference_inputs():
    """The port's serve of SeamlessM4T with the reference's source
    embeddings: its greedy tokens and prefill logits are the reference's
    prefill and decode at the serve's cache."""
    jm, jp, tm, tp = _models("seamless_m4t_medium")
    prompt, gen = 5, 3
    jb, tb = _batch(tm.cfg, 7, s=prompt)
    res = serve.run(serve.parse_args(
        ["--arch", "seamless_m4t_medium", "--device", "cpu", "--batch",
         str(B), "--prompt-len", str(prompt), "--gen", str(gen)]),
        params=tp, prompts=tb["tokens"], src_embeds=tb["src_embeds"])
    cache = jm.make_cache(B, prompt + gen, jnp.float32)
    logits, cache = jax.jit(jm.prefill)(jp, jb, cache)
    np.testing.assert_allclose(res.prefill_logits.numpy(),
                               np.asarray(logits), atol=LOGIT_ATOL, rtol=0)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    out = [tok]
    for i in range(gen - 1):
        logits, cache = jm.decode_step(jp, tok, jnp.int32(prompt + i), cache)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        out.append(tok)
    assert np.array_equal(res.seq.numpy(),
                          np.asarray(jnp.concatenate(out, 1)))


def test_serve_refuses_an_input_the_arch_does_not_take():
    with pytest.raises(ValueError, match="src_embeds"):
        serve.run(serve.parse_args(
            ["--arch", "starcoder2_7b", "--device", "cpu", "--batch", "1",
             "--prompt-len", "4", "--gen", "2"]),
            src_embeds=torch.zeros((1, 4, 64)))


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_batch_keys_shapes_and_dtypes_match_the_reference(arch):
    shape = ShapeConfig("t", 32, 4, "train")
    jcfg, tcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    want = JPipeline(jcfg, JShapeConfig("t", 32, 4, "train"),
                     JDataConfig(seed=0)).batch_at(0)
    got = SyntheticPipeline(tcfg, shape, DataConfig(seed=0)).batch_at(0)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert got[k].is_floating_point() == jnp.issubdtype(v.dtype,
                                                            jnp.floating)
    for k in ("frontend_embeds", "src_embeds"):
        if k in got:
            assert got[k].dtype == torch.float32
            assert 0.01 < float(got[k].std()) < 0.03
    again = SyntheticPipeline(tcfg, shape, DataConfig(seed=0)).batch_at(0)
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_driver_takes_three_cpu_steps(arch):
    res = ttrain.run(ttrain.parse_args(
        ["--arch", arch, "--steps", "3", "--batch", "4", "--seq", "24",
         "--lr", "1e-3", "--device", "cpu"]))
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    assert all(np.isfinite(g) and g > 0 for g in res.grad_norms)


def test_facade_tunes_seamless_on_the_cpu_route():
    nv = NeuroVectorizer(DEFAULT, agent="baseline",
                         oracle=CostModelEnv(DEFAULT, legality="tpu_v5e"),
                         device="cpu")
    prog = nv.tune_arch("seamless_m4t_medium", batch=2, seq=128)
    keys = {s.key() for s in extractor.extract_arch_sites(
        "seamless_m4t_medium", batch=2, seq=128)}
    assert set(prog.tiles) == keys
    assert any(":xattn.core:" in k for k in keys)
    nv.close()


def test_the_seamless_lm_head_never_splits_k():
    """K1's plan at ``4x256206x1024``: every legal tile of the action grid
    leaves at least 501 output CTAs, more than the card's 132 SMs, so no
    tile takes ``split_k`` there (``ops.matmul_launch_plan``)."""
    import itertools
    from repro_torch.kernels import ops
    M, N, K = 4, 256206, 1024
    plans = [ops.matmul_launch_plan(M, N, K, t, 132)
             for t in itertools.product(DEFAULT.bm_choices,
                                        DEFAULT.bn_choices,
                                        DEFAULT.bk_choices)]
    legal = [p for p in plans if p is not None]
    assert legal and {p.variant for p in legal} == {"tma_wgmma"}
    assert min(p.grid_m * p.grid_n for p in legal) >= 501


def test_phi3_refuses_the_baseline_attention_tile_as_the_reference_does():
    """Phi-3's full-width prefill attends over 768 positions (256 prefix
    rows and 512 prompt tokens).  The baseline heuristic's ``(128, 512)``
    does not divide them: the reference's kernel asserts, and the port's
    K2 raises on every device, so ``--tiles baseline --inject`` cannot
    serve Phi-3 at full width in either package."""
    from repro.core import costmodel as jcostmodel
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro_torch.core import costmodel
    from repro_torch.kernels import ops
    sites = [s for s in extractor.extract_serve_sites(
        build_model(get_config("phi3_vision_4_2b")), 4, 512, 16)
        if s.kind == "attention" and s.m > 1]          # the prefill's
    assert sites and {(s.m, s.k) for s in sites} == {(768, 768)}
    for s in sites:
        assert (costmodel.baseline_tiles(s)
                == jcostmodel.baseline_tiles(s) == (128, 512))
    x = np.random.default_rng(0).standard_normal((1, 1, 768, 8),
                                                 np.float32)
    with pytest.raises(AssertionError):
        flash_attention_pallas(jnp.asarray(x), jnp.asarray(x),
                               jnp.asarray(x), causal=True, scale=0.5,
                               block_q=128, block_kv=512, interpret=True)
    t = torch.from_numpy(x)
    for tiles in ((128, 512, 512), None):     # the baseline, as given and
        with pytest.raises(ValueError, match="must divide"):    # by default
            ops.flash_attention(t, t, t, causal=True, scale=0.5,
                                tiles=tiles)
