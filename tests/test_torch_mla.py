"""The port's Multi-head Latent Attention and DeepSeek-V2 against the JAX
package's, on the CPU.

MLA (``models/mla.py``): prefill and train in the expanded form, whose
attention has a head dim D = qk_nope + qk_rope (24 at the reduced config,
192 at full width) and a value dim Dv = v_head_dim of its own (16, 128);
decode in the absorbed form against a cache of the latent and the RoPE
key.  The reference's Pallas flash kernel sizes v, out and its
accumulator by D (``repro/kernels/flash_attention.py:76-95``) and cannot
run Dv != D, so everything here is held against the reference's ``xla``
mode (its ``compute.flash_attention`` takes Dv != D there, ``:201``);
the port's kernel mode runs K2's plain version on the CPU.

Weights come from the reference's init (through
``repro_torch.convert.params_from_jax`` for a model); inputs are numpy
from a fixed seed, fed to both.  Tolerances (f32, summation order only),
as ``tests/test_torch_moe_ssm.py``: the layer at 1e-5 of each quantity's
largest |value|; logits at 1e-4 absolute, the loss at 1e-5 relative and
every gradient leaf at 1e-4 absolute; site keys and the corpus bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import ARCH_IDS
from repro.core import dataset as jdataset
from repro.core import extractor as jextractor
from repro.models import mla as jmla
from repro.models.lm import build_model as jbuild_model
from repro.train import steps as jsteps
from repro_torch.checkpoint.checkpoint import _flat
from repro_torch.configs import get_config
from repro_torch.configs.base import PORTED_ARCHS
from repro_torch.convert import params_from_jax
from repro_torch.core import dataset, extractor
from repro_torch.core.vectorizer import baseline_program, inject
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import compute, mla
from repro_torch.models.compute import KernelSite
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw

ARCH = "deepseek_v2_236b"
LAYER_TOL = 1e-5
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


def _close(got, want, what, tol=LAYER_TOL):
    """``got`` within ``tol`` of ``want``'s largest |value| (and at least
    ``tol`` absolute)."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0,
                               err_msg=what)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _cfgs(**change):
    """The reduced config in both packages (d 64, 4 heads, kv_lora 32,
    q_lora 48, D = 16 + 8, Dv = 16, 4 experts top-2), with ``change``."""
    return (jget_config(ARCH).reduced(**change),
            get_config(ARCH).reduced(**change))


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def _fields(cfg):
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["period"] = [(b.kind, b.mlp) for b in cfg.period]
    return out


@pytest.mark.parametrize("reduced", [False, True])
def test_config_is_the_references(reduced):
    """Every field, the MLA ranks and dims and the recorded deviation
    (MoE in every layer) among them, full width and reduced."""
    j, t = jget_config(ARCH), get_config(ARCH)
    if reduced:
        j, t = j.reduced(), t.reduced()
    assert _fields(t) == _fields(j)
    assert t.mla and t.period[0].mlp == "moe"
    if reduced:
        assert (t.kv_lora_rank, t.q_lora_rank, t.qk_nope_dim, t.qk_rope_dim,
                t.v_head_dim) == (32, 48, 16, 8, 16)
    else:
        assert (t.kv_lora_rank, t.qk_nope_dim + t.qk_rope_dim,
                t.v_head_dim) == (512, 192, 128)


def test_every_reference_arch_is_ported_in_its_order():
    assert PORTED_ARCHS == ARCH_IDS
    assert len(PORTED_ARCHS) == 10
    for arch in PORTED_ARCHS:
        build_model(get_config(arch).reduced())     # nothing refused


# ---------------------------------------------------------------------------
# the MLA layer
# ---------------------------------------------------------------------------

def _layer(q_lora: bool, seed=11):
    change = {} if q_lora else {"q_lora_rank": 0}
    cfg_j, cfg_t = _cfgs(**change)
    jp = jmla.mla_init(cfg_j, jax.random.PRNGKey(seed), jnp.float32)
    # norm scales away from 1, so that a missed scale shows
    rng = np.random.default_rng(seed)
    for k in ("kv_norm", "q_norm"):
        if k in jp:
            jp[k] = jnp.asarray(rng.uniform(0.5, 1.5, jp[k].shape)
                                .astype(np.float32))
    return cfg_j, cfg_t, jp, _to_torch(jp)


@pytest.mark.parametrize("q_lora", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_apply_mla_prefill_matches_jax(q_lora, causal):
    """The expanded form (K2's D = 24, Dv = 16) without a cache: the
    output at 1e-5 of its largest |value|."""
    cfg_j, cfg_t, jp, tp = _layer(q_lora)
    x = np.random.default_rng(1).standard_normal((B, S, cfg_t.d_model),
                                                 dtype=np.float32)
    yj, cj = jmla.apply_mla(cfg_j, jp, jnp.asarray(x),
                            positions=jnp.arange(S), causal=causal)
    assert cj is None
    with torch.no_grad():
        yt = mla.apply_mla(cfg_t, tp, torch.from_numpy(x),
                           positions=torch.arange(S), causal=causal)
    _close(yt, yj, "y")
    assert set(tp) == ({"wkv_a", "kv_norm", "w_uk", "w_uv", "wo"}
                       | ({"wq_a", "q_norm", "wq_b"} if q_lora else {"wq"}))


@pytest.mark.parametrize("q_lora", [True, False])
def test_apply_mla_cache_then_absorbed_decode_match_jax(q_lora):
    """Prefill into a zeroed cache of S + 4 positions (the port writes the
    first S in place; the reference returns the S it computed), then 4
    absorbed decode steps: each output and the cache after each."""
    cfg_j, cfg_t, jp, tp = _layer(q_lora, seed=12)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, cfg_t.d_model), dtype=np.float32)
    jc = jmla.make_mla_cache(cfg_j, B, S + 4, jnp.float32)
    tc = mla.make_mla_cache(cfg_t, B, S + 4, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: tuple(v.shape) for k, v in jc.items()}
    yj, pc = jmla.apply_mla(cfg_j, jp, jnp.asarray(x),
                            positions=jnp.arange(S), causal=True, cache=jc)
    jc = {"c_kv": jc["c_kv"].at[:, :S].set(pc["c_kv"]),
          "k_rope": jc["k_rope"].at[:, :, :S].set(pc["k_rope"])}
    with torch.no_grad():
        yt = mla.apply_mla(cfg_t, tp, torch.from_numpy(x),
                           positions=torch.arange(S), causal=True, cache=tc)
    _close(yt, yj, "prefill y")
    for k in ("c_kv", "k_rope"):
        _close(tc[k], jc[k], f"prefill cache {k}")
    for i in range(4):
        x1 = rng.standard_normal((B, 1, cfg_t.d_model), dtype=np.float32)
        pos = S + i
        yj, jc = jmla.apply_mla(cfg_j, jp, jnp.asarray(x1),
                                positions=jnp.arange(pos, pos + 1),
                                causal=True, cache=jc, decode_pos=pos)
        with torch.no_grad():
            yt = mla.apply_mla(cfg_t, tp, torch.from_numpy(x1),
                               positions=torch.arange(pos, pos + 1),
                               causal=True, cache=tc, decode_pos=pos)
        _close(yt, yj, f"decode {i} y")
        for k in ("c_kv", "k_rope"):
            _close(tc[k], jc[k], f"decode {i} cache {k}")


def test_the_attention_function_takes_a_value_dim_of_its_own():
    """The memory-efficient attention ``Function`` (train's path) at D =
    24, Dv = 16 in f64: gradcheck holds its backward, and its forward is
    K2's plain version."""
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.standard_normal((1, 2, 8, 24)))
            .requires_grad_(True) for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((1, 2, 8, 16))) \
        .requires_grad_(True)

    def f(q, k, v):
        return compute._mem_efficient_attention(q, k, v, causal=True,
                                                scale=24 ** -0.5, bq=4,
                                                bkv=4)
    assert torch.autograd.gradcheck(f, (q, k, v))
    with torch.no_grad():
        want = kfa.flash_attention_plain(q, k, v, causal=True,
                                         scale=24 ** -0.5, bq=4, bkv=4)
        assert torch.allclose(f(q, k, v), want, atol=1e-12)


# ---------------------------------------------------------------------------
# DeepSeek-V2 at the reduced config, 1 and 2 layers
# ---------------------------------------------------------------------------

_MODELS = {}


def _models(n_layers):
    """(JAX model, JAX params, port model, port params), built once."""
    if n_layers not in _MODELS:
        cfg_j, cfg_t = _cfgs(n_layers=n_layers)
        jm = jbuild_model(cfg_j)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg_t,
                             device="cpu")
        _MODELS[n_layers] = (jm, jp, build_model(cfg_t), tp)
    return _MODELS[n_layers]


def _batch(cfg, seed, targets=False):
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                     dtype=np.int32)}
    if targets:
        arrays["targets"] = rng.integers(0, cfg.vocab_size, (B, S),
                                         dtype=np.int32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v).long() for k, v in arrays.items()})


def _caches_close(tc, jc, what):
    got = _flat(tc["caches"])
    want = _flat(jax.tree.map(np.asarray, jc["caches"]))
    assert [k for k, _ in got] == [k for k, _ in want]
    assert {k.split("'")[-2] for k, _ in got} == {"c_kv", "k_rope"}
    for (k, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("n_layers", [1, 2])
def test_prefill_cache_and_absorbed_decode_match_jax(n_layers):
    """Prefill, the MLA cache after it, then N_DEC greedy absorbed decode
    steps: each step's logits and the cache after the last."""
    jm, jp, tm, tp = _models(n_layers)
    ctx = S + N_DEC
    jb, tb = _batch(tm.cfg, 3)
    jc = jm.make_cache(B, ctx, jnp.float32)
    tc = tm.make_cache(B, ctx, device="cpu")
    lj, jc = jax.jit(jm.prefill)(jp, jb, jc)
    with torch.no_grad():
        lt, tc = tm.prefill(tp, tb, tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_ATOL,
                               rtol=0)
    _caches_close(tc, jc, "prefill")
    step = jax.jit(jm.decode_step)
    for i in range(N_DEC):
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)[:, None]
        assert np.array_equal(lt.argmax(-1).numpy(), tok[:, 0])
        lj, jc = step(jp, jnp.asarray(tok), jnp.int32(S + i), jc)
        with torch.no_grad():
            lt, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), S + i,
                                    tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   atol=LOGIT_ATOL, rtol=0, err_msg=str(i))
    _caches_close(tc, jc, "decode")


def _port_grads(model, params, batch):
    leaves = adamw._leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, metrics = model.train_loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            adamw._unflatten(params, iter(grads)))


@pytest.mark.parametrize("n_layers", [1, 2])
def test_loss_and_every_gradient_match_jax(n_layers):
    """The loss (cross-entropy plus the MoE losses) and the gradient of
    every leaf, the MLA ones through the attention ``Function`` at Dv !=
    D among them."""
    jm, jp, tm, tp = _models(n_layers)
    jb, tb = _batch(tm.cfg, 4, targets=True)
    (lj, mj), gj = jax.value_and_grad(jm.train_loss, has_aux=True)(jp, jb)
    lt, mt, gt = _port_grads(tm, tp, tb)
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
    for k in mt:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    want = _flat(jax.tree.map(np.asarray, gj))
    got = _flat(gt)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert any("w_uv" in k for k, _ in got)
    for (k, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_kernel_mode_on_the_cpu_matches_jax(n_layers):
    """The port's kernel mode under the baseline program: on CPU tensors
    K1 and K2 take their plain versions (K2 at D = 24, Dv = 16, launching
    nothing), and the prefill and decode logits are the reference's."""
    jm, jp, tm, tp = _models(n_layers)
    jb, tb = _batch(tm.cfg, 5)
    sites = extractor.extract_serve_sites(tm, B, S, N_DEC)
    att = [s for s in sites if s.site == "mla.core" and s.m > 1]
    assert [(s.n, s.m, s.k) for s in att] == [(24, S, S)]
    prog = baseline_program(sites)
    jc = jm.make_cache(B, S + N_DEC, jnp.float32)
    lj, jc = jax.jit(jm.prefill)(jp, jb, jc)
    before = (kfa.launches, ops.kmm.launches)
    with torch.no_grad(), inject(prog):
        lt, tc = tm.prefill(tp, tb, tm.make_cache(B, S + N_DEC,
                                                  device="cpu"))
        tok = lt.argmax(-1)[:, None]
        lj2, _ = jax.jit(jm.decode_step)(
            jp, jnp.asarray(tok.int().numpy()), jnp.int32(S), jc)
        lt2, _ = tm.decode_step(tp, tok, S, tc)
    assert (kfa.launches, ops.kmm.launches) == before
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(lt2.numpy(), np.asarray(lj2),
                               atol=LOGIT_ATOL, rtol=0)


def test_params_from_jax_carries_every_leaf_exactly():
    """The reduced config's converted weights equal the reference's bit
    for bit: the MLA leaves and the MoE's among them."""
    jm, jp, tm, tp = _models(2)
    want = _flat(jax.tree.map(np.asarray, jp))
    got = _flat(tp)
    assert [k for k, _ in got] == [k for k, _ in want]
    leaves = {k.split("'")[-2] for k, _ in got}
    assert {"wkv_a", "kv_norm", "w_uk", "w_uv", "wo", "wq_a", "q_norm",
            "wq_b", "router", "ewi", "shared_wi"} <= leaves
    for (k, g), (_, w) in zip(got, want):
        assert np.array_equal(g.numpy(), w), k


# ---------------------------------------------------------------------------
# full width: parameters, site keys, the corpus, serve
# ---------------------------------------------------------------------------

def test_parameter_tree_matches_the_reference_at_full_width():
    """Leaf for leaf (names, shapes, dtypes): 160 stacked experts, the f32
    router, ``w_uk`` (512, 128, 128), ``wq_b`` (1536, 128 * 192)."""
    jshapes = jax.eval_shape(jbuild_model(jget_config(ARCH)).init,
                             jax.random.PRNGKey(0))
    want = [(k, tuple(v.shape), str(v.dtype)) for k, v in _flat(jshapes)]
    meta = build_model(get_config(ARCH)).init(device="meta")
    got = [(k, tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in _flat(meta)]
    assert got == want
    shapes = {k.split("'")[-2]: s for k, s, _ in got}
    assert shapes["w_uk"] == (60, 512, 128, 128)
    assert shapes["wq_b"] == (60, 1536, 128 * 192)
    assert shapes["ewi"] == (60, 160, 5120, 1536)


@pytest.mark.parametrize("batch,seq", [(8, 2048), (4, 512)])
def test_train_site_keys_match_jax_at_full_width(batch, seq):
    want = [s.key() for s in jextractor.extract_arch_sites(
        ARCH, batch=batch, seq=seq)]
    got = [s.key() for s in extractor.extract_arch_sites(
        ARCH, batch=batch, seq=seq)]
    assert got == want
    assert f"attention:mla.core:m{seq}n192k{seq}b{batch * 128}" \
        ":bfloat16:nn:c:f0" in got


def test_serve_site_keys_match_jax_at_full_width():
    cfg = jget_config(ARCH)
    model = jbuild_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: model.make_cache(4, 512 + 16,
                                                    jnp.dtype(cfg.dtype)))
    sds = jax.ShapeDtypeStruct
    want = [s.key() for s in jextractor.extract_sites(
        jsteps.make_prefill_step(model), params,
        {"tokens": sds((4, 512), jnp.int32)}, cache)]
    want += [s.key() for s in jextractor.extract_sites(
        jsteps.make_serve_step(model), params, sds((4, 1), jnp.int32),
        jnp.int32(0), cache)]
    want = list(dict.fromkeys(want))
    got = [s.key() for s in extractor.extract_serve_sites(
        build_model(get_config(ARCH)), 4, 512, 16)]
    assert sorted(got) == sorted(want) and len(got) == len(want)
    # decode attends in the absorbed form: no attention site at Sq = 1
    assert [k for k in got if k.startswith("attention:")] == [
        "attention:mla.core:m512n192k512b512:bfloat16:nn:c:f0"]


def test_arch_sites_are_the_references_whole_corpus():
    """With DeepSeek-V2 in, the port's ``arch_sites`` is the reference's,
    key for key and in order: all ten archs."""
    want = [s.key() for s in jdataset.arch_sites()]
    got = [s.key() for s in dataset.arch_sites()]
    assert got == want
    assert sum(k.startswith("matmul:mla.") or ":mla.core:" in k
               for k in got) == 5


def test_mla_core_launches_k2_at_the_baseline_and_every_192_site_has_tiles():
    """At full width ``mla.core`` (D = 192) has the D = 128 legal set: the
    baseline tile (128, 512) launches in the served and the runner's
    layouts, with 64-key stages: the served (192, 128) in a ring of 3, the
    runner's D = Dv = 192 in a ring of 2, each P.V at its own width in one
    tile."""
    from repro_torch.core.costmodel import baseline_tiles
    site = next(s for s in extractor.extract_serve_sites(
        build_model(get_config(ARCH)), 4, 512, 16) if s.site == "mla.core")
    assert ops.tile_ok(site, baseline_tiles(site))
    assert baseline_tiles(site)[:2] == (128, 512)
    qk = (128 * 512 * 192, 512 * 192, 192, 1)       # contiguous
    v = (512 * 128 * 128, 128, 128 * 128, 1)         # the einsum's view
    served = ops.attention_launch_plan(512, 512, 192, 128, 512,
                                       (qk, qk, v), Dv=128)
    runner = ops.attention_launch_plan(512, 512, 192, 128, 512, Dv=192)
    for p, ring, dv in ((served, 3, 128), (runner, 2, 192)):
        assert (p.variant, p.warpgroups, p.stage_keys, p.ring) == (
            "tma_wgmma", 2, 64, ring)
        assert (p.d_pad, p.dv_pad) == (192, dv)
        assert p.smem <= ops.ATTN_SMEM_DYN
    at128 = KernelSite("a", "attention", m=512, n=128, k=512, batch=512,
                       causal=True)
    tiles = [(bq, bkv) for bq in (16, 32, 64, 128, 256)
             for bkv in (64, 128, 256, 512, 1024)]
    assert [ops.tile_ok(site, t) for t in tiles] == [
        ops.tile_ok(at128, t) for t in tiles]


def test_serve_runs_deepseek_on_the_cpu_and_refuses_without_a_card(
        monkeypatch):
    res = serve.run(serve.parse_args(
        ["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len",
         "8", "--gen", "4"]))
    assert res.seq.shape == (2, 4)
    assert torch.isfinite(res.prefill_logits).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(serve.parse_args(
            ["--arch", ARCH, "--batch", "2", "--prompt-len", "8", "--gen",
             "4"]))

