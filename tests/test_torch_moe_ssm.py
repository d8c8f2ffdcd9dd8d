"""The port's MoE and Mamba (SSD) layers, and the two archs built from
them (Llama-4 Maverick and Jamba v0.1), against the JAX package's, on the
CPU.

The layers: ``apply_moe`` at Jamba's and Llama-4's reduced configs (the
output, ``lb_loss``, ``router_z`` and the gradient of every parameter and
of the input), once with a router biased towards one expert at T = 256
so that tokens overflow its capacity and are dropped (Llama-4's router,
top-1, against the reference's aux-loss gradient alone: see the test);
``apply_ssm``'s prefill at S = 12 with chunk 8 (zero padding to 16) into
a cache, then 4 decode steps from it.  The archs: prefill and 3 decode steps, the loss
and every gradient, the parameter trees and the site keys at full width,
the train driver.  Weights come from the reference's init (through
``repro_torch.convert.params_from_jax`` for a model); inputs are numpy
from a fixed seed, fed to both.  Tolerances (f32, summation order only):
the layers at 1e-5 of each quantity's largest |value| (at least 1e-5
absolute); the models' logits at 1e-4 absolute, the loss at 1e-5
relative and every gradient leaf at 1e-4 absolute, as
``tests/test_torch_archs.py``; site keys bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import extractor as jextractor
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.lm import build_model as jbuild_model
from repro.train import steps as jsteps
from repro_torch.checkpoint.checkpoint import _flat
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import extractor
from repro_torch.launch import train as ttrain
from repro_torch.models import lm, moe, ssm
from repro_torch.models.common import WeightDraw, dense_init
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw

ARCHS = ("llama4_maverick_400b", "jamba_v0_1_52b")
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


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _moe_case(arch, T, biased):
    cfg_j, cfg_t = jget_config(arch).reduced(), get_config(arch).reduced()
    jp = jmoe.moe_init(cfg_j, jax.random.PRNGKey(11), jnp.float32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, T // 2, cfg_t.d_model), dtype=np.float32)
    if biased:      # every token's logit for expert 0 far above the rest
        x = x + 1.0
        jp = dict(jp, router=jp["router"].at[:, 0].add(0.5))
    return cfg_j, cfg_t, jp, x


@pytest.mark.parametrize("arch,T,biased", [
    ("jamba_v0_1_52b", 24, False), ("llama4_maverick_400b", 24, False),
    ("jamba_v0_1_52b", 256, True), ("llama4_maverick_400b", 256, True)])
def test_apply_moe_output_losses_and_gradients_match_jax(arch, T, biased):
    cfg_j, cfg_t, jp, x = _moe_case(arch, T, biased)
    r = np.random.default_rng(6).standard_normal(x.shape, dtype=np.float32)

    def jloss(p, xx):
        y, aux = jmoe.apply_moe(cfg_j, p, xx)
        return (jnp.sum(y * r) + aux["lb_loss"] + aux["router_z"],
                (y, aux))

    (_, (yj, auxj)), (gpj, gxj) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tp = _to_torch(jp)
    for v in tp.values():
        v.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt, auxt = moe.apply_moe(cfg_t, tp, xt)
    loss = (yt * torch.from_numpy(r)).sum() + auxt["lb_loss"] \
        + auxt["router_z"]
    grads = torch.autograd.grad(loss, [xt, *tp.values()])
    _close(yt.detach(), yj, "y")
    for k in ("lb_loss", "router_z"):
        _close(auxt[k].detach(), auxj[k], k)
    _close(grads[0], gxj, "d x")
    if cfg_t.moe_top_k == 1:
        # top-1: the renormalised gate g / g is 1, so the output reaches
        # the router only through rounding: the port's autograd gives 0
        # exactly, the reference's f32 VJP rounding noise (7.3e-5 at the
        # balanced batch, whose router gradient is 0.95 at most).  The
        # router is held against the reference's aux-loss gradient alone.
        gy = jax.grad(lambda p: jnp.sum(
            jmoe.apply_moe(cfg_j, p, jnp.asarray(x))[0] * r))(jp)["router"]
        assert float(jnp.abs(gy).max()) < 1e-3
        gpj = dict(gpj, router=jax.grad(lambda p: sum(jmoe.apply_moe(
            cfg_j, p, jnp.asarray(x))[1].values()))(jp)["router"])
    for (k, _), g in zip(tp.items(), grads[1:]):
        _close(g, gpj[k], f"d {k}")

    # the capacity: where the router is biased, expert 0's buffer is full
    # and (token, slot) choices were dropped, their weights zero
    with torch.no_grad():
        logits = xt.reshape(T, -1) @ tp["router"]
        _, _, keep, w, idx, _ = moe.route(cfg_t, logits)
    C = moe._capacity(T, cfg_t.n_experts, cfg_t.moe_top_k)
    assert idx.shape == (cfg_t.n_experts, C)
    assert bool((w[~keep] == 0).all())
    if biased:
        assert bool((idx[0] >= 0).all()) and int((~keep).sum()) > T // 4


def test_capacity_priority_is_slot_major():
    """Slot 0 of every token is placed before any token's slot 1: with
    every token choosing expert 0 first and expert 1 second, expert 1
    keeps the first C tokens in token order and expert 0 likewise."""
    cfg = get_config("jamba_v0_1_52b").reduced()    # E = 4, K = 2
    T = 64
    logits = torch.full((T, cfg.n_experts), -5.0)
    logits[:, 0], logits[:, 1] = 5.0, 4.0
    eidx, pos, keep, _, idx, _ = moe.route(cfg, logits)
    C = moe._capacity(T, cfg.n_experts, cfg.moe_top_k)
    assert torch.equal(eidx[:, 0], torch.zeros(T, dtype=torch.long))
    assert torch.equal(pos[:, 0], torch.arange(T))
    assert torch.equal(keep[:, 0], torch.arange(T) < C)
    assert torch.equal(idx[0], torch.arange(C))
    assert torch.equal(idx[1], torch.arange(C))
    assert bool((idx[2:] == -1).all())


def _onehot_positions(eidx, E, e0=0):
    """The reference's capacity positions (``repro/models/moe.py``): a
    cumsum of the slot-major one-hot down the choices; the oracle of
    ``moe._positions``."""
    a_e = eidx.T.reshape(-1)
    onehot = (a_e[:, None] == torch.arange(e0, e0 + E,
                                           device=eidx.device)).int()
    return (torch.cumsum(onehot, dim=0) * onehot).sum(-1)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("choices", ["random", "same"])
@pytest.mark.parametrize("T,K,E", [(2048, 6, 160), (256, 1, 128),
                                   (64, 2, 4)])
def test_positions_equal_the_onehot_cumsum(T, K, E, choices, device):
    """``_positions`` bitwise the one-hot cumsum, over all E experts and
    over each TP rank's slice ``[e0, e0 + E_l)`` as ``_sharded_moe``
    passes it, with top-k choices of random logits and with every token
    choosing the same K experts (all but C of each overflow).  On
    ``meta`` tensors the shape and dtype alone."""
    if choices == "random":
        g = torch.Generator().manual_seed(T * K + E)
        eidx = torch.topk(torch.randn(T, E, generator=g), K, dim=-1).indices
    else:
        eidx = torch.arange(K).repeat(T, 1)
    eidx = eidx.to(device)
    for n_tp in (1, 2, 4):
        E_l = E // n_tp
        for e0 in range(0, E, E_l):
            got, want = moe._positions(eidx, E_l, e0), \
                _onehot_positions(eidx, E_l, e0)
            assert got.shape == want.shape == (K * T,)
            assert got.dtype == want.dtype
            if device != "meta":
                assert torch.equal(got, want), (n_tp, e0)
    if device != "meta" and choices == "same":
        assert torch.equal(moe._positions(eidx, E)[:T], torch.arange(1, T + 1))


# ---------------------------------------------------------------------------
# the Mamba (SSD) mixer
# ---------------------------------------------------------------------------

def test_apply_ssm_prefill_with_padding_then_decode_match_jax():
    """Prefill at S = 12 with chunk 8 (padded to 16 with dt = 0) into a
    zeroed cache, then 4 decode steps from that cache; the output of each
    and the cache after each at 1e-5.  A_log, D and dt_bias drawn at
    random so that every head decays at its own rate."""
    cfg_j = jget_config("jamba_v0_1_52b").reduced()
    cfg_t = get_config("jamba_v0_1_52b").reduced()
    assert cfg_t.ssm_chunk == 8 and S % cfg_t.ssm_chunk
    rng = np.random.default_rng(8)
    h = cfg_t.n_ssm_heads
    jp = dict(jssm.ssm_init(cfg_j, jax.random.PRNGKey(4), jnp.float32),
              A_log=jnp.asarray(rng.uniform(-1, 1, h).astype(np.float32)),
              D=jnp.asarray(rng.uniform(0.5, 1.5, h).astype(np.float32)),
              dt_bias=jnp.asarray(rng.uniform(-1, 0.5, h).astype(
                  np.float32)))
    tp = _to_torch(jp)
    x = rng.standard_normal((B, S, cfg_t.d_model), dtype=np.float32)
    jc = jssm.make_ssm_cache(cfg_j, B, jnp.float32)
    tc = ssm.make_ssm_cache(cfg_t, B, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: tuple(v.shape) for k, v in jc.items()}
    yj, jc = jssm.apply_ssm(cfg_j, jp, jnp.asarray(x), cache=jc)
    with torch.no_grad():
        yt = ssm.apply_ssm(cfg_t, tp, torch.from_numpy(x), cache=tc)
    _close(yt, yj, "prefill y")
    for k in ("conv", "ssd"):
        _close(tc[k], jc[k], f"prefill cache {k}")
    for i in range(4):
        x1 = rng.standard_normal((B, 1, cfg_t.d_model), dtype=np.float32)
        yj, jc = jssm.apply_ssm(cfg_j, jp, jnp.asarray(x1), cache=jc,
                                decode_pos=S + i)
        with torch.no_grad():
            yt = ssm.apply_ssm(cfg_t, tp, torch.from_numpy(x1), cache=tc,
                               decode_pos=S + i)
        _close(yt, yj, f"decode {i} y")
        for k in ("conv", "ssd"):
            _close(tc[k], jc[k], f"decode {i} cache {k}")


def test_apply_ssm_without_cache_and_its_gradients_match_jax():
    cfg_j = jget_config("jamba_v0_1_52b").reduced()
    cfg_t = get_config("jamba_v0_1_52b").reduced()
    jp = jssm.ssm_init(cfg_j, jax.random.PRNGKey(9), jnp.float32)
    x = np.random.default_rng(3).standard_normal((B, 20, cfg_t.d_model),
                                                 dtype=np.float32)
    gj = jax.grad(lambda p: jnp.sum(jssm.apply_ssm(
        cfg_j, p, jnp.asarray(x))[0] ** 2))(jp)
    tp = _to_torch(jp)
    for v in tp.values():
        v.requires_grad_(True)
    y = ssm.apply_ssm(cfg_t, tp, torch.from_numpy(x))
    grads = torch.autograd.grad((y ** 2).sum(), list(tp.values()))
    for (k, _), g in zip(tp.items(), grads):
        _close(g, gj[k], f"d {k}")


# ---------------------------------------------------------------------------
# the two archs at the reduced config
# ---------------------------------------------------------------------------

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


def _batch(cfg, seed, targets=False):
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                     dtype=np.int32)}
    if targets:
        arrays["targets"] = rng.integers(0, cfg.vocab_size, (B, S),
                                         dtype=np.int32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v).long() for k, v in arrays.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_jax(arch):
    """Prefill (Jamba's S = 12 pads its chunk of 8), then N_DEC greedy
    decode steps on the cache; each step's logits and the cache after the
    last against the reference's."""
    jm, jp, tm, tp = _models(arch)
    ctx = S + N_DEC
    jb, tb = _batch(tm.cfg, 3)
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
        lj, jc = step(jp, jnp.asarray(tok), jnp.int32(S + i), jc)
        with torch.no_grad():
            lt, tc = tm.decode_step(tp, torch.from_numpy(tok).long(), S + i,
                                    tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   atol=LOGIT_ATOL, rtol=0, err_msg=str(i))
    got = _flat(tc["caches"])
    want = _flat(jax.tree.map(np.asarray, jc["caches"]))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0,
                                   err_msg=k)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_losses_and_every_gradient_match_jax(arch):
    """The loss is the cross-entropy plus ``1e-2 * lb_loss + 1e-3 *
    router_z`` summed over the MoE layers, as the reference's."""
    jm, jp, tm, tp = _models(arch)
    jb, tb = _batch(tm.cfg, 4, targets=True)
    (lj, mj), gj = jax.value_and_grad(jm.train_loss, has_aux=True)(jp, jb)
    lt, mt, gt = _port_grads(tm, tp, tb)
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
    assert set(mt) == {"xent", "lb_loss", "router_z"}
    for k in mt:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert float(mt["lb_loss"]) > 0 and float(mt["router_z"]) > 0
    want = _flat(jax.tree.map(np.asarray, gj))
    got = _flat(gt)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_trees_match_the_reference(arch):
    """Leaf for leaf at full width (names, shapes, dtypes: the MoE
    router in f32, the stacked experts, the SSM's f32 A_log, D and
    dt_bias), so ``params_from_jax`` maps them one to one."""
    jshapes = jax.eval_shape(jbuild_model(jget_config(arch)).init,
                             jax.random.PRNGKey(0))
    want = [(k, tuple(v.shape), str(v.dtype)) for k, v in _flat(jshapes)]
    meta = build_model(get_config(arch)).init(device="meta")
    got = [(k, tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in _flat(meta)]
    assert got == want
    leaves = {k.split("'")[-2] for k, _, _ in got}
    assert {"router", "ewi", "ewg", "ewo"} <= leaves
    if arch == "jamba_v0_1_52b":
        assert {"in_proj", "conv", "A_log", "D", "dt_bias", "norm",
                "out_proj"} <= leaves
    else:
        assert {"shared_wi", "shared_wg", "shared_wo"} <= leaves


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_every_leaf_exactly(arch):
    """The reduced config's converted weights equal the reference's bit
    for bit, the MoE and SSM leaves among them."""
    jm, jp, tm, tp = _models(arch)
    want = _flat(jax.tree.map(np.asarray, jp))
    got = _flat(tp)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert np.array_equal(g.numpy(), w), k


@pytest.mark.parametrize("arch", ARCHS)
def test_train_site_keys_match_jax_at_full_width(arch):
    want = [s.key() for s in jextractor.extract_arch_sites(arch, batch=4,
                                                           seq=512)]
    got = [s.key() for s in extractor.extract_arch_sites(arch, batch=4,
                                                         seq=512)]
    assert got == want
    assert any(k.startswith("matmul:moe.router:") and ":float32:" in k
               for k in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_site_keys_match_jax_at_full_width(arch):
    cfg = jget_config(arch)
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
        build_model(get_config(arch)), 4, 512, 16)]
    assert sorted(got) == sorted(want) and len(got) == len(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_driver_takes_three_cpu_steps(arch):
    res = ttrain.run(ttrain.parse_args(
        ["--arch", arch, "--steps", "3", "--batch", "4", "--seq", "24",
         "--lr", "1e-3", "--device", "cpu"]))
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()
    assert all(np.isfinite(g) and g > 0 for g in res.grad_norms)
    assert len(res.aux) == 3
    assert all(a["lb_loss"] > 0 and a["router_z"] > 0 for a in res.aux)


# ---------------------------------------------------------------------------
# a stack of one layer
# ---------------------------------------------------------------------------

def test_a_stack_of_one_layer_is_the_drawn_layer_as_a_view():
    """``_stacked(1, ...)`` keeps the drawn tree (a view with a leading
    axis of 1, no second copy), bitwise the values the preallocated path
    writes for the same draws."""
    cfg = get_config("llama4_maverick_400b").reduced()

    def make(seed):
        draw = WeightDraw(seed)
        return {"a": dense_init(draw, (64, 32), torch.float32, "cpu"),
                "sub": {"b": dense_init(draw, (4, 64, 16), torch.bfloat16,
                                        "cpu")}}
    one = lm._stacked(1, lambda: make(3))
    two = lm._stacked(2, lambda: make(3))   # the preallocated path
    for (k, v1), (_, v2) in zip(_flat(one), _flat(two)):
        assert v1.shape[0] == 1 and v1._base is not None, k
        assert torch.equal(v1[0], v2[0]) and torch.equal(v2[0], v2[1]), k
    # a whole model of one period: every stacked leaf a view
    p = build_model(cfg).init(seed=0, device="cpu")
    assert all(v._base is not None for _, v in _flat(p["blocks"]))
