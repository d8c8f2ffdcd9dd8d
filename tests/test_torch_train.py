"""The port's train path against the JAX package's: the loss and every
gradient leaf of ``train_loss`` against ``jax.value_and_grad``, and
three steps of ``make_train_step`` against the reference's, for the
reduced (f32) ``stablelm_3b``, ``qwen3_8b`` and ``xlstm_1_3b``.

Weights come from JAX ``model.init`` through
``repro_torch.convert.params_from_jax``; batches are numpy from a fixed
seed, fed to both.  Tolerances: the loss within 1e-5 relative and every
gradient within 1e-4 absolute (f32, summation order only); after three
AdamW steps the loss within 1e-5 relative and the parameters within 5e-5
absolute (the reference's own ``test_grad_accum_matches_single_batch``
holds accum 2 against accum 1 at 2e-5).

xLSTM's leaves that the gradient reaches through its block 5 (an mLSTM
layer; blocks 0-5 and the embedding) are held to their own scale
instead.  At these random weights that layer's chunk outputs reach 387
and their gradients 1e4 (a head whose normaliser lies just above its
floor), and f32 rounding of those intermediates moves the weight
gradients by up to 1e-3: evaluated in f64 (the same module with its f32
casts made f64), the reference's f32 gradients of that block lie up to
2.5e-3 from it and the port's up to 3.6e-3, while the two packages
differ by 1.1e-3.  Each such leaf is held within 1e-4 + 2e-2 of its
largest reference gradient element-wise and within 1e-2 of its norm as
a whole (readings: 8.2e-3 and 3.7e-3 at worst), so a leaf zeroed or of
the wrong sign fails; every other leaf at 1e-4.  After three steps those
leaves are held within 2e-4 (AdamW's first steps move an element by
about lr whatever its gradient's size, so an element whose gradient
lies within the packages' gap can move by a few 1e-5 more; reading
8.8e-5 for one element of 16384) and their updates within 1e-2 of the
reference's update in norm (reading 1.6e-3); every other leaf within
5e-5.  The loss is held at 1e-5 throughout.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed.compression import make_compressor as jcompressor
from repro.models.lm import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch.checkpoint.checkpoint import _flat
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.core import extractor
from repro_torch.core.vectorizer import baseline_program, inject
from repro_torch.distributed.compression import make_compressor
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw
from repro_torch.train import steps

ARCHS = ("stablelm_3b", "qwen3_8b", "xlstm_1_3b")
GRAD_ATOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-5
XL_ILL_BLOCK = 5        # xLSTM's ill-scaled mLSTM layer (see above)
XL_GRAD_REL = 2e-2      # its leaves: 1e-4 + this x max |reference grad|
XL_NORM_REL = 1e-2      # and ||grad - reference|| / ||reference||
XL_PARAM_ATOL = 2e-4    # after three steps, with XL_NORM_REL on the update
B, S = 4, 16


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


def _batch(seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 256, (b, s), dtype=np.int32)
    tgt = rng.integers(0, 256, (b, s), dtype=np.int32)
    return ({"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)},
            {"tokens": torch.from_numpy(tok).long(),
             "targets": torch.from_numpy(tgt).long()})


def _jax_flat(tree):
    """``(keystr, numpy leaf)`` in ``jax.tree_util``'s order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in flat]


def _ill_scaled(arch, key):
    """Whether leaf ``key`` gets its gradient through xLSTM's ill-scaled
    block: the embedding and blocks 0 to ``XL_ILL_BLOCK``."""
    m = re.match(r"\['blocks'\]\[(\d+)\]", key)
    return arch == "xlstm_1_3b" and (
        key == "['embed']" or (m is not None and
                               int(m.group(1)) <= XL_ILL_BLOCK))


def _rel_norm(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


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
    jb, tb = _batch(0)
    (lj, _), gj = jax.value_and_grad(jm.train_loss, has_aux=True)(jp, jb)
    lt, gt = _port_grads(tm, tp, tb)
    np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
    want, got = _jax_flat(gj), _flat(gt)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        g = g.numpy()
        if _ill_scaled(arch, k):
            np.testing.assert_allclose(
                g, w, atol=GRAD_ATOL + XL_GRAD_REL * np.abs(w).max(), rtol=0,
                err_msg=k)
            assert _rel_norm(g, w) <= XL_NORM_REL, k
        else:
            np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0,
                                       err_msg=k)


_REF_STEPS = {}


def _ref_steps(arch, accum, compress, n):
    """The reference's losses and state after ``n`` steps, run once."""
    key = (arch, accum, compress, n)
    if key not in _REF_STEPS:
        _REF_STEPS[key] = _run_ref_steps(*key)
    return _REF_STEPS[key]


def _run_ref_steps(arch, accum, compress, n):
    jm, jp, _, _ = _models(arch)
    opt = jadamw.AdamWConfig(warmup_steps=2, total_steps=10)
    state = {"params": jp, "opt": jadamw.init(jp),
             "step": jnp.zeros((), jnp.int32)}
    step = jsteps.make_train_step(
        jm, opt, accum=accum,
        compression=jcompressor(jp) if compress else None)
    # under jax.jit the compressor's closure is traced once, so its error
    # feedback would stay the initial zeros: the compressed step runs
    # un-jitted, as its residual carries from step to step
    if not compress:
        step = jax.jit(step)
    losses = []
    for i in range(n):
        state, m = step(state, _batch(10 + i)[0])
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.parametrize("arch,accum,compress", [
    ("stablelm_3b", 1, False), ("stablelm_3b", 2, False),
    ("stablelm_3b", 1, True), ("qwen3_8b", 2, False),
    ("xlstm_1_3b", 1, False)])
def test_three_train_steps_match_jax(arch, accum, compress):
    want_losses, want = _ref_steps(arch, accum, compress, 3)
    _, jp, tm, _ = _models(arch)
    state = train_state_from_jax(
        {"params": jax.tree.map(np.asarray, jp),
         "opt": jax.tree.map(np.asarray, jadamw.init(jp)), "step": 0},
        tm.cfg, device="cpu")
    step = steps.make_train_step(
        tm, adamw.AdamWConfig(warmup_steps=2, total_steps=10), accum=accum,
        compression=make_compressor(state["params"]) if compress else None)
    losses = []
    for i in range(3):
        state, m = step(state, _batch(10 + i)[1])
        losses.append(float(m["loss"]))
        assert set(m) == {"loss", "xent", "lb_loss", "router_z",
                          "grad_norm", "lr"} | (
            {"compress_err_sq"} if compress else set())
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert int(state["step"]) == int(state["opt"]["step"]) == 3
    init = dict(_jax_flat(jp))
    for (k, g), (_, w) in zip(_flat(state["params"]),
                              _jax_flat(want["params"])):
        g = g.numpy()
        if _ill_scaled(arch, k):
            np.testing.assert_allclose(g, w, atol=XL_PARAM_ATOL, rtol=0,
                                       err_msg=k)
            assert _rel_norm(g - init[k], w - init[k]) <= XL_NORM_REL, k
        else:
            np.testing.assert_allclose(g, w, atol=PARAM_ATOL, rtol=0,
                                       err_msg=k)
    assert not any(p.requires_grad for p in adamw._leaves(state["params"]))


def test_train_state_from_jax_round_trips():
    """The reference's state (after three steps, so the moments are not
    zero) maps one to one onto the port's tree, and back bitwise."""
    _, want = _ref_steps("stablelm_3b", 1, False, 3)
    np_state = jax.tree.map(np.asarray, want)
    state = train_state_from_jax(np_state, _models("stablelm_3b")[2].cfg,
                                 device="cpu")
    assert state["opt"]["m"]["embed"].dtype == torch.float32
    got = [(k, t.numpy()) for k, t in _flat(state)]
    ref = _jax_flat(np_state)
    assert [k for k, _ in got] == [k for k, _ in ref]
    for (k, g), (_, w) in zip(got, ref):
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    bad = dict(np_state, opt=dict(np_state["opt"], m=np_state["params"]))
    bad["opt"]["m"] = jax.tree.map(lambda a: a[..., :1], bad["opt"]["m"])
    with pytest.raises(ValueError):
        train_state_from_jax(bad, _models("stablelm_3b")[2].cfg,
                             device="cpu")


@pytest.mark.parametrize("arch", ["stablelm_3b", "xlstm_1_3b"])
def test_remat_gives_the_gradients_without_it(arch, monkeypatch):
    """Each layer recomputed in the backward gives the same gradients,
    bitwise, as keeping its activations; and keeps fewer tensors."""
    _, _, tm, tp = _models(arch)
    _, tb = _batch(1)

    def saved_and_grads():
        n = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: n.append(t.numel()) or t, lambda t: t):
            out = _port_grads(tm, tp, tb)
        return sum(n), out
    n_remat, (l1, g1) = saved_and_grads()
    monkeypatch.setattr(lm, "checkpoint", lambda fn, x, **_: fn(x))
    n_plain, (l2, g2) = saved_and_grads()
    assert torch.equal(l1, l2)
    for (k, a), (_, b) in zip(_flat(g1), _flat(g2)):
        assert torch.equal(a, b), k
    assert n_remat < n_plain


def _train_sites(model):
    params = model.init(device=extractor.META)
    return extractor.extract_sites(lambda p, b: model.train_loss(p, b),
                                   params, extractor.meta_batch(B, S))


def test_kernel_mode_refuses_grad_and_matches_eager_without():
    """An injected program under autograd raises the named error at the
    first kernel, K1 (the reference's Pallas kernels raise there too);
    under ``no_grad`` the kernel path's loss is eager's."""
    _, _, tm, tp = _models("stablelm_3b")
    _, tb = _batch(2)
    prog = baseline_program(_train_sites(tm))
    leaves = adamw._leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with inject(prog), pytest.raises(NotImplementedError,
                                         match=r"K1 \(tiled matmul\) has "
                                               r"no backward"):
            tm.train_loss(tp, tb)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    with torch.no_grad():
        le, _ = tm.train_loss(tp, tb)
        with inject(prog):
            lk, _ = tm.train_loss(tp, tb)
    np.testing.assert_allclose(float(lk), float(le), rtol=LOSS_RTOL)


@pytest.mark.parametrize("kernel", ["matmul", "flash_attention",
                                    "chunk_scan"])
def test_each_kernel_refuses_autograd_on_every_route(kernel):
    """Whatever the device (here the plain version's), a kernel call that
    autograd would record raises; with no input requiring grad, or under
    ``no_grad`` or ``inference_mode``, it runs."""
    g = torch.Generator().manual_seed(0)
    shapes = {"matmul": [(8, 16), (16, 8)],
              "flash_attention": [(1, 2, 8, 16)] * 3,
              "chunk_scan": [(1, 16, 8), (1, 16, 8), (1, 16, 8), (1, 16)]}
    args = [torch.randn(s, generator=g) for s in shapes[kernel]]
    kw = {"matmul": {}, "flash_attention": dict(causal=True, scale=0.25),
          "chunk_scan": dict(chunk=8)}[kernel]
    fn = getattr(ops, kernel)
    want = fn(*args, **kw)
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="has no backward"):
        fn(*args, **kw)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            assert torch.equal(fn(*args, **kw), want)


def test_split_microbatches_and_one_card():
    tb = _batch(3)[1]
    mbs = steps._split_microbatches(tb, 2)
    assert [mb["tokens"].shape[0] for mb in mbs] == [2, 2]
    assert torch.equal(torch.cat([mb["targets"] for mb in mbs]),
                       tb["targets"])
    # the specs place a mesh's microbatches; a one-card batch's are as
    # they were
    pinned = steps._split_microbatches(
        tb, 2, mb_specs={"tokens": ("data", None), "targets": ("data", None)})
    for mb, pin in zip(mbs, pinned):
        assert all(torch.equal(mb[k], pin[k]) for k in mb)
    with pytest.raises(ValueError):
        steps._split_microbatches(tb, 3)
