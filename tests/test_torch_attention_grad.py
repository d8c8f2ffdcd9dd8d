"""The memory-efficient attention's backward: the port's autograd
``Function`` (``repro_torch.models.compute._mem_efficient_attention``)
against ``jax.vjp`` of the reference's custom VJP
(``repro.models.compute._mem_efficient_attention``).

Inputs are numpy from a fixed seed, f32.  ``o``, ``dq``, ``dk`` and
``dv`` agree within 1e-4 absolute (f32 summation order only, values of
order 1).  ``gradcheck`` holds the backward against finite differences
in f64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import compute as jcompute
from repro_torch.models import compute

ATOL = 1e-4


def _inputs(seed, B, Hq, Hkv, Sq, Skv, D, Dv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, Skv, Dv), dtype=np.float32)
    do = rng.standard_normal((B, Hq, Sq, Dv), dtype=np.float32)
    return q, k, v, do


def _torch_vjp(fn, q, k, v, do):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = fn(qt, kt, vt)
    dq, dk, dv = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    return [t.detach().numpy() for t in (o, dq, dk, dv)]


def _jax_vjp(fn, q, k, v, do):
    o, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(t) for t in (o, *vjp(jnp.asarray(do)))]


def _assert_close(got, want):
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


# (B, H, Sq, Skv, D, Dv, bq, bkv, causal): several blocks each way,
# Sq < Skv (the bottom-right causal offset), Dv != D both ways
CASES = [
    (2, 2, 16, 16, 8, 8, 4, 8, True),
    (2, 2, 16, 16, 8, 8, 4, 8, False),
    (1, 3, 8, 24, 8, 8, 4, 8, True),
    (1, 3, 8, 24, 8, 8, 8, 6, False),
    (1, 2, 16, 16, 8, 12, 8, 4, True),
    (1, 2, 8, 16, 16, 8, 8, 16, False),
]


@pytest.mark.parametrize("B,H,Sq,Skv,D,Dv,bq,bkv,causal", CASES)
def test_function_matches_the_reference_custom_vjp(B, H, Sq, Skv, D, Dv, bq,
                                                    bkv, causal):
    q, k, v, do = _inputs(0, B, H, H, Sq, Skv, D, Dv)
    scale = D ** -0.5
    got = _torch_vjp(lambda a, b, c: compute._mem_efficient_attention(
        a, b, c, causal=causal, scale=scale, bq=bq, bkv=bkv), q, k, v, do)
    want = _jax_vjp(lambda a, b, c: jcompute._mem_efficient_attention(
        a, b, c, causal, scale, bq, bkv), q, k, v, do)
    _assert_close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_gradients_sum_back_through_flash_attention(causal):
    """Hq = 4 over Hkv = 2 through ``compute.flash_attention`` in eager
    mode: k and v are expanded before the ``Function`` and their gradients
    sum back over each group, as through the reference's ``jnp.repeat``."""
    q, k, v, do = _inputs(1, 2, 4, 2, 16, 16, 8, 8)
    got = _torch_vjp(lambda a, b, c: compute.flash_attention(
        a, b, c, site="attn.core", causal=causal, q_chunk=8, kv_chunk=4),
        q, k, v, do)
    want = _jax_vjp(lambda a, b, c: jcompute.flash_attention(
        a, b, c, site="attn.core", causal=causal, q_chunk=8, kv_chunk=4),
        q, k, v, do)
    _assert_close(got, want)


@pytest.mark.parametrize("causal,Sq,Skv,Dv", [(True, 4, 6, 3),
                                              (False, 6, 6, 2)])
def test_gradcheck_in_f64(causal, Sq, Skv, Dv):
    """The backward against finite differences: the accumulators follow
    f64 inputs, so the check runs at f64 precision."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, Sq, 4), generator=g, dtype=torch.float64)
    k = torch.randn((1, 2, Skv, 4), generator=g, dtype=torch.float64)
    v = torch.randn((1, 2, Skv, Dv), generator=g, dtype=torch.float64)
    args = tuple(t.requires_grad_(True) for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: compute._mem_efficient_attention(
            a, b, c, causal=causal, scale=0.5, bq=2, bkv=3), args)


def test_only_q_k_v_o_lse_are_saved_for_the_backward():
    """Whatever the number of (bq, bkv) blocks, autograd keeps five
    tensors: q, k, v, o and the f32 log-sum-exp, no probability block."""
    q, k, v, _ = _inputs(2, 1, 2, 2, 32, 32, 8, 8)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = compute._mem_efficient_attention(qt, kt, vt, causal=True,
                                             scale=0.3, bq=4, bkv=4)
    assert sorted(saved) == sorted([(1, 2, 32, 8)] * 4 + [(1, 2, 32)])
    assert o.grad_fn is not None


def test_serving_forward_is_the_training_forward():
    """Under ``inference_mode`` (serving) the same function gives the
    same numbers, bitwise, and the reference's forward within 1e-4."""
    q, k, v, _ = _inputs(3, 2, 2, 2, 16, 16, 8, 8)
    args = dict(causal=True, scale=8 ** -0.5, bq=4, bkv=8)
    with torch.inference_mode():
        served = compute._mem_efficient_attention(
            *(torch.from_numpy(a) for a in (q, k, v)), **args)
    trained = compute._mem_efficient_attention(
        *(torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)),
        **args)
    assert torch.equal(served, trained.detach())
    want = jcompute._mem_efficient_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), True,
                                             8 ** -0.5, 4, 8)
    np.testing.assert_allclose(served.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
