"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX
package's ``repro.optim.adamw`` on the CPU.

The same f32 inputs, made from numpy seeds, go through both.  Tolerances:
the learning rate at every step 0-600 within rtol 1e-6; five ``update``
steps over a tree with 1-D and 2-D leaves, with the global-norm clip
active and inactive, within rtol 1e-6 and atol 1e-7 (f32 throughout, the
same order of operations; a sum of a few scalars may round differently).
The two packages' f32 ``cos`` differ in the last place at some
arguments, so the schedules are held where the floor ``min_lr_frac``
keeps ``1 + cos`` away from cancelling (with a floor of 0 the last steps
before ``total_steps`` differ by up to 4e-5 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch.optim import adamw

CFGS = {
    "default": dict(),
    "surrogate": dict(lr=1e-2, weight_decay=1e-4, clip_norm=1.0,
                      warmup_steps=20, total_steps=500, min_lr_frac=0.05),
    "no_warmup": dict(lr=5e-3, warmup_steps=0, total_steps=300),
}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_lr_schedule_matches_reference_at_every_step(name):
    jc, tc = jadamw.AdamWConfig(**CFGS[name]), adamw.AdamWConfig(**CFGS[name])
    steps = np.arange(0, 601)
    want = np.asarray(jadamw.lr_schedule(jc, jnp.asarray(steps, jnp.int32)))
    got = adamw.lr_schedule(tc, torch.as_tensor(steps, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # a scalar step gives the same number
    assert float(adamw.lr_schedule(tc, 123)) == float(got[123])


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"layers": [{"w": rng.standard_normal((5, 7), np.float32),
                        "b": rng.standard_normal((7,), np.float32)},
                       {"w": rng.standard_normal((7, 1), np.float32),
                        "b": rng.standard_normal((1,), np.float32)}],
            "scale": (rng.standard_normal((3,), np.float32),
                      rng.standard_normal((2, 2), np.float32))}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("clip", [1e-2, 1e3], ids=["clipped", "unclipped"])
def test_update_matches_reference_over_five_steps(clip):
    kw = dict(lr=3e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    jc, tc = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jp = _map(_tree(0), jnp.asarray)
    tp = _map(_tree(0), torch.tensor)
    js, ts = jadamw.init(jp), adamw.init(tp)
    for step in range(5):
        g = _tree(100 + step)
        jp, js, jm = jadamw.update(jc, _map(g, jnp.asarray), js, jp)
        tp, ts, tm = adamw.update(tc, _map(g, torch.tensor), ts, tp)
        for a, b in zip(_flat(_map(tp, lambda t: t.numpy())), _flat(jp)):
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        for key in ("m", "v"):
            for a, b in zip(_flat(_map(ts[key], lambda t: t.numpy())),
                            _flat(js[key])):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    # the clip is active in one case and not in the other
    assert (float(tm["grad_norm"]) > clip) == (clip < 1.0)


def test_update_decays_matrices_only_and_keeps_dtype():
    """Decoupled weight decay touches tensors with ndim >= 2 only: with a
    zero gradient a matrix shrinks and a vector stays; moments are f32
    for bf16 parameters, which keep their dtype."""
    cfg = adamw.AdamWConfig(lr=1e-1, weight_decay=0.5, warmup_steps=0,
                            total_steps=10)
    params = {"w": torch.ones(2, 3, dtype=torch.bfloat16),
              "b": torch.ones(3, dtype=torch.bfloat16)}
    state = adamw.init(params)
    assert all(t.dtype == torch.float32 for t in state["m"].values())
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    new, state, _ = adamw.update(cfg, grads, state, params)
    assert new["w"].dtype == torch.bfloat16
    assert float(new["w"].float().max()) < 1.0
    assert torch.equal(new["b"], params["b"])
    # the arguments are not written into
    assert float(params["w"].float().min()) == 1.0


def test_global_norm_matches_reference():
    tree = _tree(7)
    want = float(jadamw.global_norm(_map(tree, jnp.asarray)))
    got = float(adamw.global_norm(_map(tree, torch.tensor)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
