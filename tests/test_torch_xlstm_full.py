"""One full-width mLSTM block and one full-width sLSTM block of
``xlstm_1_3b`` (d_model 2048, 4 heads, mLSTM head dim 1024) against the
JAX package, in f32 on a short sequence: the reduced config's parity
(``tests/test_torch_xlstm.py``) at the published widths.

The blocks take the JAX package's initial weights (numpy, f32) and numpy
inputs from a fixed seed.  Tolerance 1e-4 absolute and relative on the
outputs and the recurrent state: f32 in both, sums over 1024-2048 terms
in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_config
from repro_torch.models import xlstm

ARCH = "xlstm_1_3b"
TOL = 1e-4
B, S = 1, 12


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(seed, cfg):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model), dtype=np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


def test_full_width_mlstm_block_matches_jax():
    """The chunkwise prefill over 12 tokens in chunks of 8 (a padded
    chunk), its output and final state, then one decode step."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert (cfg.d_model, cfg.n_heads) == (2048, 4)
    jp = jxlstm.mlstm_init(jcfg, jax.random.PRNGKey(1), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert tuple(tp["wq"].shape) == (4, 1024, 1024)
    x = _x(2, cfg)
    yj, cj = jxlstm.apply_mlstm(jcfg, jp, jnp.asarray(x),
                                cache=jxlstm.make_mlstm_cache(jcfg, B),
                                chunk=8)
    cache = xlstm.make_mlstm_cache(cfg, B, "cpu")
    with torch.no_grad():
        yt = xlstm.apply_mlstm(cfg, tp, torch.from_numpy(x), cache=cache,
                               chunk=8)
    _close(yt, yj)
    for k in cache:
        _close(cache[k], cj[k])
    x1 = _x(3, cfg)[:, :1]
    dj, _ = jxlstm.apply_mlstm(jcfg, jp, jnp.asarray(x1), cache=cj,
                               decode_pos=S)
    with torch.no_grad():
        dt = xlstm.apply_mlstm(cfg, tp, torch.from_numpy(x1), cache=cache,
                               decode_pos=S)
    _close(dt, dj)


def test_full_width_slstm_block_matches_jax():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    jp = jxlstm.slstm_init(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    assert tuple(tp["wx"].shape) == (2048, 8192)
    x = _x(4, cfg)
    yj, cj = jxlstm.apply_slstm(jcfg, jp, jnp.asarray(x),
                                cache=jxlstm.make_slstm_cache(jcfg, B))
    cache = xlstm.make_slstm_cache(cfg, B, "cpu")
    with torch.no_grad():
        yt = xlstm.apply_slstm(cfg, tp, torch.from_numpy(x), cache=cache)
    _close(yt, yj)
    for k in cache:
        _close(cache[k], cj[k])
