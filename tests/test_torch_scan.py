"""K3, the SSD chunk scan: the port's plain version against the JAX
package's Pallas kernel (interpret mode) and sequential oracle, and the
one launch predicate that ``kernels.ops.tile_ok`` and the ``"h100"`` cost
model share.

Inputs are numpy from a fixed seed, f32, at the shapes of
``tests/test_kernels.py:117-143``.  Tolerance: 1e-4 relative to the
largest output (both compute in f32 and differ only in summation order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.neurovec import DEFAULT as JDEFAULT
from repro.core import costmodel_vec as jcv
from repro.core.env import ActionSpace as JActionSpace
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.configs.neurovec import DEFAULT
from repro_torch.core import costmodel as tcm
from repro_torch.core import costmodel_vec as tcv
from repro_torch.core.env import ActionSpace, CostModelEnv
from repro_torch.core.extractor import extract_serve_sites
from repro_torch.kernels import chunk_scan as kcs
from repro_torch.kernels import ops, ref
from repro_torch.models.compute import KernelSite
from repro_torch.models.lm import build_model

REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU tensors: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, G, S, P, N):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh, dtype=np.float32)
    x, Bm, Cm = f(G, S, P), f(G, S, N) * 0.3, f(G, S, N) * 0.3
    la = -np.logaddexp(0.0, f(G, S)).astype(np.float32)     # -softplus
    return x, Bm, Cm, la


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _torch(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("chunk", [16, 32, 128])
def test_chunk_scan_plain_matches_pallas_and_oracle(chunk):
    arrs = _inputs(1, 3, 128, 32, 16)
    y = kcs.chunk_scan_plain(*_torch(*arrs), chunk=chunk).numpy()
    want = jops.chunk_scan(*map(jnp.asarray, arrs), chunk=chunk,
                           interpret=True)
    assert _rel(y, want) < REL
    assert _rel(y, jref.chunk_scan_ref(*map(jnp.asarray, arrs))) < REL


def test_chunk_scan_chunk_invariance():
    """The chunk is a pure performance knob: every chunk gives the same
    function."""
    arrs = _torch(*_inputs(2, 2, 64, 16, 8))
    outs = [kcs.chunk_scan_plain(*arrs, chunk=c) for c in (8, 16, 64)]
    for o in outs[1:]:
        assert _rel(o, outs[0]) < REL


def test_sequential_oracle_matches_jax():
    arrs = _inputs(3, 2, 48, 8, 8)
    np.testing.assert_allclose(
        ref.chunk_scan_ref(*_torch(*arrs)).numpy(),
        np.asarray(jref.chunk_scan_ref(*map(jnp.asarray, arrs))),
        rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    arrs = _torch(*_inputs(4, 1, 64, 8, 8))
    before = kcs.launches
    y = ops.chunk_scan(*arrs, chunk=32)
    assert kcs.launches == before
    assert torch.equal(y, kcs.chunk_scan_plain(*arrs, chunk=32))
    with pytest.raises(ValueError, match="divide"):
        ops.chunk_scan(*arrs, chunk=48)
    with pytest.raises(ValueError, match="CUDA"):
        kcs.chunk_scan_cuda(*(a.bfloat16() for a in arrs[:3]), arrs[3],
                            chunk=32)


def test_chunk_predicate_limits():
    assert ops.chunk_tiles_legal(8192, 1024, 1024, 1024)
    assert ops.chunk_tiles_legal(8192, 1024, 1024, 64)
    assert ops.chunk_tiles_legal(512, 7, 8, 4096)       # clamped to S
    assert not ops.chunk_tiles_legal(8192, 1024, 1024, 2048)
    assert not ops.chunk_tiles_legal(8192, 64, 12, 256)
    assert not ops.chunk_tiles_legal(8192, 64, 2048, 256)
    assert not ops.chunk_tiles_legal(8192, 64, 16, 0)


def _chunk_sites():
    """The xLSTM serve site, the reduced one, a Mamba-2 head of Jamba, and
    shapes on both sides of the predicate's limits."""
    out = [s for s in extract_serve_sites(
        build_model(get_config("xlstm_1_3b")), 4, 512, 16)
           if s.kind == "chunk_scan"]
    out += [s for s in extract_serve_sites(
        build_model(get_config("xlstm_1_3b").reduced()), 2, 16, 4)
            if s.kind == "chunk_scan"]
    out += [KernelSite("ssm.chunk_scan", "chunk_scan", m=256, n=64, k=16,
                       batch=1024),
            KernelSite("s", "chunk_scan", m=2048, n=64, k=2048, batch=2),
            KernelSite("s", "chunk_scan", m=128, n=64, k=20, batch=64),
            KernelSite("s", "chunk_scan", m=64, n=64, k=8, batch=1)]
    return out


def test_tile_ok_and_h100_cost_model_agree_on_chunk_scans():
    """``tile_ok`` and ``CostModelEnv(legality="h100")`` follow the one K3
    predicate on every ``chunk_choices`` value, scalar and vectorised."""
    sites = _chunk_sites()
    space = ActionSpace(DEFAULT)
    env = CostModelEnv(DEFAULT, legality="h100")
    grid = env.cost_grid(sites)
    n_legal = n_illegal = 0
    for i, s in enumerate(sites):
        for a, q in enumerate(DEFAULT.chunk_choices):
            ok = ops.tile_ok(s, (q, 1, 1))
            assert ok == bool(ops.chunk_tiles_legal(s.batch * s.m, s.n, s.k,
                                                    q))
            assert np.isfinite(grid[i, a]) == ok
            assert (tcm.site_cost(s, (q, 1, 1), "h100") is None) == (not ok)
            assert (env.cost(s, (a, 0, 0)) is None) == (not ok)
            n_legal += ok
            n_illegal += not ok
    assert n_legal and n_illegal
    # every Q the serve site's grid offers launches, Q = 1024 included
    xl = sites[0]
    assert xl.key() == "chunk_scan:mlstm.chunk_scan:m256n1024k1024b32:" \
                       "bfloat16:nn:f0"
    assert all(ops.tile_ok(xl, (q,)) for q in DEFAULT.chunk_choices)


def test_tpu_v5e_chunk_legality_stays_the_reference():
    """Under ``legality="tpu_v5e"`` chunk-scan grids are the reference's
    VMEM rule, bitwise (Q = 1024 at the xLSTM site overflows VMEM)."""
    sites = _chunk_sites()[:3]
    got = tcv.cost_grid(ActionSpace(DEFAULT), sites, "tpu_v5e")
    jsites = [_jsite(s) for s in sites]
    want = jcv.cost_grid(JActionSpace(JDEFAULT), jsites)
    assert np.array_equal(got, want)
    assert np.isinf(got[0, DEFAULT.chunk_choices.index(1024)])


def _jsite(s):
    from repro.models.compute import KernelSite as JKernelSite
    return JKernelSite(**{f.name: getattr(s, f.name)
                          for f in dataclasses.fields(KernelSite)})
