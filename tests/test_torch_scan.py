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
    predicate, at the site's dtype, on every ``chunk_choices`` value,
    scalar and vectorised."""
    sites = _chunk_sites()
    space = ActionSpace(DEFAULT)
    env = CostModelEnv(DEFAULT, legality="h100")
    grid = env.cost_grid(sites)
    n_legal = n_illegal = 0
    for i, s in enumerate(sites):
        for a, q in enumerate(DEFAULT.chunk_choices):
            ok = ops.tile_ok(s, (q, 1, 1))
            assert ok == bool(ops.chunk_tiles_legal(s.batch * s.m, s.n, s.k,
                                                    q, dtype=s.dtype))
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


# ---------------------------------------------------------------------------
# The Hopper redesign: the three passes, the legal set, the launch plan
# ---------------------------------------------------------------------------

PASS_TOL = 3e-2     # of the largest |output|: the passes round B·d, the
                    # entering state and the masked scores to bf16 (2^-9
                    # each), as the kernel does (K3_TOL in chip_smoke.py)


def _chunk_scan_passes(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                       la: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """K3's passes (``csrc/chunk_scan.cu``) in plain PyTorch, f32 with the
    kernel's bf16 roundings at the same points: ``B ⊙ d`` (chunk_state),
    the state entering each chunk (state_pass or the walk) and the masked
    scores (chunk_out).  Output in ``x.dtype``."""
    G, S, P = x.shape
    N = Bm.shape[-1]
    Q = kcs.effective_chunk(S, chunk)
    nc = S // Q

    def bf(t):
        return t.to(torch.bfloat16).float()
    xf = x.float().reshape(G, nc, Q, P)
    bfm = Bm.float().reshape(G, nc, Q, N)
    cf = Cm.float().reshape(G, nc, Q, N)
    cum = torch.cumsum(la.float().reshape(G, nc, Q), dim=-1)
    # chunk_state: each chunk's own state, from zero
    d = torch.exp(cum[..., -1:] - cum)
    dstate = xf.transpose(-1, -2) @ bf(bfm * d[..., None])     # (G,nc,P,N)
    # state_pass: the chain over chunks, the entering state in bf16
    decay = torch.exp(cum[..., -1])                           # (G,nc)
    state = torch.zeros((G, P, N), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(bf(state))
        state = decay[:, c, None, None] * state + dstate[:, c]
    states = torch.stack(entering, dim=1)                     # (G,nc,P,N)
    # chunk_out: masked scores in bf16, then both terms
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    li = cum[..., :, None] - cum[..., None, :]
    L = torch.where(causal, torch.exp(li), torch.zeros_like(li))
    scores = bf((cf @ bfm.transpose(-1, -2)) * L)
    y = (torch.exp(cum)[..., None] * (cf @ states.transpose(-1, -2))
         + scores @ xf)
    return y.reshape(G, S, P).to(x.dtype)


@pytest.mark.parametrize("G,S,P,N,Q", [
    (1, 128, 16, 16, 64),            # two chunks
    (2, 200, 12, 24, 40),            # G > 1, N = 24, a chunk end inside a
                                     # 64-row box
    (1, 1024, 8, 16, 16),            # 64 chunks
    (3, 256, 24, 8, 128),            # G = 3, the narrowest N
])
def test_chunk_scan_passes_match_pallas_plain_and_oracle(G, S, P, N, Q):
    """The kernel's three passes, emulated in plain PyTorch with its bf16
    roundings, against the JAX package's Pallas kernel in interpret mode,
    the port's plain version and the sequential oracle, within PASS_TOL of
    the largest output."""
    arrs = _inputs(7, G, S, P, N)
    y = _chunk_scan_passes(*_torch(*arrs), chunk=Q).numpy()
    jarrs = list(map(jnp.asarray, arrs))
    assert _rel(y, jops.chunk_scan(*jarrs, chunk=Q, interpret=True)) \
        < PASS_TOL
    assert _rel(y, kcs.chunk_scan_plain(*_torch(*arrs), chunk=Q)) < PASS_TOL
    assert _rel(y, jref.chunk_scan_ref(*jarrs)) < PASS_TOL


def test_chunk_scan_passes_round_where_the_kernel_does():
    """With bf16 inputs the passes differ from the f32 plain version by
    about bf16's rounding and not less: the roundings are there."""
    x, Bm, Cm, la = (t.bfloat16() for t in _torch(*_inputs(8, 1, 256, 32,
                                                            32)))
    got = _chunk_scan_passes(x, Bm, Cm, la, chunk=64).float()
    want = kcs.chunk_scan_plain(x.float(), Bm.float(), Cm.float(),
                                la.float(), chunk=64)
    rel = _rel(got, want)
    assert 1e-4 < rel < PASS_TOL


_CHUNKS = sorted(set(DEFAULT.chunk_choices) | {1, 16, 40, 100, 320, 2048,
                                               4096})


def _first_kernel_chunk_legal(S, N, Q):
    """The first K3 kernel's launch rule, written out: the chunk clamped
    to S at most 1024, N a multiple of 8 from 8 to 1024; P never
    limits."""
    return Q > 0 and min(Q, S) <= 1024 and 8 <= N <= 1024 and N % 8 == 0


def test_chunk_legal_set_is_unchanged():
    """The Hopper redesign keeps K3's launch rule: over the action grid's
    chunks and a few others at every chunk-scan site of ``_chunk_sites``,
    chunk_tiles_legal and tile_ok agree with the first kernel's rule at
    the bf16 sites; K3 takes bf16 only, so an f32 site has no legal
    chunk."""
    n_legal = n_all = 0
    for s in _chunk_sites():
        S = s.batch * s.m
        for q in _CHUNKS:
            want = (s.dtype == "bfloat16"
                    and _first_kernel_chunk_legal(S, s.k, q))
            assert bool(ops.chunk_tiles_legal(S, s.n, s.k, q,
                                              dtype=s.dtype)) == want, \
                (s.key(), q)
            assert ops.tile_ok(s, (q, 1, 1)) == want, (s.key(), q)
            n_legal += want
            n_all += 1
    assert 0 < n_legal < n_all


def _plan_shapes():
    """(G, S, P, N, Q) of every legal chunk at every chunk-scan site (S
    snapped up to the clamped chunk, as the runner does), plus the GPU
    tests' shapes."""
    out = set()
    for s in _chunk_sites():
        for q in _CHUNKS:
            S = s.batch * s.m
            if ops.chunk_tiles_legal(S, s.n, s.k, q):
                qe = min(q, S)
                out.add((1, -(-S // qe) * qe, s.n, s.k, q))
    out |= {(1, 8192, 1024, 1024, 64), (2, 256, 7, 16, 64),
            (1, 640, 200, 136, 320), (4, 32768, 64, 16, 256),
            (3, 384, 40, 24, 128), (2, 200, 32, 16, 40),
            (1, 262144, 64, 16, 256), (1, 4096, 1024, 1024, 1)}
    return sorted(out)


@pytest.mark.parametrize("variant", [None, "three_pass", "walk"])
def test_chunk_launch_plan_covers_every_legal_shape(variant, monkeypatch):
    """Every legal shape plans (the rule's variant, and each variant when
    forced); the tiles are the kernel's, they cover P and N, the grids
    match them, the rings hold at least one stage (two when a pass has
    more than one) and each pass fits the card's shared memory."""
    if variant is not None:
        monkeypatch.setattr(ops, "chunk_launch_plan",
                            lambda *a: ops._chunk_plan(*a, ops.CHUNK_RING,
                                                       variant))
    box, limit = ops.CHUNK_BOX, 232448
    for G, S, P, N, Q in _plan_shapes():
        p = ops.chunk_launch_plan(G, S, P, N, Q)
        assert p is not None, (G, S, P, N, Q)
        assert p.variant == (variant or p.variant)
        assert p.variant in ("three_pass", "walk")
        nc_g, n_q = S // p.Q, -(-p.Q // box)
        assert p.Q == min(Q, S) and p.n_chunks == G * nc_g
        assert p.P_pad % 8 == 0 and P <= p.P_pad < P + 8
        assert p.state_cols in (64, 128)
        assert p.p_tile in (64, 128, 256) and p.state_cols <= p.p_tile
        assert p.state_wgs == (1 if N <= box else 2)
        tiles = (G * -(-N // (box * p.state_wgs))
                 * -(-p.P_pad // p.state_cols))
        walk = p.variant == "walk"
        assert p.state_grid == (tiles if walk else tiles * nc_g)
        assert p.out_grid == G * nc_g * n_q
        stages = n_q * (nc_g if walk else 1)
        assert 1 <= p.state_ring <= min(stages, ops.CHUNK_RING)
        assert p.state_ring >= min(2, stages)
        assert 1 <= p.out_ring <= ops.CHUNK_RING
        assert p.out_ring >= 2 or p.p_tile == box
        assert p.state_smem == (p.state_ring
                                * (p.state_wgs + p.state_cols // box)
                                * box * box * 2 + 1024)
        assert p.out_smem == ((n_q + p.out_ring * (1 + p.p_tile // box))
                              * box * box * 2 + 1024)
        for dyn, static in ((p.state_smem, ops.CHUNK_STATE_STATIC),
                            (p.out_smem, ops.CHUNK_OUT_STATIC)):
            assert dyn <= ops.CHUNK_SMEM_DYN and dyn + static <= limit
        if walk:
            assert p.state_cols <= 128 and p.scan_grid == 0
            assert p.dstate_elems == p.alog_elems == 0
        else:
            seg = p.segments
            assert seg & (seg - 1) == 0 and 1 <= seg <= min(32, nc_g)
            assert p.scan_grid * (ops.SCAN_THREADS // seg) >= G * p.P_pad * N
            assert p.dstate_elems == G * nc_g * p.P_pad * N
            assert p.alog_elems == G * nc_g
        assert p.states_elems == G * nc_g * p.P_pad * N


def test_chunk_launch_plan_rule():
    """The xLSTM site walks its chunks from 32 chunks a group (Q <= 256 at
    S = 8192), 128 CTAs of 128 x 64 state elements, and runs three passes
    above; a Mamba-2 head (one 64 x 16 state) always runs three passes,
    its state pass in 32 segments."""
    variants = {q: ops.chunk_launch_plan(1, 8192, 1024, 1024, q).variant
                for q in DEFAULT.chunk_choices}
    assert variants == {64: "walk", 128: "walk", 256: "walk",
                        512: "three_pass", 1024: "three_pass"}
    walk = ops.chunk_launch_plan(1, 8192, 1024, 1024, 256)
    assert (walk.state_cols, walk.state_wgs, walk.state_grid) == (64, 2, 128)
    mamba = ops.chunk_launch_plan(1, 262144, 64, 16, 256)
    assert mamba.variant == "three_pass" and mamba.segments == 32
    # one stage a ring puts four chunk_out CTAs on a SM, two stages three
    assert (mamba.p_tile, mamba.out_ring, mamba.out_grid) == (64, 1, 4096)
    assert ops.chunk_launch_plan(1, 8192, 1024, 1024, 2048) is None
    assert ops.chunk_launch_plan(1, 8192, 64, 12, 256) is None
    assert ops.chunk_launch_plan(1, 8192, 64, 16, 384) is None


def test_cuda_wrapper_refuses_before_it_plans():
    """On CPU tensors the CUDA wrapper raises before it builds or plans
    anything: a CUDA tensor launches the kernels or raises, and never falls
    back to the plain version."""
    arrs = [a.bfloat16() for a in _torch(*_inputs(9, 1, 128, 8, 8))]
    with pytest.raises(ValueError, match="CUDA"):
        kcs.chunk_scan_cuda(*arrs, chunk=64)
    with pytest.raises(TypeError):
        kcs.chunk_scan_cuda(arrs[0].float(), *arrs[1:], chunk=64)
