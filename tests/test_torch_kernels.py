"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU ``repro_torch.kernels.ops`` takes each kernel's plain PyTorch
version; the JAX side runs the Pallas kernels in interpret mode, as
``tests/test_kernels.py`` does.  Inputs are numpy arrays from a fixed seed,
handed to both.  The shapes and tile sets are those of
``tests/test_kernels.py``; so are the f32 tolerances (1e-5 relative for
matmul, 2e-5 absolute for attention: both sides accumulate in f32 and differ
only in summation order).

The kernels themselves are tested on the card in ``test_torch_gpu.py``.
"""
import ctypes
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.neurovec import DEFAULT as NV
from repro.kernels import ops as jops
from repro.kernels.matmul import _ceil_mult
from repro_torch.core import costmodel as tcm
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops, ref
from repro_torch.models.compute import KernelSite

MM_SHAPES = [(64, 128, 128), (128, 256, 512), (100, 300, 200), (8, 128, 64),
             (513, 129, 257), (16, 384, 48)]
MM_TILES = [(32, 128, 128), (64, 256, 128), (8, 128, 512)]
MM_REL_TOL = 1e-5
ATTN_ABS_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small CPU tensors: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _both_matmul(x, w, tiles):
    yj = np.asarray(jops.matmul(jnp.asarray(x), jnp.asarray(w), tiles=tiles,
                                interpret=True))
    yt = ops.matmul(torch.from_numpy(x), torch.from_numpy(w),
                    tiles=tiles).numpy()
    return yt, yj


def _both_attention(q, k, v, causal, scale, tiles):
    yj = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale, tiles=tiles, interpret=True))
    yt = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal, scale=scale,
                             tiles=tiles).numpy()
    return yt, yj


# ---------------------------------------------------------------------------
# K1: tiled matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MM_SHAPES)
def test_matmul_matches_pallas(shape):
    M, N, K = shape
    x, w = _normal(M, M, K), _normal(N + K, K, N)
    yt, yj = _both_matmul(x, w, (64, 128, 128))
    assert yt.shape == (M, N)
    assert _rel_err(yt, yj) < MM_REL_TOL


@pytest.mark.parametrize("tiles", MM_TILES)
def test_matmul_tile_invariance_matches_pallas(tiles):
    x, w = _normal(0, 96, 160), _normal(1, 160, 192)
    yt, yj = _both_matmul(x, w, tiles)
    y0 = ops.matmul(torch.from_numpy(x), torch.from_numpy(w),
                    tiles=(96, 192, 160)).numpy()
    assert _rel_err(yt, yj) < MM_REL_TOL
    assert _rel_err(yt, y0) < MM_REL_TOL


def _mm_sweep():
    M, N, K = 48, 160, 136
    return sorted({(min(bm, _ceil_mult(M, 8)), min(bn, _ceil_mult(N, 128)),
                    min(bk, _ceil_mult(K, 128)))
                   for bm, bn, bk in itertools.product(
                       NV.bm_choices, NV.bn_choices, NV.bk_choices)})


@pytest.mark.parametrize("tiles", _mm_sweep())
def test_matmul_action_space_sweep_matches_pallas(tiles):
    x, w = _normal(42, 48, 136), _normal(43, 136, 160)
    yt, yj = _both_matmul(x, w, tiles)
    assert _rel_err(yt, yj) < MM_REL_TOL


def test_matmul_default_tiles_are_the_baseline():
    x, w = _normal(5, 40, 72), _normal(6, 72, 24)
    y_none = ops.matmul(torch.from_numpy(x), torch.from_numpy(w))
    y_base = ops.matmul(torch.from_numpy(x), torch.from_numpy(w),
                        tiles=tcm.baseline_matmul_tiles(40, 24, 72))
    assert torch.equal(y_none, y_base)
    assert _rel_err(y_none.numpy(), x @ w) < MM_REL_TOL


def test_matmul_plain_keeps_input_dtype_and_strided_weight():
    """bf16 in, bf16 out; a transposed weight view (lm_head's head.T)."""
    x = torch.from_numpy(_normal(7, 4, 64)).bfloat16()
    head = torch.from_numpy(_normal(8, 96, 64)).bfloat16()
    y = ops.matmul(x, head.T)
    assert y.dtype == torch.bfloat16 and y.shape == (4, 96)
    want = x.float().numpy() @ head.float().numpy().T
    assert _rel_err(y.float().numpy(), want) < 1e-2     # bf16 output


# ---------------------------------------------------------------------------
# K2: flash attention (forward)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("tiles", [(64, 128), (128, 128)])
def test_flash_attention_matches_pallas(causal, hq, hkv, tiles):
    q = _normal(0, 2, hq, 256, 64)
    k = _normal(1, 2, hkv, 256, 64)
    v = _normal(2, 2, hkv, 256, 64)
    yt, yj = _both_attention(q, k, v, causal, 0.125, tiles)
    assert float(np.max(np.abs(yt - yj))) < ATTN_ABS_TOL


def _attn_sweep():
    return sorted({(min(bq, 128), min(bkv, 256))
                   for bq, bkv in itertools.product(NV.bq_choices,
                                                    NV.bkv_choices)})


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tiles", _attn_sweep())
def test_attention_action_space_sweep_matches_pallas(tiles, causal):
    """Sq = 128 < Skv = 256: bottom-right aligned causal mask.  Skv >= Sq,
    as in tests/test_kernels.py (a fully masked row is NaN in the ref)."""
    q = _normal(7, 1, 2, 128, 64)
    k = _normal(8, 1, 2, 256, 64)
    v = _normal(9, 1, 2, 256, 64)
    yt, yj = _both_attention(q, k, v, causal, 64 ** -0.5, tiles)
    assert float(np.max(np.abs(yt - yj))) < ATTN_ABS_TOL
    yr = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal,
                           scale=64 ** -0.5).numpy()
    assert float(np.max(np.abs(yt - yr))) < ATTN_ABS_TOL


@pytest.mark.parametrize("sq,bq,skv,bkv", [(96, 64, 128, 128),
                                           (128, 128, 192, 128)])
def test_attention_blocks_must_divide(sq, bq, skv, bkv):
    """The reference asserts Sq % bq == 0 and Skv % bkv == 0 after the
    min(block, S) clamp; the port raises the same error on every device."""
    q = torch.zeros((1, 1, sq, 64))
    k = torch.zeros((1, 1, skv, 64))
    with pytest.raises(ValueError, match="divide"):
        ops.flash_attention(q, k, k, causal=True, scale=0.125,
                            tiles=(bq, bkv))


def test_attention_default_tiles_are_the_baseline():
    q, k = _normal(3, 1, 2, 128, 32), _normal(4, 1, 1, 128, 32)
    qt, kt = torch.from_numpy(q), torch.from_numpy(k)
    y_none = ops.flash_attention(qt, kt, kt, causal=True, scale=0.2)
    y_base = ops.flash_attention(qt, kt, kt, causal=True, scale=0.2,
                                 tiles=tcm.baseline_attn_tiles(128, 128))
    assert torch.equal(y_none, y_base)


# ---------------------------------------------------------------------------
# the tile predicate and the device rule
# ---------------------------------------------------------------------------

def test_tile_ok_limits():
    big = KernelSite("s", "matmul", m=2048, n=4096, k=4096)
    assert ops.tile_ok(big, (128, 128, 512))
    assert ops.tile_ok(big, (128, 256, 4096))     # bk never limits
    assert ops.tile_ok(big, (64, 512, 128))
    assert not ops.tile_ok(big, (256, 256, 128))  # 256x256 f32 accumulator
    assert not ops.tile_ok(big, (512, 128, 128))  # more rows than 256
    dec = KernelSite("s", "matmul", m=4, n=4096, k=4096)
    assert ops.tile_ok(dec, (512, 256, 128))      # bm clamps to ceil8(4)
    att = KernelSite("a", "attention", m=512, n=128, k=512, batch=128,
                     causal=True)
    assert ops.tile_ok(att, (128, 512, 1))
    assert not ops.tile_ok(att, (256, 512, 1))    # bq * D > 128 * 128
    att_dec = KernelSite("a", "attention", m=1, n=128, k=528, batch=128,
                         causal=True)
    assert ops.tile_ok(att_dec, (1024, 2048, 1))  # decode never launches K2


def test_matmul_tile_plan_covers_every_legal_tile():
    """Every legal clamped tile maps to CTA tiles the CUDA source compiles:
    a wgmma tile (its REPRO_TMA_CASE list, rows padded to 64) and an
    unaligned-variant tile (its REPRO_MM_CASE list)."""
    compiled_tma = {(64, 128), (64, 256), (64, 512), (128, 128), (128, 256),
                    (256, 128)}
    compiled = {(16, 128), (16, 256), (16, 512), (32, 128), (32, 256),
                (32, 512), (64, 128), (64, 256), (64, 512), (128, 128),
                (128, 256), (256, 128)}
    for M, N, K in [(2048, 4096, 4096), (4, 151936, 4096), (48, 160, 136),
                    (4, 1024, 4096)]:
        for t in itertools.product(NV.bm_choices, NV.bn_choices,
                                   NV.bk_choices):
            plan = ops.matmul_tile_plan(M, N, K, t)
            assert (plan is None) == (not ops.matmul_tiles_legal(M, N, K,
                                                                 *t))
            if plan is not None:
                bm, bn, bk, rows, cols = plan
                assert (rows, cols) in compiled
                assert (max(64, rows), cols) in compiled_tma   # wgmma: 64
                assert bm <= rows and bn <= cols


def _first_kernel_legal(M, N, K, bm, bn, bk):
    """The K1 launch rule of the first (mma.sync) kernel, written out as
    the oracle: bm clamped to ceil8(M) and bn to ceil128(N), each rounded
    up to a power of two (at least 16 rows, 128 columns); at most 256 rows,
    512 columns and 128 * 256 f32 accumulators; bk never limits."""
    if min(bm, bn, bk) <= 0:
        return False

    def pow2(v, lo):
        p = 1
        while p < v:
            p *= 2
        return max(lo, p)
    rows = pow2(min(bm, -(-M // 8) * 8), 16)
    cols = pow2(min(bn, -(-N // 128) * 128), 128)
    return rows <= 256 and cols <= 512 and rows * cols <= 128 * 256


def _site_shapes():
    from repro_torch.configs import get_config
    from repro_torch.core.extractor import extract_serve_sites
    from repro_torch.models.lm import build_model
    shapes = set()
    for arch in ("qwen3_8b", "xlstm_1_3b"):
        sites = extract_serve_sites(build_model(get_config(arch)), 4, 512,
                                    16)
        shapes |= {(s.m, s.n, s.k) for s in sites if s.kind == "matmul"}
    # the ragged shapes of tests/test_torch_gpu.py
    return sorted(shapes | {(513, 129, 257), (100, 300, 200), (37, 520, 136),
                            (513, 1032, 200), (513, 136, 200),
                            (4, 1000, 4096), (200, 640, 384),
                            (2048, 1024, 640), (64, 384, 1024)})


def test_matmul_legal_set_is_unchanged():
    """The Hopper redesign keeps the launch rule: over every tile of the
    action grid at every matmul site shape of qwen3_8b and xlstm_1_3b (and
    the GPU tests' ragged shapes), matmul_tiles_legal and tile_ok agree
    with the first kernel's rule, written out above."""
    grid = list(itertools.product(NV.bm_choices, NV.bn_choices,
                                  NV.bk_choices))
    n_legal = 0
    for M, N, K in _site_shapes():
        site = KernelSite("s", "matmul", m=M, n=N, k=K)
        for t in grid:
            want = _first_kernel_legal(M, N, K, *t)
            assert bool(ops.matmul_tiles_legal(M, N, K, *t)) == want, (M, t)
            assert ops.tile_ok(site, t) == want, (M, N, K, t)
            n_legal += want
    assert 0 < n_legal < len(grid) * len(_site_shapes())


def _split_runs(K, p):
    """``[k_lo, k_hi)`` of each CTA along K under plan ``p``: CTA z walks
    ``[z * k_run, (z + 1) * k_run)`` of K in stages up to 128 deep."""
    return [(z * p.k_run, min(K, (z + 1) * p.k_run)) for z in range(p.splits)]


@pytest.mark.parametrize("sms", [132, 114])
def test_matmul_splits_only_a_small_grid_into_whole_bk_blocks(sms):
    """The split over K happens only when the output grid has fewer CTAs
    than the card has SMs and bk is a multiple of the deepest stage; its
    runs are whole bk blocks, at most one CTA a block, and together they
    cover K exactly once."""
    n_split = 0
    for M, N, K in _site_shapes():
        for t in itertools.product(NV.bm_choices, NV.bn_choices,
                                   NV.bk_choices):
            p = ops.matmul_launch_plan(M, N, K, t, sms)
            if p is None:
                continue
            n_tiles = p.grid_m * p.grid_n
            assert (p.variant == "split_k") == (p.splits > 1)
            if n_tiles >= sms or p.bk % ops.MM_K_STAGE:
                assert p.splits == 1
            assert p.splits <= max(1, sms // n_tiles)
            assert p.splits <= -(-K // p.bk)
            runs = _split_runs(K, p)
            assert runs[0][0] == 0 and runs[-1][1] == K
            for (lo, hi), (lo2, _) in zip(runs, runs[1:]):
                assert hi == lo2
            for lo, hi in runs:
                assert lo % p.bk == 0 and lo < hi
                assert hi == K or hi % p.bk == 0
            n_split += p.splits > 1
            unaligned = ops.matmul_launch_plan(M, N, K, t, sms,
                                               aligned=False)
            assert unaligned.variant == "unaligned"
            assert unaligned.splits == 1
    assert n_split > 0


@pytest.mark.parametrize("shape,tiles,splits", [
    ((4, 4096, 4096), (8, 128, 96), 1),       # bk not a multiple of 64
    ((4, 4096, 4096), (8, 128, 192), 1),      # 64 | bk, 128 does not
    ((4, 4096, 4096), (8, 128, 384), 4),      # 128 | bk, bk not 2^n
    ((4, 1024, 4096), (8, 128, 640), 7),
    ((4, 4096, 12288), (16, 512, 1024), 12),
    ((4, 4096, 4096), (8, 128, 512), 4),
    ((2048, 1024, 640), (64, 512, 128), 2),
    ((513, 136, 200), (64, 128, 128), 2),
])
def test_matmul_split_runs_are_whole_stages(shape, tiles, splits):
    """The kernel walks each CTA's run of K from its start in stages of 64
    or 128 (its tile's stage depth): every stage but the last of K lies
    inside its own run, so no part of K is summed by two CTAs."""
    M, N, K = shape
    p = ops.matmul_launch_plan(M, N, K, tiles, 132)
    assert p.splits == splits
    assert p.variant == ("split_k" if splits > 1 else "tma_wgmma")
    covered = np.zeros(K, np.int64)
    for lo, hi in _split_runs(K, p):
        for depth in (64, ops.MM_K_STAGE):
            stages = range(lo, hi, depth)
            assert all(k + depth <= hi for k in stages[:-1])
            assert stages[-1] + depth <= hi or hi == K
        covered[lo:hi] += 1
    assert (covered == 1).all()


def _first_kernel_attention_legal(Sq, Skv, D, bq, bkv):
    """The K2 launch rule of PRs 11-13 (16 query rows a warp, at most 8
    warps), written out as the oracle: positive blocks clamped to the
    sequence, bq * D <= 128 * 128, blocks that divide the sequence; a
    decode site (Sq == 1) never launches K2."""
    if bq <= 0 or bkv <= 0:
        return False
    if Sq == 1:
        return True
    bq_e, bkv_e = min(bq, Sq), min(bkv, Skv)
    return bq_e * D <= 128 * 128 and Sq % bq_e == 0 and Skv % bkv_e == 0


def _attention_rule(Sq, Skv, D, bq, bkv, dtype):
    """The K2 launch rule with its dtype and head-dim clauses, written out:
    bf16 only; at Sq > 1 a head dim that is a multiple of 8 up to 128,
    where the first kernel's rule holds at the padded head dim 128 (at D =
    128 that rule, unchanged)."""
    if dtype != "bfloat16":
        return False
    if Sq > 1 and (D % 8 or not 8 <= D <= 128):
        return False
    return _first_kernel_attention_legal(Sq, Skv, 128, bq, bkv)


def _attention_site_shapes():
    """(Sq, Skv, D) of qwen3_8b's serve sites (prefill and decode, which
    the measurement runner times as they are) and of the GPU tests, and
    Sq in {16, 128, 256, 512} against every Skv of them."""
    from repro_torch.configs import get_config
    from repro_torch.core.extractor import extract_serve_sites
    from repro_torch.models.lm import build_model
    sites = extract_serve_sites(build_model(get_config("qwen3_8b")), 4, 512,
                                16)
    shapes = {(s.m, s.k, s.n) for s in sites if s.kind == "attention"}
    lens = (16, 128, 256, 512)
    shapes |= {(sq, skv, 128) for sq in lens for skv in lens + (384,)}
    shapes |= {(256, 128, 128), (96, 96, 128), (192, 192, 128),
               (512, 512, 64), (512, 512, 80)}
    # the head dims of the corpus (and of stablelm_3b, 80), and some K2
    # refuses: not a multiple of 8, or past 128
    shapes |= {(sq, 512, d) for sq in (1, 256, 512)
               for d in (16, 40, 64, 80, 96, 192, 20, 136)}
    return sorted(shapes)


_ATTN_BLOCKS = sorted(set(NV.bq_choices) | {16, 32, 96})
_ATTN_KV_BLOCKS = sorted(set(NV.bkv_choices) | {16, 64})


def test_attention_legal_set_is_unchanged():
    """K2's launch rule over the action grid (and a few smaller blocks) at
    every attention site shape and in bf16 and f32: attention_tiles_legal
    and tile_ok agree with the rule written out above.  At head dim 128 in
    bf16 (every qwen3_8b site) that is the first kernel's rule, unchanged;
    the other head dims launch at the padded 128, and f32 never."""
    n_legal = n_all = 0
    for (Sq, Skv, D), dtype in itertools.product(_attention_site_shapes(),
                                                 ("bfloat16", "float32")):
        site = KernelSite("a", "attention", m=Sq, n=D, k=Skv, batch=128,
                          causal=True, dtype=dtype)
        for t in itertools.product(_ATTN_BLOCKS, _ATTN_KV_BLOCKS):
            want = _attention_rule(Sq, Skv, D, *t, dtype)
            if D == 128 and dtype == "bfloat16":
                assert want == _first_kernel_attention_legal(Sq, Skv, D, *t)
            assert bool(ops.attention_tiles_legal(
                Sq, Skv, D, *t, dtype=dtype)) == want, (Sq, Skv, D, t, dtype)
            assert ops.tile_ok(site, t) == want, (Sq, Skv, D, t, dtype)
            n_legal += want
            n_all += 1
    assert 0 < n_legal < n_all


def _model_strides(B, H, S, D):
    """q and k contiguous; v the transposed view of its projection
    (``models/attention.py:_split_heads``)."""
    return ((H * S * D, S * D, D, 1), (H * S * D, S * D, D, 1),
            (S * H * D, D, H * D, 1))


def test_attention_launch_plan_covers_every_legal_tile():
    """Every legal tile, at every head dim the rule admits, plans the
    tma_wgmma variant with one or two 64-row warpgroups covering bq, 64- or
    128-key stages that cover Skv, whose edges fall on the bkv block edges
    where bkv >= 64 (or the block is the whole sequence), and a ring whose
    shared memory, counted at the padded head dim 128, fits;
    a tile whose blocks do not divide the sequence (legal at Sq == 1,
    where K2 never runs) plans nothing; the model's
    strided v and the runner's contiguous layout plan tma_wgmma, and an
    operand TMA cannot take plans the unaligned variant."""
    n = 0
    for Sq, Skv, D in _attention_site_shapes():
        for t in itertools.product(_ATTN_BLOCKS, _ATTN_KV_BLOCKS):
            legal = bool(ops.attention_tiles_legal(Sq, Skv, D, *t))
            p = ops.attention_launch_plan(Sq, Skv, D, *t)
            divides = Sq % min(t[0], Sq) == 0 and Skv % min(t[1], Skv) == 0
            if not legal or not divides:
                assert p is None
                continue
            n += 1
            bq, bkv = kfa.effective_blocks(Sq, Skv, *t)
            assert p.variant == "tma_wgmma" and (p.bq, p.bkv) == (bq, bkv)
            assert p.warpgroups in (1, 2)
            assert (p.warpgroups - 1) * 64 < bq <= p.warpgroups * 64
            assert p.stage_keys == (128 if bkv >= 128 else 64)
            assert (p.n_stages - 1) * p.stage_keys < Skv
            assert p.n_stages * p.stage_keys >= Skv
            if bkv >= 64:        # the action space's blocks: 128 and up
                assert bkv % p.stage_keys == 0 or bkv == Skv
            assert 1 <= p.ring <= min(ops.ATTN_MAX_RING, p.n_stages)
            assert p.ring >= min(2, p.n_stages)
            assert p.smem == (2 * p.warpgroups * 64 * ops.ATTN_D_PAD * 2
                              + p.ring * 4 * p.stage_keys * ops.ATTN_D_PAD
                              + 1024)
            assert p.smem <= 232448 - 1024
    assert n > 0
    model = ops.attention_launch_plan(512, 512, 128, 128, 128,
                                      _model_strides(4, 8, 512, 128))
    runner = ops.attention_launch_plan(
        512, 512, 128, 128, 512, ((128 * 512 * 128, 512 * 128, 128, 1),) * 3)
    assert model.variant == runner.variant == "tma_wgmma"
    assert (model.warpgroups, model.stage_keys, model.n_stages) == (2, 128, 4)
    odd = ((8 * 512 * 129, 512 * 129, 129, 1),) + _model_strides(
        1, 8, 512, 128)[1:]
    d_strided = _model_strides(1, 8, 512, 128)[:2] + ((0, 0, 0, 2),)
    for strides, aligned in ((odd, True), (d_strided, True),
                             (_model_strides(1, 8, 512, 128), False)):
        p = ops.attention_launch_plan(512, 512, 128, 128, 128, strides,
                                      aligned=aligned)
        assert p.variant == "unaligned"


def test_attention_tma_strides_ignore_single_element_dims():
    """A dimension of one element may carry any stride in PyTorch; the
    wrapper hands TMA its contiguous one."""
    t = torch.empty(4096).as_strided((1, 2, 16, 128), (3, 2048, 128, 1))
    assert kfa._tma_strides(t) == (4096, 2048, 128, 1)
    v = torch.empty(2, 16, 4, 128).reshape(2, 16, 4, 128).transpose(1, 2)
    assert kfa._tma_strides(v) == v.stride() == (8192, 128, 512, 1)


def _emulate_tma_kernel(q, k, v, *, causal, scale, tiles):
    """The tma_wgmma variant's walk in plain PyTorch, f32: its CTAs of
    ``bq`` rows in 64-row warpgroups (rows past Sq zero, as TMA fills
    them), the causal skip of whole stages, masks on edge stages only,
    the online softmax in the log2 domain, P rounded to bf16."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    p = ops.attention_launch_plan(Sq, Skv, D, *tiles)
    keys, bq = p.stage_keys, p.bq
    c = scale * 1.4426950408889634
    k = k.repeat_interleave(Hq // Hkv, 1).float()
    v = v.repeat_interleave(Hq // Hkv, 1).float()
    pad = keys * p.n_stages - Skv
    k = torch.nn.functional.pad(k, (0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    qz = torch.nn.functional.pad(q.float(), (0, 0, 0, 128))
    out = torch.empty(B, Hq, Sq, D)
    q_off = Skv - Sq
    for q0 in range(0, Sq, bq):
        nst = p.n_stages
        if causal and q0 + q_off >= 0:
            nst = min(nst, (q0 + bq - 1 + q_off) // keys + 1)
        for wg in range(p.warpgroups):
            r0 = q0 + wg * 64
            qw = qz[:, :, r0:r0 + 64]
            qpos = torch.arange(r0, r0 + 64) + q_off
            m = torch.full((B, Hq, 64, 1), ops.kfa.NEG_INF)
            l = torch.zeros((B, Hq, 64, 1))
            o = torch.zeros((B, Hq, 64, D))
            for i in range(nst):
                k0 = i * keys
                x = qw @ k[:, :, k0:k0 + keys].transpose(-1, -2) * c
                if k0 + keys > Skv or (causal and k0 + keys - 1 > r0 + q_off):
                    key = torch.arange(k0, k0 + keys)
                    if causal:
                        x = x.masked_fill(key[None, :] > qpos[:, None],
                                          kfa.NEG_INF)
                    x = x.masked_fill(key[None, :] >= Skv, -float("inf"))
                m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                corr = torch.exp2(m - m_new)
                pr = torch.exp2(x - m_new)
                l = l * corr + pr.sum(-1, keepdim=True)
                o = o * corr + pr.bfloat16().float() @ v[:, :, k0:k0 + keys]
                m = m_new
            rows = min(64, bq - wg * 64)
            out[:, :, r0:r0 + rows] = (o / l.clamp(min=1e-30))[:, :, :rows]
    return out.to(q.dtype)


@pytest.mark.parametrize("sq,skv,hq,hkv,tiles,causal", [
    (256, 256, 4, 2, (128, 128), True),     # two warpgroups, GQA
    (256, 256, 4, 2, (64, 256), True),      # one warpgroup, bkv = 2 stages
    (128, 384, 2, 2, (128, 128), True),     # Sq < Skv: shifted diagonal
    (256, 128, 2, 1, (128, 128), True),     # Sq > Skv: rows that see no key
    (16, 16, 2, 2, (64, 128), True),        # 16 rows of a 64-row warpgroup
    (96, 96, 2, 1, (128, 128), True),       # 96 rows: a part warpgroup
    (128, 200, 2, 2, (128, 512), False),    # a ragged last stage
    (192, 320, 2, 1, (64, 64), False),      # 64-key stages
])
def test_tma_kernel_walk_matches_the_plain_version(sq, skv, hq, hkv, tiles,
                                                    causal):
    """The redesigned kernel's walk (stages of the launch plan, causal
    skip, edge masks, exp2) computes the plain version's function: held
    at f32 within 2e-5 after the bf16 output rounding of both (P is
    rounded to bf16 in both, against maxima of other blocks, hence
    bf16-level differences at most)."""
    q = torch.from_numpy(_normal(11, 1, hq, sq, 128)).bfloat16()
    k = torch.from_numpy(_normal(12, 1, hkv, skv, 128)).bfloat16()
    v = torch.from_numpy(_normal(13, 1, hkv, skv, 128)).bfloat16()
    want = kfa.flash_attention_plain(q, k, v, causal=causal,
                                     scale=128 ** -0.5, bq=tiles[0],
                                     bkv=tiles[1]).float()
    got = _emulate_tma_kernel(q, k, v, causal=causal, scale=128 ** -0.5,
                              tiles=tiles).float()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) < 2e-2
    if sq > skv and causal:      # rows that see no key: the mean of V
        mean = v.float().mean(2, keepdim=True).repeat_interleave(
            hq // hkv, 1)
        assert float((got[:, :, :sq - skv] - mean).abs().max()) < 1e-2


def test_cpu_tensors_take_the_plain_version():
    """No kernel launches on CPU tensors; the counters stay put."""
    before = (kmm.launches, kfa.launches)
    ops.matmul(torch.ones((8, 16)), torch.ones((16, 8)))
    ops.flash_attention(torch.ones((1, 2, 8, 16)), torch.ones((1, 1, 8, 16)),
                        torch.ones((1, 1, 8, 16)), causal=True, scale=0.25)
    assert (kmm.launches, kfa.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.ones((16, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kmm.matmul_cuda(x, x, 16, 128, 128)
    q = torch.ones((1, 1, 16, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kfa.flash_attention_cuda(q, q, q, causal=True, scale=0.1, bq=16,
                                 bkv=16)


def test_argtypes_pass_pointers_as_64_bit():
    """ctypes would cut an un-declared pointer to 32 bits."""
    assert kmm._ARGTYPES[:3] == [ctypes.c_void_p] * 3
    assert kmm._ARGTYPES[-1] is ctypes.c_void_p
    assert kmm._TMA_ARGTYPES[:5] == [ctypes.c_void_p] * 5
    assert kmm._TMA_ARGTYPES[-1] is ctypes.c_void_p
    assert kfa._ARGTYPES[:4] == [ctypes.c_void_p] * 4
    assert kfa._ARGTYPES[-1] is ctypes.c_void_p


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(build.KernelBuildError, match="nvcc"):
        build._nvcc()


def test_the_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    """Every module of ``repro_torch`` and ``chip_smoke.py`` import in a
    fresh interpreter that refuses ``jax``, ``repro`` and ``triton``
    (Triton is imported only inside a launching function, never at
    import time)."""
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    code = f"""
import importlib, importlib.util, pkgutil, sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "triton"):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {str(root / 'src')!r})
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location(
    "chip_smoke", {str(root / 'chip_smoke.py')!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton")]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
