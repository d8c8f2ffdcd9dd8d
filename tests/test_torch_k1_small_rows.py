"""K1 at CTA tiles of 16 and 32 rows: the swapped operands and the w
multicast over a thread-block cluster, as far as the CPU can check them.

The kernel runs only on the card (``tests/test_torch_gpu.py`` holds it
against the f32 product there).  Here: the launch rule and every legal
set and cost grid under ``legality="h100"`` are the first kernel's over
the 105-site corpus, the plans of tiles of 64 rows and more are the
direct plan field for field, a swapped tile's cluster divides its
padded grid and its ``group_m``, and ``ops.matmul_cta_tiles`` (the
mirror of the kernel's CTA -> tile map) covers every output tile exactly
once with each cluster on one column block.  Exact integer checks: no
tolerance.
"""
import itertools
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs.neurovec import DEFAULT as NV
from repro_torch.core import costmodel_vec
from repro_torch.core import dataset
from repro_torch.core.env import CostModelEnv
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
ACTION_TILES = list(itertools.product(NV.bm_choices, NV.bn_choices,
                                      NV.bk_choices))


@pytest.fixture(scope="module")
def corpus():
    sites = dataset.arch_sites()
    assert len(sites) == 105
    return sites


def _pow2(v, lo):
    p = 1
    while p < v:
        p *= 2
    return max(lo, p)


def _first_rule(M, N, K, bm, bn, bk, dtype="bfloat16", route="cuda"):
    """K1's launch rule since its first kernel, written out: bf16 or f32
    on the card (any dtype on the CPU route); bm clamped to ceil8(M), bn
    to ceil128(N), each rounded up to a power of two (at least 16 rows,
    128 columns); at most 256 rows, 512 columns and 128 * 256 f32
    accumulators; bk never limits."""
    if route == "cuda" and dtype not in ("bfloat16", "float32"):
        return False
    if min(bm, bn, bk) <= 0:
        return False
    rows = _pow2(min(bm, -(-M // 8) * 8), 16)
    cols = _pow2(min(bn, -(-N // 128) * 128), 128)
    return rows <= 256 and cols <= 512 and rows * cols <= 128 * 256


def _direct_plan(M, N, K, tiles, sms, aligned):
    """K1's bf16 launch plan as it is for a tile that is not swapped,
    written out field for field (variant, bm, bn, bk, rows, cols, grid_m,
    grid_n, splits, k_run, group_m, width, height): the plan every tile
    had while rows below 64 were padded to 64."""
    bm, bn, bk = tiles
    if not _first_rule(M, N, K, bm, bn, bk):
        return None
    bm = min(bm, -(-M // 8) * 8)
    bn = min(bn, -(-N // 128) * 128)
    bk = min(bk, -(-K // 128) * 128)
    rows, cols = _pow2(bm, 16), _pow2(bn, 128)
    grid_m, grid_n = -(-M // bm), -(-N // bn)
    n_tiles, nkb = grid_m * grid_n, -(-K // bk)
    splits, k_run = 1, K
    if aligned and n_tiles < sms and bk % 128 == 0:
        most = min(nkb, sms // n_tiles)
        if most > 1:
            k_run = -(-nkb // most) * bk
            splits = -(-K // k_run)
    variant = ("unaligned" if not aligned
               else "split_k" if splits > 1 else "tma_wgmma")
    band = max(1, (8 << 20) // max(1, bm * K * 2))
    return (variant, bm, bn, bk, rows, cols, grid_m, grid_n, splits, k_run,
            min(grid_m, band), cols, rows)


def _matmul_shapes(corpus):
    return sorted({(s.m, s.n, s.k, s.dtype) for s in corpus
                   if s.kind == "matmul"})


def test_every_legal_tile_at_the_corpus_matmul_sites_is_the_first_rule(
        corpus):
    """At every matmul site of the corpus and every tile of the action
    grid, ``tile_ok`` (both routes) is the rule K1 has had since its first
    kernel: the swapped tiles change no legal set."""
    n_legal = 0
    for s in corpus:
        if s.kind != "matmul":
            continue
        for t in ACTION_TILES:
            for route in ("cuda", "cpu"):
                want = _first_rule(s.m, s.n, s.k, *t, s.dtype, route)
                assert ops.tile_ok(s, t, route) == want, (s.key(), t, route)
            n_legal += want
    assert n_legal > 0


@pytest.mark.parametrize("legality", ["h100", "cpu"])
def test_cost_grids_are_the_first_rules_over_the_corpus(corpus, legality,
                                                        monkeypatch):
    """Every cost grid under the card's rules is, bit for bit, the grid
    the first rule gives: the same legal set and the same prices, so the
    agents pick the same programs."""
    env = CostModelEnv(NV, legality=legality)
    got = env.cost_grid(corpus)

    def first(M, N, K, bm, bn, bk, *, dtype="bfloat16", route="cuda"):
        one = np.vectorize(lambda *a: _first_rule(
            *(int(v) for v in a[:6]), str(a[6]), route), otypes=[bool])
        return one(M, N, K, bm, bn, bk, dtype)
    monkeypatch.setattr(ops, "matmul_tiles_legal", first)
    want = costmodel_vec.cost_grid(env.space, corpus, legality)
    assert np.array_equal(got, want)
    assert np.isfinite(got).any(1).all()


@pytest.mark.parametrize("sms", [132, 114])
def test_rows_64_and_more_keep_the_direct_plan(corpus, sms):
    """Tiles of 64 CTA rows and more, and every unaligned and f32 plan,
    keep the direct plan field for field with a cluster and an occupancy
    of 1; a
    swapped tile (a split too) differs only in its cluster, its occupancy
    and ``group_m``: all its row blocks, rounded up to whole clusters."""
    n_swapped = n_direct = 0
    for M, N, K, _ in _matmul_shapes(corpus):
        for t, aligned in itertools.product(ACTION_TILES, (True, False)):
            p = ops.matmul_launch_plan(M, N, K, t, sms, aligned=aligned)
            want = _direct_plan(M, N, K, t, sms, aligned)
            assert (p is None) == (want is None)
            if p is None:
                continue
            if p.swapped:
                n_swapped += 1
                assert tuple(p[:10]) + tuple(p[11:13]) == \
                    want[:10] + want[11:]
                assert p.group_m == -(-p.grid_m // p.cluster) * p.cluster
                assert p.occupancy == (
                    1 if p.cols == 512 else
                    3 if (p.rows, p.cols) == (32, 128) and p.grid_m
                    * p.grid_n >= ops.MM_OCC3_WAVES * 3 * sms else 2)
            else:
                n_direct += 1
                assert tuple(p[:13]) == want
                assert p.cluster == 1 and p.occupancy == 1
            f32 = ops.matmul_launch_plan(M, N, K, t, sms, dtype="float32")
            assert f32.cluster == 1 and f32.group_m == 1
    assert n_swapped and n_direct


def test_swapped_tiles_take_a_cluster_that_divides_their_grid(corpus):
    """A tile below 64 rows runs the swapped layout, and its cluster is a
    power of two up to ``MM_CLUSTER`` that divides its padded grid of row
    blocks and its ``group_m``: above 1 only at three CTAs an SM (32 x
    128 on a large grid) and K of at least ``MM_CLUSTER_MIN_K``; a grid
    of one row block (decode), a split and every other layout take 1."""
    seen = set()
    for M, N, K, _ in _matmul_shapes(corpus):
        for t in ACTION_TILES:
            p = ops.matmul_launch_plan(M, N, K, t, 132)
            if p is None:
                continue
            assert p.swapped == (p.rows < 64)
            assert p.layout == ("swapped" if p.rows < 64 else "direct")
            c = p.cluster
            assert c in ops.MM_CLUSTERS and c <= ops.MM_CLUSTER
            padded = -(-p.grid_m // c) * c
            assert padded % c == 0 and p.group_m % c == 0
            assert padded - p.grid_m < c
            if (p.grid_m < 2 or p.variant != "tma_wgmma" or p.occupancy < 3
                    or K < ops.MM_CLUSTER_MIN_K):
                assert c == 1
            else:
                assert c == min(ops.MM_CLUSTER,
                                1 << (p.grid_m.bit_length() - 1))
            seen.add(c)
    assert seen == {1, ops.MM_CLUSTER}


def _cover(p):
    """Assert the CTA map of ``p`` covers each output tile exactly once,
    each cluster on one column block and consecutive row blocks."""
    t = ops.matmul_cta_tiles(p)
    c = p.cluster
    n_ctas = -(-p.grid_m // c) * c * p.grid_n
    assert t.shape == (n_ctas, 3)
    real = t[t[:, 0] < p.grid_m]
    assert len(real) == p.grid_m * p.grid_n
    flat = real[:, 0] * p.grid_n + real[:, 1]
    assert len(np.unique(flat)) == len(flat)
    assert (t[:, 1] < p.grid_n).all() and (t[:, 0] >= 0).all()
    for cl in t.reshape(-1, c, 3):
        assert (cl[:, 1] == cl[0, 1]).all()
        assert (cl[:, 2] == np.arange(c)).all()
        assert (cl[:, 0] == cl[0, 0] + np.arange(c)).all()
        assert cl[0, 0] % c == 0
    return len(t) - len(real)


@pytest.mark.parametrize("M", [2048, 1500, 513, 4])
def test_the_cta_map_covers_every_tile_once(M):
    """``ops.matmul_cta_tiles``, the kernel's CTA -> (mb, nb, rank) map,
    at every tile below 64 rows and every cluster, on grids whose last
    group of row blocks is short and whose clusters reach past M, and at
    the plan's own choice for tiles of 64 rows and more and for splits
    (a split or a direct tile refuses a cluster above 1)."""
    n_past = n_swapped = 0
    for N, bk in itertools.product((4096, 1032, 128), (1024, 96)):
        for bm, bn in itertools.product((8, 16, 32), (128, 256, 512)):
            own = ops.matmul_launch_plan(M, N, 4096, (bm, bn, bk), 132)
            if own is None:
                continue
            _cover(own)
            if own.variant != "tma_wgmma":
                with pytest.raises(ValueError):
                    ops.matmul_launch_plan(M, N, 4096, (bm, bn, bk), 132,
                                           cluster=2)
                continue
            for c in ops.MM_CLUSTERS:
                p = ops.matmul_launch_plan(M, N, 4096, (bm, bn, bk), 132,
                                           cluster=c)
                assert p.cluster == c and p.group_m % c == 0
                n_past += _cover(p)
                n_swapped += 1
        for t in [(64, 128, 512), (128, 256, 1024), (256, 128, 4096)]:
            p = ops.matmul_launch_plan(M, N, 4096, t, 132)
            if p is not None:
                _cover(p)
                if p.rows >= ops.MM_SWAP_ROWS:
                    assert p.cluster == 1
                    with pytest.raises(ValueError):
                        ops.matmul_launch_plan(M, N, 4096, t, 132, cluster=2)
    assert n_swapped > 0
    assert (n_past > 0) == (M in (1500, 513, 4))   # clusters past M


@pytest.mark.parametrize("N,K,cluster", [
    (4096, 4096, 1), (12288, 4096, 1), (1024, 4096, 1), (4096, 12288, 2),
    (4608, 18432, 2), (4096, 8192, 2), (4096, 6143, 1), (4096, 6144, 2),
    (5120, 8192, 2)])
def test_the_plan_shares_w_at_long_k_alone(N, K, cluster):
    """PPO's tile (32, 128, 1024) at M = 2048: three CTAs an SM on a grid
    of three waves of three or more (two on Qwen3-8B's k/v), and a
    cluster of ``MM_CLUSTER`` from K = ``MM_CLUSTER_MIN_K`` on."""
    p = ops.matmul_launch_plan(2048, N, K, (32, 128, 1024), 132)
    assert p.swapped and p.variant == "tma_wgmma"
    assert p.occupancy == (2 if N == 1024 else 3)
    assert p.cluster == cluster and p.group_m == 64


@pytest.mark.parametrize("K", [4096, 12288, 18432])
def test_a_k_major_w_takes_no_cluster(K):
    """The ``head.T`` view (``w_kmajor``) runs every plan with a cluster
    of 1 and refuses a larger one; the rest of its plan is the row-major
    w's at a cluster of 1."""
    t = (32, 128, 1024)
    kmaj = ops.matmul_launch_plan(2048, 4096, K, t, 132, w_kmajor=True)
    row = ops.matmul_launch_plan(2048, 4096, K, t, 132, cluster=1)
    assert kmaj == row and kmaj.cluster == 1 and kmaj.swapped
    with pytest.raises(ValueError):
        ops.matmul_launch_plan(2048, 4096, K, t, 132, cluster=2,
                               w_kmajor=True)
    for c in (4, 8):
        with pytest.raises(ValueError):
            ops.matmul_launch_plan(2048, 4096, K, t, 132, cluster=c)


def test_the_cta_map_at_one_cta_a_cluster_groups_row_blocks():
    """With a cluster of 1 the map is the first redesign's grouping: row
    blocks grouped ``group_m`` at a time along M, row blocks fastest."""
    for M, N, t in [(2048, 4096, (128, 128, 512)), (1990, 1024,
                                                    (32, 128, 512)),
                    (1500, 1024, (64, 128, 512))]:
        p = ops.matmul_launch_plan(M, N, 4096, t, 132, cluster=1)
        want = []
        for tile in range(p.grid_m * p.grid_n):
            group = p.group_m * p.grid_n
            first = (tile // group) * p.group_m
            gm = min(p.grid_m - first, p.group_m)
            local = tile % group
            want.append((first + local % gm, local // gm, 0))
        assert ops.matmul_cta_tiles(p).tolist() == [list(w) for w in want]


def test_the_source_compiles_each_layouts_tiles():
    """``csrc/matmul.cu`` compiles a swapped kernel for every CTA tile
    below 64 rows and occupancy a legal tile's plan yields, and a direct
    one for every tile of 64 rows and more."""
    src = (Path(ops.__file__).resolve().parent.parent / "csrc" /
           "matmul.cu").read_text()

    def cases(macro):
        return {tuple(int(v) for v in m if v) for m in re.findall(
            rf"^\s*{macro}\((\d+), (\d+)(?:, (\d+))?\)", src, re.M)}
    swap = {c[:3] for c in cases("REPRO_SWAP_CASE")}
    direct = {c[:2] for c in cases("REPRO_TMA_CASE")}
    want = set()
    for M, N in [(2048, 4096), (2048, 12288), (4, 151936), (48, 160),
                 (4, 1024)]:
        for t in ACTION_TILES:
            plan = ops.matmul_launch_plan(M, N, 4096, t, 132)
            if plan is not None and plan.variant != "unaligned":
                want.add((plan.rows, plan.cols, plan.occupancy))
    assert swap == {c for c in want if c[0] < ops.MM_SWAP_ROWS}
    assert direct == {c[:2] for c in want if c[0] >= ops.MM_SWAP_ROWS}


def test_operand_bytes_count_a_w_slab_once_a_cluster():
    """``chip_smoke.k1_operand_bytes``: each CTA's x boxes, and one w slab
    a cluster for every 64-deep step, by hand at PPO's tile on the q/o
    projection (64 steps, 64 x 32 CTAs in clusters of 2)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    p = ops.matmul_launch_plan(2048, 4096, 4096, (32, 128, 1024), 132,
                               cluster=2)
    assert cs.k1_operand_bytes(p, 4096) == \
        64 * (2048 * 32 + 1024 * 128) * 128
    p1 = p._replace(cluster=1)
    assert cs.k1_operand_bytes(p1, 4096) == 64 * 2048 * (32 + 128) * 128
