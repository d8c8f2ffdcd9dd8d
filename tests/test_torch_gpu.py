"""The port's CUDA kernels on the card, against their plain versions.

Every test here launches a kernel and skips without a CUDA card: the
kernels have no interpret mode.  The file imports neither JAX nor the JAX
package, so it runs where only PyTorch is installed:

  PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are for bf16: K1 within 3e-2 relative of the f32 product (bf16
output rounding over f32 accumulation, as ``tests/test_kernels.py``); K2
within 2e-2 absolute of its plain version (bf16 output and bf16-rounded
probabilities in both, |out| < ~1); K3 within 3e-2 of its plain version
relative to the largest output (the scores, the state and B·decay enter
the tensor cores rounded to bf16, 2^-9 each, and the output is bf16).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.extractor import extract_serve_sites
from repro_torch.core.vectorizer import baseline_program, inject
from repro_torch.kernels import chunk_scan as kcs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops
from repro_torch.models.lm import build_model

pytestmark = pytest.mark.gpu

K1_REL_TOL = 3e-2
K2_ABS_TOL = 2e-2
K3_REL_TOL = 3e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(seed, *shape, device):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(device).bfloat16()


def _rel_err(y, want):
    return float((y.float() - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("shape,tiles", [
    ((2048, 4096, 4096), (128, 128, 512)),
    ((4, 1024, 4096), (8, 256, 1024)),
    ((513, 129, 257), (64, 512, 128)),
    ((100, 300, 200), (256, 128, 4096)),
    ((37, 520, 136), (16, 128, 128)),
])
def test_matmul_kernel_matches_f32_product(cuda, shape, tiles):
    M, N, K = shape
    x, w = _normal(1, M, K, device=cuda), _normal(2, K, N, device=cuda)
    before = kmm.launches
    y = ops.matmul(x, w, tiles=tiles)
    torch.cuda.synchronize()
    assert kmm.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    assert _rel_err(y, x.float() @ w.float()) < K1_REL_TOL


def test_matmul_reads_a_transposed_weight_in_place(cuda):
    """lm_head passes head.T, a strided view."""
    x = _normal(3, 4, 4096, device=cuda)
    head = _normal(4, 1000, 4096, device=cuda)
    y = ops.matmul(x, head.T, tiles=(8, 128, 512))
    assert _rel_err(y, x.float() @ head.float().T) < K1_REL_TOL


def test_every_legal_tile_gives_the_same_function(cuda):
    """Every legal tile computes the f32 product rounded once to bf16.
    Tiles that run without a split walk K in the same order into one f32
    accumulator, so they agree bitwise; a split over bk sums the runs of K
    in another order (the partials are added in order of k, but where K is
    cut depends on bk and the grid), so across variants the tiles agree
    within K1_REL_TOL of the baseline tile."""
    x, w = _normal(5, 2048, 640, device=cuda), _normal(6, 640, 1024,
                                                       device=cuda)
    y0 = ops.matmul(x, w, tiles=(128, 128, 512)).float()
    unsplit = []
    for t in [(8, 128, 128), (32, 256, 256), (64, 512, 1024),
              (256, 128, 4096), (16, 512, 2048), (64, 512, 128)]:
        before = dict(kmm.launches_by_variant)
        y = ops.matmul(x, w, tiles=t)
        assert _rel_err(y, y0) < K1_REL_TOL, t
        if kmm.launches_by_variant["tma_wgmma"] == before["tma_wgmma"] + 1:
            unsplit.append((t, y))
    assert 3 <= len(unsplit) < 6       # (64, 512, 128) splits K in two
    for t, y in unsplit[1:]:
        assert torch.equal(y, unsplit[0][1]), t


_W_ROW, _W_T = "w(K,N)", "head.T"


@pytest.mark.parametrize("shape,tiles,layout,variant", [
    ((2048, 4096, 4096), (128, 128, 512), _W_ROW, "tma_wgmma"),
    ((2048, 4096, 4096), (32, 128, 1024), _W_ROW, "tma_wgmma"),
    ((4, 4096, 12288), (16, 512, 1024), _W_ROW, "split_k"),
    ((4, 4096, 12288), (8, 128, 512), _W_ROW, "split_k"),
    ((4, 4096, 12288), (16, 256, 4096), _W_ROW, "split_k"),
    ((4, 4096, 12288), (8, 512, 128), _W_ROW, "split_k"),
    ((4, 4096, 4096), (8, 128, 96), _W_ROW, "tma_wgmma"),
    ((4, 4096, 4096), (8, 128, 192), _W_ROW, "tma_wgmma"),
    ((4, 4096, 4096), (8, 128, 384), _W_ROW, "split_k"),
    ((4, 151936, 4096), (8, 128, 512), _W_T, "tma_wgmma"),
    ((4, 1000, 4096), (8, 256, 1024), _W_T, "split_k"),
    ((513, 1032, 200), (16, 128, 128), _W_ROW, "tma_wgmma"),
    ((1990, 1024, 640), (128, 128, 512), _W_ROW, "tma_wgmma"),
    ((1500, 1024, 4096), (32, 128, 512), _W_ROW, "tma_wgmma"),
    ((513, 136, 200), (64, 128, 128), _W_ROW, "split_k"),
    ((513, 129, 257), (64, 512, 128), _W_ROW, "unaligned"),
])
def test_matmul_variant_matches_f32_product(cuda, shape, tiles, layout,
                                            variant):
    """Each variant at the shapes that pick it: aligned prefill, the split
    over bk at decode with several bk (a bk that is no multiple of the
    128-deep stage does not split), lm_head's transposed view, a K that is
    no multiple of 64, a ragged M, a grid whose last group of row blocks
    is short (47 row blocks in groups of 32), and a ragged shape whose row
    pitch TMA cannot take."""
    M, N, K = shape
    x = _normal(7, M, K, device=cuda)
    if layout == _W_T:
        head = _normal(8, N, K, device=cuda)
        w, want = head.T, x.float() @ head.float().T
    else:
        w = _normal(8, K, N, device=cuda)
        want = x.float() @ w.float()
    before = dict(kmm.launches_by_variant)
    y = ops.matmul(x, w, tiles=tiles)
    torch.cuda.synchronize()
    ran = {v: kmm.launches_by_variant[v] - before[v] for v in kmm.VARIANTS}
    assert ran == {v: int(v == variant) for v in kmm.VARIANTS}
    assert y.shape == (M, N) and torch.isfinite(y.float()).all()
    assert _rel_err(y, want) < K1_REL_TOL


def _k1_operands(M, N, K, layout, device, seed=20):
    x = _normal(seed, M, K, device=device)
    if layout == _W_T:
        head = _normal(seed + 1, N, K, device=device)
        return x, head.T, x.float() @ head.float().T
    w = _normal(seed + 1, K, N, device=device)
    return x, w, x.float() @ w.float()


def _ran(fn):
    """``fn()``'s output and K1's launches by variant and layout in it."""
    bv, bl = dict(kmm.launches_by_variant), dict(kmm.launches_by_layout)
    y = fn()
    torch.cuda.synchronize()
    return y, ({v: kmm.launches_by_variant[v] - bv[v] for v in kmm.VARIANTS},
               {v: kmm.launches_by_layout[v] - bl[v] for v in kmm.LAYOUTS})


@pytest.mark.parametrize("layout", [_W_ROW, _W_T])
@pytest.mark.parametrize("tiles", [(8, 128, 1024), (16, 128, 512),
                                   (16, 256, 1024), (8, 512, 256),
                                   (32, 128, 1024), (32, 256, 128),
                                   (32, 512, 4096)])
@pytest.mark.parametrize("shape", [(2048, 4096, 1024), (1500, 1032, 640),
                                   (513, 1032, 200)])
def test_matmul_small_row_tiles_run_swapped_and_multicast(cuda, shape, tiles,
                                                          layout):
    """CTA tiles of 16 and 32 rows at 128, 256 and 512 columns, w
    row-major and head.T: one swapped tma_wgmma launch under the plan,
    within K1_REL_TOL of the f32 product and of the plain version, and
    with a row-major w the same bits in clusters of 2 (the launch's
    argument: at M = 1500 and 513 the last cluster of a column block
    reaches past M; N = 1032 leaves an 8-column block); head.T refuses a
    cluster."""
    M, N, K = shape
    x, w, want = _k1_operands(M, N, K, layout, cuda)
    plan = ops.matmul_launch_plan(M, N, K, tiles, kmm._sm_count(x.device))
    assert plan.swapped and plan.cluster == 1
    y, (variants, layouts) = _ran(lambda: ops.matmul(x, w, tiles=tiles))
    assert variants == {v: int(v == "tma_wgmma") for v in kmm.VARIANTS}
    assert layouts == {"swapped": 1, "direct": 0}
    assert y.shape == (M, N) and torch.isfinite(y.float()).all()
    assert _rel_err(y, want) < K1_REL_TOL
    assert _rel_err(y, kmm.matmul_plain(x, w).float()) < K1_REL_TOL
    if layout == _W_T:
        with pytest.raises(ValueError):
            kmm.matmul_cuda(x, w, *tiles, cluster=2)
        return
    y2, (variants, layouts) = _ran(
        lambda: kmm.matmul_cuda(x, w, *tiles, cluster=2))
    assert layouts == {"swapped": 1, "direct": 0}
    assert torch.equal(y2, y)


@pytest.mark.parametrize("layout", [_W_ROW, _W_T])
@pytest.mark.parametrize("shape,tiles", [((1500, 1032, 640), (16, 128, 512)),
                                         ((513, 4096, 1024), (32, 512, 256)),
                                         ((2048, 1024, 200), (8, 256, 128))])
def test_matmul_every_cluster_gives_the_same_bits(cuda, shape, tiles,
                                                  layout):
    """A swapped tile at clusters of 1 and 2 CTAs (the launch's
    argument; head.T at 1 alone) sums K in the same order: the same bits,
    the plan's own choice too, and the bits of the tiles of 64 rows and
    more."""
    M, N, K = shape
    x, w, want = _k1_operands(M, N, K, layout, cuda, seed=24)
    ys = [kmm.matmul_cuda(x, w, *tiles, cluster=c)
          for c in ((1,) if layout == _W_T else ops.MM_CLUSTERS)]
    ys.append(ops.matmul(x, w, tiles=tiles))
    ys.append(ops.matmul(x, w, tiles=(128, 128, 512)))
    torch.cuda.synchronize()
    assert _rel_err(ys[0], want) < K1_REL_TOL
    for y in ys[1:]:
        assert torch.equal(y, ys[0])


@pytest.mark.parametrize("layout", [_W_ROW, _W_T])
@pytest.mark.parametrize("shape", [(2048, 4096, 8192), (1500, 4104, 8200)])
def test_matmul_long_k_runs_in_clusters(cuda, shape, layout):
    """PPO's tile at a long K runs three CTAs an SM in clusters of 2 (the
    plan's; head.T in none), within K1_REL_TOL of the f32 product, with
    the bits of a cluster of 1 and of the tile of 128 rows."""
    M, N, K = shape
    x, w, want = _k1_operands(M, N, K, layout, cuda, seed=32)
    plan = ops.matmul_launch_plan(M, N, K, (32, 128, 1024),
                                  kmm._sm_count(x.device),
                                  w_kmajor=layout == _W_T)
    assert K >= ops.MM_CLUSTER_MIN_K
    assert (plan.occupancy, plan.cluster) == (
        3, 1 if layout == _W_T else ops.MM_CLUSTER)
    y, (variants, layouts) = _ran(
        lambda: ops.matmul(x, w, tiles=(32, 128, 1024)))
    assert variants == {v: int(v == "tma_wgmma") for v in kmm.VARIANTS}
    assert layouts == {"swapped": 1, "direct": 0}
    assert _rel_err(y, want) < K1_REL_TOL
    assert torch.equal(y, kmm.matmul_cuda(x, w, 32, 128, 1024, cluster=1))
    assert torch.equal(y, ops.matmul(x, w, tiles=(128, 128, 512)))


@pytest.mark.parametrize("layout", [_W_ROW, _W_T])
@pytest.mark.parametrize("tiles", [(8, 128, 512), (16, 512, 1024),
                                   (16, 256, 4096)])
def test_matmul_split_k_at_decode_runs_swapped(cuda, tiles, layout):
    """At M = 4 the split over bk runs the swapped layout without a
    cluster, within K1_REL_TOL of the f32 product and the plain
    version."""
    M, N, K = 4, 4096, 12288
    x, w, want = _k1_operands(M, N, K, layout, cuda, seed=26)
    plan = ops.matmul_launch_plan(M, N, K, tiles, kmm._sm_count(x.device))
    assert plan.variant == "split_k" and plan.cluster == 1
    y, (variants, layouts) = _ran(lambda: ops.matmul(x, w, tiles=tiles))
    assert variants == {v: int(v == "split_k") for v in kmm.VARIANTS}
    assert layouts == {"swapped": 1, "direct": 0}
    assert _rel_err(y, want) < K1_REL_TOL
    assert _rel_err(y, kmm.matmul_plain(x, w).float()) < K1_REL_TOL


def test_matmul_clusters_on_two_streams_at_once(cuda):
    """Swapped calls in clusters, and split ones at decode, queued on two
    streams without a sync between them give the bits of calls on one
    stream."""
    x, w, _ = _k1_operands(1500, 1032, 640, _W_ROW, cuda, seed=28)
    xd, wd, _ = _k1_operands(4, 4096, 4096, _W_ROW, cuda, seed=30)
    want = ops.matmul(x, w, tiles=(16, 128, 512))
    want_d = ops.matmul(xd, wd, tiles=(8, 128, 512))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    ys, yds = [], []
    for _ in range(8):
        for st in streams:
            with torch.cuda.stream(st):
                ys.append(ops.matmul(x, w, tiles=(16, 128, 512)))
                yds.append(ops.matmul(xd, wd, tiles=(8, 128, 512)))
    torch.cuda.synchronize()
    assert all(torch.equal(y, want) for y in ys)
    assert all(torch.equal(y, want_d) for y in yds)


def test_matmul_unaligned_x_view_takes_the_unaligned_variant(cuda):
    """x that starts 2 bytes into its storage: TMA needs 16-byte aligned
    operands, so the in-kernel path without TMA runs it."""
    base = _normal(9, 64, 1025, device=cuda)
    x = base[:, 1:]
    w = _normal(10, 1024, 384, device=cuda)
    before = dict(kmm.launches_by_variant)
    y = ops.matmul(x, w, tiles=(32, 128, 256))
    torch.cuda.synchronize()
    assert kmm.launches_by_variant["unaligned"] == before["unaligned"] + 1
    assert _rel_err(y, x.float() @ w.float()) < K1_REL_TOL


def test_matmul_split_counters_reset_between_calls(cuda):
    """The split variant's per-tile counters put themselves back to zero:
    repeated calls give the same bits."""
    x, w = _normal(11, 4, 4096, device=cuda), _normal(12, 4096, 4096,
                                                      device=cuda)
    ys = [ops.matmul(x, w, tiles=(8, 128, 512)) for _ in range(3)]
    assert all(torch.equal(y, ys[0]) for y in ys[1:])
    assert _rel_err(ys[0], x.float() @ w.float()) < K1_REL_TOL


def test_matmul_split_calls_on_two_streams_at_once(cuda):
    """Each stream has its own split counters: split calls queued on two
    streams without a sync between them give the same bits as calls on
    one stream."""
    x, w = _normal(13, 4, 4096, device=cuda), _normal(14, 4096, 4096,
                                                      device=cuda)
    want = ops.matmul(x, w, tiles=(8, 128, 512))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    ys = []
    for _ in range(8):
        for st in streams:
            with torch.cuda.stream(st):
                ys.append(ops.matmul(x, w, tiles=(8, 128, 512)))
    torch.cuda.synchronize()
    assert all(torch.equal(y, want) for y in ys)


def test_illegal_tiles_raise(cuda):
    x = torch.zeros((2048, 512), dtype=torch.bfloat16, device=cuda)
    before = kmm.launches
    with pytest.raises(kmm.TileError):
        ops.matmul(x, x.T, tiles=(256, 256, 128))
    q = torch.zeros((1, 4, 512, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(kmm.TileError):
        ops.flash_attention(q, q, q, causal=True, scale=0.1,
                            tiles=(256, 512))
    assert kmm.launches == before


def test_kernels_refuse_float32(cuda):
    """K2 and K3 take bf16 only, and K1 one dtype for both operands (K1
    in f32 is its own variant, tested below)."""
    x = torch.zeros((16, 128), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.matmul(x, x.T.bfloat16())
    q = torch.zeros((1, 2, 128, 128), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.flash_attention(q, q, q, causal=True, scale=0.1)


_CONTIG, _MODEL = "contiguous", "model"


def _attention_inputs(B, hq, hkv, sq, skv, layout, device, seed=5, d=128):
    """q, k, v; under the model's layout q and k are contiguous and v is
    the transposed view of its projection (``models/attention.py``)."""
    q = _normal(seed, B, hq, sq, d, device=device)
    k = _normal(seed + 1, B, hkv, skv, d, device=device)
    if layout == _MODEL:
        v = _normal(seed + 2, B, skv, hkv, d, device=device).transpose(1, 2)
    else:
        v = _normal(seed + 2, B, hkv, skv, d, device=device)
    return q, k, v


def _flash_variant_ran(fn):
    before = dict(kfa.launches_by_variant)
    y = fn()
    torch.cuda.synchronize()
    return y, {v: kfa.launches_by_variant[v] - before[v]
               for v in kfa.VARIANTS}


@pytest.mark.parametrize("B,hq,hkv,sq,skv,tiles,causal,layout", [
    (2, 8, 2, 512, 512, (64, 128), True, _CONTIG),
    (2, 8, 2, 512, 512, (128, 512), True, _CONTIG),
    (2, 8, 2, 512, 512, (128, 256), False, _CONTIG),
    (2, 8, 2, 256, 512, (128, 128), True, _CONTIG),
    (2, 8, 2, 128, 512, (64, 512), True, _CONTIG),
    (2, 32, 8, 512, 512, (128, 128), True, _MODEL),    # the served layout
    (2, 32, 8, 512, 512, (128, 512), True, _MODEL),
    (1, 128, 128, 512, 512, (128, 512), True, _CONTIG),  # the runner
    (2, 4, 2, 16, 16, (64, 128), True, _CONTIG),       # 16 of 64 rows
    (2, 4, 2, 256, 128, (128, 128), True, _CONTIG),    # rows see no key
    (2, 4, 1, 192, 384, (64, 128), False, _MODEL),     # non-causal, 1 WG
    (1, 4, 2, 96, 200, (128, 256), True, _CONTIG),     # ragged stage
    (4, 16, 4, 256, 256, (64, 64), True, _MODEL),      # 64-key stages
])
def test_flash_kernel_matches_plain(cuda, B, hq, hkv, sq, skv, tiles,
                                    causal, layout):
    """K2's tma_wgmma variant against its plain version: the model's and
    the runner's layouts, a 64-row warpgroup holding 16 rows, Sq > Skv
    (rows that see no key give the mean of V), non-causal calls, a last
    stage past Skv, 64-key stages, and more tiles than the card has SMs
    (each persistent CTA walks several, its ring running on)."""
    q, k, v = _attention_inputs(B, hq, hkv, sq, skv, layout, cuda)
    before = kfa.launches
    y, ran = _flash_variant_ran(lambda: ops.flash_attention(
        q, k, v, causal=causal, scale=128 ** -0.5, tiles=tiles))
    assert kfa.launches == before + 1
    assert ran == {"tma_wgmma": 1, "unaligned": 0}
    yp = kfa.flash_attention_plain(q, k, v, causal=causal,
                                   scale=128 ** -0.5, bq=tiles[0],
                                   bkv=tiles[1])
    assert y.shape == (B, hq, sq, 128) and torch.isfinite(y.float()).all()
    assert float((y.float() - yp.float()).abs().max()) < K2_ABS_TOL
    if sq > skv and causal:
        mean = v.float().mean(2, keepdim=True).repeat_interleave(
            hq // hkv, 1)
        assert float((y[:, :, :sq - skv].float() - mean).abs().max()) \
            < K2_ABS_TOL


def test_flash_kernel_probabilities_keep_their_places(cuda):
    """V is the identity on the first 128 keys, so the output is P itself
    (P summed over the keys k and k + 128): a permutation of the score
    accumulator on its way to the register operand of P.V would show.
    Scores spread over about +-10 so that P is far from uniform."""
    q = _normal(20, 1, 2, 128, 128, device=cuda) * 0.3
    k = _normal(21, 1, 2, 256, 128, device=cuda)
    v = torch.eye(128, device=cuda).repeat(2, 1).bfloat16()[None, None]
    v = v.expand(1, 2, 256, 128).contiguous()
    y, ran = _flash_variant_ran(lambda: ops.flash_attention(
        q, k, v, causal=False, scale=1.0, tiles=(128, 128)))
    assert ran == {"tma_wgmma": 1, "unaligned": 0}
    p = torch.softmax(q.float() @ k.float().transpose(-1, -2), -1)
    want = p[..., :128] + p[..., 128:]
    assert float(want.max()) > 0.3          # peaked rows
    assert float((y.float() - want).abs().max()) < K2_ABS_TOL


def test_flash_unaligned_operand_takes_the_unaligned_variant(cuda):
    """q that starts 2 bytes into its storage, with a row pitch of 129
    elements: TMA cannot take it, so the first kernel's loop runs it."""
    base = _normal(22, 1, 4, 256, 129, device=cuda)
    q = base[..., 1:]
    k = _normal(23, 1, 2, 256, 128, device=cuda)
    v = _normal(24, 1, 2, 256, 128, device=cuda)
    y, ran = _flash_variant_ran(lambda: ops.flash_attention(
        q, k, v, causal=True, scale=128 ** -0.5, tiles=(64, 128)))
    assert ran == {"tma_wgmma": 0, "unaligned": 1}
    yp = kfa.flash_attention_plain(q, k, v, causal=True, scale=128 ** -0.5,
                                   bq=64, bkv=128)
    assert float((y.float() - yp.float()).abs().max()) < K2_ABS_TOL


def test_flash_library_holds_wgmma_and_tma_without_spills(cuda):
    """libflash_attention's SASS holds Hopper's wgmma (HGMMA) and TMA load
    (UTMALDG) instructions, and ptxas spilled no register."""
    import os
    import shutil
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import build
    build.load("flash_attention")
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" /
        "cuobjdump")
    sass = subprocess.run([tool, "-sass",
                           str(build._lib_path("flash_attention"))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    assert "HGMMA" in sass and "UTMALDG" in sass
    spills = [ln for ln in build.build_log("flash_attention").splitlines()
              if "spill" in ln]
    assert spills and all("0 bytes spill stores, 0 bytes spill loads" in ln
                          for ln in spills), spills


def test_flash_kernel_refuses_other_head_dims(cuda):
    """K2 takes head dims that are multiples of 8 up to 192 (the launch
    rule, ``ops.head_dim_ok``); others raise before any launch."""
    before = kfa.launches
    for d in (20, 200, 256):
        q = torch.zeros((1, 2, 64, d), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_attention(q, q, q, causal=True, scale=0.1)
    assert kfa.launches == before


def _flash_into_canary(q, k, v, causal, tiles):
    """K2 through its C entry point into an output buffer followed by a
    canary: the output's rows are Dv apart, so a column at or past Dv
    written by the last row lands on the canary.  Returns the output and
    the canary."""
    B, H, Sq, D = q.shape
    Dv = v.shape[-1]
    n = B * H * Sq * Dv
    buf = torch.full((n + 1024,), 7.0, dtype=torch.bfloat16, device=q.device)
    variant, fn, args = kfa._prepare(q, k, v, causal, *tiles)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(), *args,
            float(D ** -0.5), torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    return variant, buf[:n].view(B, H, Sq, Dv), buf[n:]


@pytest.mark.parametrize("d", [80, 64, 96, 40, 16])
@pytest.mark.parametrize("B,hq,hkv,sq,skv,tiles,causal,layout", [
    (2, 8, 8, 512, 512, (128, 512), True, _MODEL),     # StableLM's layout
    (2, 8, 2, 512, 512, (128, 128), True, _CONTIG),    # GQA
    (2, 4, 2, 256, 512, (64, 256), True, _CONTIG),     # Sq < Skv
    (1, 4, 2, 96, 200, (128, 256), False, _CONTIG),    # ragged, not causal
    (2, 4, 4, 256, 256, (64, 64), True, _MODEL),       # 64-key stages
])
def test_flash_kernel_matches_plain_at_head_dims(cuda, d, B, hq, hkv, sq,
                                                 skv, tiles, causal,
                                                 layout):
    """K2 at head dims below 128 (two 64-column slabs, the columns past D
    zero-filled by TMA; at D <= 64 the second slab wholly) against its
    plain version at the true D, with the scale 1/sqrt(D); nothing is
    written at or past column D."""
    q, k, v = _attention_inputs(B, hq, hkv, sq, skv, layout, cuda, seed=30,
                                d=d)
    y, ran = _flash_variant_ran(lambda: ops.flash_attention(
        q, k, v, causal=causal, scale=d ** -0.5, tiles=tiles))
    assert ran == {"tma_wgmma": 1, "unaligned": 0}
    yp = kfa.flash_attention_plain(q, k, v, causal=causal, scale=d ** -0.5,
                                   bq=tiles[0], bkv=tiles[1])
    assert y.shape == (B, hq, sq, d) and torch.isfinite(y.float()).all()
    assert float((y.float() - yp.float()).abs().max()) < K2_ABS_TOL
    variant, yc, canary = _flash_into_canary(q, k, v, causal, tiles)
    assert variant == "tma_wgmma" and torch.equal(yc, y)
    assert bool((canary == 7.0).all())


@pytest.mark.parametrize("d", [80, 64, 96, 40, 16])
def test_flash_unaligned_variant_at_head_dims(cuda, d):
    """The unaligned variant (q 2 bytes into its storage, rows D + 1
    apart) at head dims below 128 masks its loads and stores by hand."""
    q = _normal(40, 1, 4, 256, d + 1, device=cuda)[..., 1:]
    k = _normal(41, 1, 2, 256, d, device=cuda)
    v = _normal(42, 1, 2, 256, d, device=cuda)
    y, ran = _flash_variant_ran(lambda: ops.flash_attention(
        q, k, v, causal=True, scale=d ** -0.5, tiles=(64, 128)))
    assert ran == {"tma_wgmma": 0, "unaligned": 1}
    yp = kfa.flash_attention_plain(q, k, v, causal=True, scale=d ** -0.5,
                                   bq=64, bkv=128)
    assert float((y.float() - yp.float()).abs().max()) < K2_ABS_TOL
    variant, yc, canary = _flash_into_canary(q, k, v, True, (64, 128))
    assert variant == "unaligned" and torch.equal(yc, y)
    assert bool((canary == 7.0).all())


def test_stablelm_under_inject_matches_eager_on_the_card(cuda):
    """A 2-layer bf16 stablelm_3b at its head dim 80 (LayerNorm, MHA):
    every matmul and the prefill attention go through the kernels, and the
    logits stay within 5e-2 of eager mode's, relative to their largest
    value."""
    cfg = get_config("stablelm_3b").reduced(
        n_layers=2, d_model=640, n_heads=8, n_kv_heads=8, head_dim=80,
        d_ff=1024, vocab_size=1000, dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda)
    tok = torch.randint(0, 1000, (2, 128),
                        generator=torch.Generator().manual_seed(0)).to(cuda)
    prog = baseline_program(extract_serve_sites(model, 2, 128, 1))
    with torch.inference_mode():
        le, _ = model.prefill(params, {"tokens": tok},
                              model.make_cache(2, 129, device=cuda))
        before = (kmm.launches, kfa.launches)
        with inject(prog):
            lk, _ = model.prefill(params, {"tokens": tok},
                                  model.make_cache(2, 129, device=cuda))
        torch.cuda.synchronize()
    assert (kmm.launches - before[0], kfa.launches - before[1]) == (15, 2)
    assert float((lk - le).abs().max() / le.abs().max()) < 5e-2


def test_model_under_inject_matches_eager_on_the_card(cuda):
    """A 2-layer bf16 qwen3_8b at head dim 128: every matmul and the
    prefill attention go through the kernels, and the logits stay within
    5e-2 of eager mode's, relative to their largest value (bf16
    activations, two summation orders)."""
    cfg = get_config("qwen3_8b").reduced(
        n_layers=2, d_model=512, n_heads=4, n_kv_heads=2, head_dim=128,
        d_ff=1024, vocab_size=1000, dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda)
    tok = torch.randint(0, 1000, (2, 128),
                        generator=torch.Generator().manual_seed(0)).to(cuda)
    prog = baseline_program(extract_serve_sites(model, 2, 128, 1))
    with torch.inference_mode():
        le, _ = model.prefill(params, {"tokens": tok},
                              model.make_cache(2, 129, device=cuda))
        before = (kmm.launches, kfa.launches)
        with inject(prog):
            lk, _ = model.prefill(params, {"tokens": tok},
                                  model.make_cache(2, 129, device=cuda))
        torch.cuda.synchronize()
    assert (kmm.launches - before[0], kfa.launches - before[1]) == (15, 2)
    assert float((lk - le).abs().max() / le.abs().max()) < 5e-2


def test_serve_refuses_the_reduced_f32_config_under_inject(cuda):
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="--full"):
        serve.main(["--autotune", "ppo", "--autotune-steps", "64",
                    "--inject"])


def _scan_inputs(G, S, P, N, device, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh, dtype=np.float32)
    x = torch.from_numpy(f(G, S, P)).to(device).bfloat16()
    Bm = torch.from_numpy(f(G, S, N) * 0.3).to(device).bfloat16()
    Cm = torch.from_numpy(f(G, S, N) * 0.3).to(device).bfloat16()
    la = -torch.nn.functional.softplus(torch.from_numpy(f(G, S))).to(device)
    return x, Bm, Cm, la.bfloat16()


@pytest.mark.parametrize("G,S,P,N,Q", [
    (1, 8192, 1024, 1024, 256),      # the xLSTM serve site at the runner
    (1, 2048, 1024, 1024, 1024),     # the largest chunk
    (1, 4096, 64, 16, 256),          # a Mamba-2 head
    (3, 384, 40, 24, 128),           # ragged P, N not a multiple of 16
    (2, 200, 32, 16, 40),            # a chunk that is no multiple of 16
    (1, 65536, 64, 16, 256),         # a Mamba-2 head: 256 chunks
    (1, 8192, 1024, 1024, 64),       # the xLSTM site at the smallest chunk
    (2, 256, 7, 16, 64),             # P % 8 != 0: x padded, y sliced
    (1, 640, 200, 136, 320),         # P and N past a tile, not a power of 2
    (1, 1024, 128, 64, 256),         # 128-column P tiles
    (4, 32768, 64, 16, 256),         # 512 chunks: a CTA runs a whole chunk
])
def test_chunk_scan_kernel_matches_plain(cuda, G, S, P, N, Q):
    x, Bm, Cm, la = _scan_inputs(G, S, P, N, cuda)
    before = kcs.launches
    y = ops.chunk_scan(x, Bm, Cm, la, chunk=Q)
    torch.cuda.synchronize()
    assert kcs.launches == before + 1
    want = kcs.chunk_scan_plain(x, Bm, Cm, la, chunk=Q).float()
    assert y.dtype == torch.bfloat16 and torch.isfinite(y).all()
    assert _rel_err(y, want) < K3_REL_TOL


def test_chunk_scan_kernel_matches_the_sequential_oracle(cuda):
    from repro_torch.kernels import ref
    x, Bm, Cm, la = _scan_inputs(2, 256, 48, 32, cuda, seed=1)
    want = ref.chunk_scan_ref(x.float(), Bm.float(), Cm.float(), la.float())
    for Q in (64, 128, 256):
        y = ops.chunk_scan(x, Bm, Cm, la, chunk=Q)
        assert _rel_err(y, want) < K3_REL_TOL


def test_chunk_scan_refuses(cuda):
    x, Bm, Cm, la = _scan_inputs(1, 4096, 32, 16, cuda)
    with pytest.raises(kmm.TileError):
        ops.chunk_scan(x, Bm, Cm, la, chunk=2048)
    with pytest.raises(ValueError, match="divide"):
        ops.chunk_scan(x, Bm, Cm, la, chunk=384)
    with pytest.raises(TypeError):
        ops.chunk_scan(x.float(), Bm, Cm, la, chunk=256)
    for n in (12, 2048):
        x2, b2, c2, l2 = _scan_inputs(1, 512, 32, n, cuda)
        with pytest.raises(kmm.TileError):
            ops.chunk_scan(x2, b2, c2, l2, chunk=256)


@pytest.mark.parametrize("G,S,P,N,Q", [
    (1, 8192, 1024, 1024, 256),      # walk by the plan's rule
    (2, 512, 128, 64, 64),           # three_pass by the plan's rule
    (1, 640, 200, 136, 320),         # ragged tiles, Q past 4 key blocks
])
def test_chunk_scan_variants_agree(cuda, G, S, P, N, Q, monkeypatch):
    """Both variants, whichever the plan picks, launch once and hold the
    plain version's tolerance on the same inputs."""
    x, Bm, Cm, la = _scan_inputs(G, S, P, N, cuda, seed=3)
    want = kcs.chunk_scan_plain(x, Bm, Cm, la, chunk=Q).float()
    for variant in ("three_pass", "walk"):
        monkeypatch.setattr(ops, "chunk_launch_plan",
                            lambda *a, v=variant: ops._chunk_plan(
                                *a, ops.CHUNK_RING, v))
        assert ops.chunk_launch_plan(G, S, P, N, Q).variant == variant
        before = kcs.launches
        y = ops.chunk_scan(x, Bm, Cm, la, chunk=Q)
        torch.cuda.synchronize()
        assert kcs.launches == before + 1
        assert _rel_err(y, want) < K3_REL_TOL, variant


def test_chunk_static_shared_memory_is_the_plans(cuda):
    """The plan sizes chunk_out's ring by the CTAs a SM holds, which counts
    each pass's static shared memory: ptxas's figures for every
    chunk_state and chunk_out instantiation are ops' constants."""
    from repro_torch.kernels import build
    build.load("chunk_scan")
    smem = build.static_smem("chunk_scan")
    want = {"chunk_state_kernel": ops.CHUNK_STATE_STATIC,
            "chunk_out_kernel": ops.CHUNK_OUT_STATIC}
    for kernel, static in want.items():
        got = {v for k, v in smem.items() if kernel in k}
        assert got == {static}, (kernel, smem)


def test_chunk_scan_reads_la_in_its_own_dtype(cuda):
    """la in f32 and in bf16 (the runner's) both launch without a cast and
    agree with the plain version on the same values."""
    x, Bm, Cm, la = _scan_inputs(2, 512, 64, 32, cuda, seed=2)
    for la_t in (la, la.float()):
        y = ops.chunk_scan(x, Bm, Cm, la_t, chunk=128)
        want = kcs.chunk_scan_plain(x, Bm, Cm, la_t, chunk=128).float()
        assert _rel_err(y, want) < K3_REL_TOL


@pytest.mark.parametrize("G,S,P,N,Q,kernels", [
    (1, 2048, 128, 64, 256, ("chunk_state_kernel", "state_pass_kernel",
                             "chunk_out_kernel")),
    (1, 8192, 1024, 1024, 256, ("chunk_state_kernel", "chunk_out_kernel")),
])
def test_chunk_scan_runs_its_passes_as_one_launch(cuda, G, S, P, N, Q,
                                                  kernels):
    """One call counts one launch, and a profiler trace of it holds the
    kernel of each pass the plan's variant runs (three_pass: three; walk:
    the state pass inside chunk_state)."""
    from torch.profiler import ProfilerActivity, profile
    x, Bm, Cm, la = _scan_inputs(G, S, P, N, cuda)
    ops.chunk_scan(x, Bm, Cm, la, chunk=Q)
    torch.cuda.synchronize()
    before = kcs.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.chunk_scan(x, Bm, Cm, la, chunk=Q)
        torch.cuda.synchronize()
    assert kcs.launches == before + 1
    names = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    for kernel in kernels:
        assert sum(kernel in k for k in names) == 1, names
    assert len(names) == len(kernels), names


def test_chunk_scan_library_holds_wgmma_and_tma_without_spills(cuda):
    """libchunk_scan's SASS holds wgmma (HGMMA) and TMA loads (UTMALDG),
    and ptxas spilled no register."""
    import os
    import shutil
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import build
    build.load("chunk_scan")
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" /
        "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build._lib_path("chunk_scan"))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    assert "HGMMA" in sass and "UTMALDG" in sass
    spills = [ln for ln in build.build_log("chunk_scan").splitlines()
              if "spill" in ln]
    assert spills and all("0 bytes spill stores, 0 bytes spill loads" in ln
                          for ln in spills), spills


# ---------------------------------------------------------------------------
# the facade (repro_torch.api) on the card
# ---------------------------------------------------------------------------

def _facade_sites():
    """Small bf16 sites the kernels launch: two matmuls and a prefill
    attention at head dim 80."""
    from repro_torch.models.compute import KernelSite
    return [KernelSite(site="g.mm", kind="matmul", m=256, n=512, k=256),
            KernelSite(site="g.mm2", kind="matmul", m=4, n=1024, k=512),
            KernelSite(site="g.attn", kind="attention", m=256, n=80, k=256,
                       batch=8, causal=True)]


def test_facade_measured_brute_times_every_legal_pair_once(cuda, tmp_path):
    from repro_torch.api import CostModelEnv, NeuroVecConfig, NeuroVectorizer
    cfg = NeuroVecConfig()
    sites = _facade_sites()
    nv = NeuroVectorizer(cfg, agent="brute", oracle="measured",
                         db_path=str(tmp_path / "m.jsonl"),
                         oracle_kwargs={"reps": 1}, device="cuda")
    prog = nv.fit(sites).tune_sites(sites)
    st = nv.oracle.measure_fn.transport.stats()
    env = CostModelEnv(cfg, legality="h100")
    grid_pairs = int(np.isfinite(env.cost_grid(sites)).sum())
    # every legal tile of the grid, plus a baseline tile off the grid
    assert grid_pairs <= st["transport_timed_pairs_total"] <= \
        grid_pairs + len(sites)
    assert st["transport_failed_pairs_total"] == 0
    assert st["transport_coalesced_total"] == 0 and nv.health() == "ok"
    assert all(ops.tile_ok(s, prog.tiles[s.key()]) for s in sites)
    timed = st["transport_timed_pairs_total"]
    nv.tune_sites(sites)                      # every pair is known now
    assert nv.oracle.measure_fn.transport.stats()[
        "transport_timed_pairs_total"] == timed
    assert np.isfinite(nv.speedup(prog, sites))
    nv.close()


def test_facade_inject_matches_eager_on_the_card(cuda):
    from repro_torch.api import NeuroVecConfig, NeuroVectorizer
    from repro_torch.models import compute
    nv = NeuroVectorizer(NeuroVecConfig(), agent="polly", device="cuda")
    x, w = _normal(11, 256, 256, device=cuda), _normal(12, 256, 512,
                                                       device=cuda)
    q = _normal(13, 2, 4, 256, 80, device=cuda)
    k = _normal(14, 2, 4, 256, 80, device=cuda)
    v = _normal(15, 2, 4, 256, 80, device=cuda)

    def step(x, w, q, k, v):
        return (compute.matmul(x, w, site="g.mm"),
                compute.flash_attention(q, k, v, site="g.attn", causal=True))

    meta = [torch.empty_like(t, device="meta") for t in (x, w, q, k, v)]
    prog = nv.tune(step, meta)
    assert len(prog.tiles) == 2
    y_mm, y_att = step(x, w, q, k, v)
    before = (kmm.launches, kfa.launches)
    with nv.inject(prog):
        t_mm, t_att = step(x, w, q, k, v)
    torch.cuda.synchronize()
    assert (kmm.launches, kfa.launches) == (before[0] + 1, before[1] + 1)
    assert _rel_err(t_mm, x.float() @ w.float()) < K1_REL_TOL
    assert float((t_att.float() - y_att.float()).abs().max()) < K2_ABS_TOL
    nv.close()


def test_every_method_tunes_launchable_tiles_on_the_card(cuda):
    from repro_torch.api import (AGENT_NAMES, CostModelEnv, NeuroVecConfig,
                                 NeuroVectorizer, make_agent)
    from repro_torch.core import dataset
    cfg = NeuroVecConfig(train_batch=64, sgd_minibatch=32, ppo_epochs=2)
    sites = _facade_sites()
    corpus = dataset.generate(120, seed=0, base=sites)
    env = CostModelEnv(cfg, legality="h100")
    for name in AGENT_NAMES:
        agent = make_agent(name, cfg, seed=0, device="cuda")
        nv = NeuroVectorizer(cfg, agent=agent, oracle=env, device="cuda")
        nv.fit(corpus, **({"total_steps": 128} if name == "ppo" else {}))
        prog = nv.tune_sites(sites)
        bad = [s.key() for s in sites
               if not ops.tile_ok(s, prog.tiles[s.key()])]
        assert not bad, (name, bad)
        nv.close()


# ---------------------------------------------------------------------------
# the measured oracle's pool on the card: kernels timed in worker processes
# ---------------------------------------------------------------------------

POOL_SITES = [
    dict(site="g.mm", kind="matmul", m=2048, n=2560, k=2560),
    dict(site="g.attn", kind="attention", m=512, n=80, k=512, batch=128,
         causal=True),
    dict(site="g.scan", kind="chunk_scan", m=256, n=64, k=16, batch=64),
]


def _pool_sites():
    from repro_torch.models.site import KernelSite
    return [KernelSite(**d) for d in POOL_SITES]


def test_pool_times_k1_k2_k3_in_its_workers(cuda, tmp_path, monkeypatch):
    """Two workers, each with its own context, time one K1, K2 and K3
    pair each finite; every launch happened in a worker (their counters,
    written under ``REPRO_TORCH_LAUNCH_DIR``), none in this process."""
    import json

    from repro_torch.measure import WorkerPoolTransport
    monkeypatch.setenv("REPRO_TORCH_LAUNCH_DIR", str(tmp_path))
    before = (kmm.launches, kfa.launches, kcs.launches)
    with WorkerPoolTransport(workers=2, runner_kwargs={"reps": 2},
                             spawn_timeout=300.0, job_timeout=120.0) as t:
        futs = t.submit(_pool_sites(), np.array([[128, 128, 512],
                                                 [128, 128, 1],
                                                 [256, 1, 1]]))
        vals = [f.result() for f in futs]
        st = t.stats()
    assert all(np.isfinite(v) and v > 0 for v in vals), vals
    assert st["health"] == "ok" and st["transport_failed_pairs_total"] == 0
    assert (kmm.launches, kfa.launches, kcs.launches) == before
    counts = [json.loads(p.read_text()) for p in tmp_path.glob("worker-*")]
    for k in ("matmul", "flash_attention", "chunk_scan"):
        assert sum(c[k] for c in counts) >= 1, (k, counts)


def _fault_pool(tmp_path, monkeypatch, factory):
    from repro_torch.measure import WorkerPoolTransport
    monkeypatch.setenv("REPRO_TEST_CARD_FAULT_FILE", str(tmp_path / "fired"))
    return WorkerPoolTransport(workers=2,
                               factory=f"test_torch_pool_helpers:{factory}",
                               spawn_timeout=300.0, job_timeout=20.0)


@pytest.mark.parametrize("factory", ["card_assert_once", "card_hang_once"])
def test_pool_replaces_a_poisoned_or_wedged_worker(cuda, tmp_path,
                                                   monkeypatch, factory):
    """A device-side assert (the context is dead) or a kernel that spins
    past ``job_timeout`` (the worker is killed mid-kernel) costs one
    worker: the pool respawns it, retries the pair finite, and every other
    pair comes back finite from a working pool."""
    from repro_torch.models.site import KernelSite
    fault = KernelSite(site="fault", kind="matmul", m=512, n=512, k=512)
    sites = [fault] + _pool_sites()
    tiles = np.array([[128, 128, 512], [128, 128, 512], [128, 128, 1],
                      [256, 1, 1]])
    with _fault_pool(tmp_path, monkeypatch, factory) as t:
        vals = [f.result() for f in t.submit(sites, tiles)]
        st = t.stats()
        assert (tmp_path / "fired").exists()
        assert all(np.isfinite(v) and v > 0 for v in vals), vals
        assert st["pool_worker_restarts_total"] >= 1
        assert st["transport_retries_total"] >= 1
        assert st["transport_failed_pairs_total"] == 0
        again = t.submit([KernelSite(site="after", kind="matmul", m=256,
                                     n=256, k=256)], tiles[:1])
        assert np.isfinite(again[0].result())
        assert t.health() == "ok"


# ---------------------------------------------------------------------------
# the card's timing lock, and the learned cost model on the card
# ---------------------------------------------------------------------------

def test_two_workers_timed_calls_do_not_overlap(cuda, tmp_path, monkeypatch):
    """A pool of 2 on one card: every timed call (warmup and repetitions)
    of one worker lies outside every timed call of the other, by the
    lock's own log of enter and exit times (``timing_lock_spans``)."""
    import json

    from repro_torch.measure import WorkerPoolTransport
    from repro_torch.models.site import KernelSite
    monkeypatch.setenv("REPRO_TORCH_LAUNCH_DIR", str(tmp_path))
    site = KernelSite(site="g.mm", kind="matmul", m=1024, n=1024, k=1024)
    tiles = np.array([[bm, bn, bk] for bm in (64, 128) for bn in (128, 256)
                      for bk in (128, 256, 512)])
    with WorkerPoolTransport(workers=2, runner_kwargs={"reps": 3},
                             spawn_timeout=300.0, job_timeout=120.0) as t:
        vals = [f.result() for f in t.submit([site] * len(tiles), tiles)]
    assert all(np.isfinite(v) and v > 0 for v in vals), vals
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("worker-*")]
    assert len(recs) == 2
    spans = [[tuple(s) for s in r["timing_lock_spans"]] for r in recs]
    assert all(spans) and sum(map(len, spans)) == len(tiles)
    assert sum(r["timing_lock"]["acquires"] for r in recs) == len(tiles)
    for a in spans[0]:
        for b in spans[1]:
            assert a[1] <= b[0] or b[1] <= a[0], (a, b)


def _surrogate_corpus():
    from repro_torch.core import costmodel_vec, dataset
    from repro_torch.core.env import ActionSpace
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.surrogate import Corpus
    rng = np.random.default_rng(0)
    sites, tiles = [], []
    for s in dataset.generate(60, seed=1):
        g = costmodel_vec.action_tiles_grid(ActionSpace(DEFAULT), s.kind)
        for i in rng.choice(len(g), size=min(6, len(g)), replace=False):
            sites.append(s)
            tiles.append(g[i])
    tiles = np.array(tiles)
    y = np.log(costmodel_vec.costs_for_tiles(sites, tiles, "tpu_v5e"))
    ok = np.isfinite(y)
    return Corpus(sites=tuple(s for s, k in zip(sites, ok) if k),
                  tiles=tiles[ok], y=y[ok] + rng.normal(0, 0.2, ok.sum()),
                  backends=("synthetic",) * int(ok.sum()))


def test_surrogate_trains_on_the_card_and_predicts_as_on_the_cpu(cuda):
    """Trained on the card, the ensemble's predictions match the same
    weights' on the CPU within 1e-5 log-seconds, TF32 kept off even when
    the caller turned it on."""
    from repro_torch.surrogate import SurrogateModel, featurize
    from repro_torch.surrogate import train_surrogate
    corpus = _surrogate_corpus()
    m = train_surrogate(corpus, steps=200, device="cuda")
    assert m.device.type == "cuda"
    assert all(p.is_cuda for mem in m.members for p in mem.parameters())
    cpu = SurrogateModel.from_state(m.state_dict(), device="cpu")
    X = featurize(corpus.sites, corpus.tiles)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = m.predict_log_seconds(X)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    np.testing.assert_allclose(got, cpu.predict_log_seconds(X), rtol=0,
                               atol=1e-5)
    # it learned the ranking it was shown
    r = np.corrcoef(got, corpus.y)[0, 1]
    assert r > 0.9, r


def test_pruned_measured_fit_times_at_most_k_plus_1_pairs_a_site(cuda):
    """K1, K2 and K3 sites under ``prune_topk=2``: each site times at
    most its 2 top-ranked tiles and its baseline on the card; the rest
    are surrogate-priced, and a brute-force pick is made over all."""
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.core.agents import BruteForceAgent
    from repro_torch.core.vectorizer import tune
    from repro_torch.measure import make_measured_env
    from repro_torch.models.site import KernelSite
    from repro_torch.surrogate import train_surrogate
    model = train_surrogate(_surrogate_corpus(), steps=100, device="cuda")
    sites = [KernelSite(site="p.mm", kind="matmul", m=512, n=512, k=512),
             KernelSite(site="p.attn", kind="attention", m=256, n=64,
                        k=256, batch=8, causal=True),
             KernelSite(site="p.scan", kind="chunk_scan", m=128, n=64,
                        k=16, batch=8)]
    env = make_measured_env(DEFAULT, device="cuda", reps=2, prune_topk=2,
                            surrogate=model)
    grid = env.cost_grid(sites)
    runner = env.measure_fn.transport.runner
    assert env.prune_active and env.pruned_pairs > 0
    assert runner.failed_pairs == 0
    for i, s in enumerate(sites):
        timed = env.timed_tiles(s)
        assert 1 <= len(timed) <= 3, (s.key(), timed)
        assert all(ops.tile_ok(s, t) for t in timed)
        assert np.isfinite(grid[i]).sum() >= len(timed)
    assert runner.timed_pairs <= 3 * len(sites)
    agent = BruteForceAgent(DEFAULT)
    agent.fit(sites, env)
    prog = tune(sites, agent, env.space, env)
    assert all(ops.tile_ok(s, prog.tiles[s.key()]) for s in sites)
    env.measure_fn.transport.close()


# ---------------------------------------------------------------------------
# the train path on the card
# ---------------------------------------------------------------------------

def test_attention_backward_on_the_card_matches_the_cpu(cuda):
    """The memory-efficient attention's ``Function`` in f32 (causal,
    Sq < Skv, Dv != D, several blocks each way): o, dq, dk and dv on the
    card within 1e-4 of the same call on the CPU (summation order only)."""
    from repro_torch.models import compute
    rng = np.random.default_rng(0)
    shapes = [(2, 4, 64, 32), (2, 4, 96, 32), (2, 4, 96, 48), (2, 4, 64, 48)]
    q, k, v, do = (rng.standard_normal(s, dtype=np.float32) for s in shapes)
    out = {}
    for dev in ("cpu", cuda):
        qt, kt, vt = (torch.from_numpy(a).to(dev).requires_grad_(True)
                      for a in (q, k, v))
        o = compute._mem_efficient_attention(qt, kt, vt, causal=True,
                                             scale=32 ** -0.5, bq=16,
                                             bkv=32)
        grads = torch.autograd.grad(o, (qt, kt, vt),
                                    torch.from_numpy(do).to(dev))
        out[str(dev)] = [t.detach().cpu() for t in (o, *grads)]
    for a, b in zip(out["cpu"], out["cuda"]):
        assert float((a - b).abs().max()) < 1e-4


def _train_step_on(device):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.steps import make_train_state, make_train_step
    model = build_model(get_config("stablelm_3b").reduced())
    # seed 0 draws the same weights on every device
    state = make_train_state(model, 0, AdamWConfig(), device=device)
    tok = torch.randint(0, 256, (4, 33),
                        generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tok[:, :-1].to(device),
             "targets": tok[:, 1:].to(device)}
    state, m = make_train_step(model, AdamWConfig(warmup_steps=1))(
        state, batch)
    return float(m["loss"]), float(m["grad_norm"]), state


def test_one_train_step_on_the_card_matches_the_cpu(cuda):
    """One step of the reduced (f32) StableLM, the same weights from seed
    0 and the same batch: the loss and the gradient norm within 1e-5
    relative, every updated parameter within 5e-5 of the CPU's."""
    from repro_torch.optim.adamw import _leaves
    lc, gc, sc = _train_step_on("cpu")
    lg, gg, sg = _train_step_on(cuda)
    assert abs(lg - lc) <= 1e-5 * abs(lc) and abs(gg - gc) <= 1e-5 * gc
    for a, b in zip(_leaves(sc["params"]), _leaves(sg["params"])):
        assert float((a - b.cpu()).abs().max()) < 5e-5


def test_kernel_mode_refuses_grad_on_the_card(cuda):
    """The 2-layer bf16 StableLM under an injected program: with the
    parameters requiring grad the first K1 call raises; under no_grad the
    kernels run and the loss is eager's within 5e-3 relative."""
    from repro_torch.core.extractor import extract_sites, meta_batch
    from repro_torch.optim.adamw import _leaves
    cfg = get_config("stablelm_3b").reduced(
        n_layers=2, d_model=640, n_heads=8, n_kv_heads=8, head_dim=80,
        d_ff=1024, vocab_size=1000, dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda)
    tok = torch.randint(0, 1000, (2, 129),
                        generator=torch.Generator().manual_seed(0)).to(cuda)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    prog = baseline_program(extract_sites(
        lambda p, b: model.train_loss(p, b), model.init(device="meta"),
        meta_batch(2, 128)))
    for p in _leaves(params):
        p.requires_grad_(True)
    before = (kmm.launches, kfa.launches)
    with inject(prog), pytest.raises(NotImplementedError,
                                     match="has no backward"):
        model.train_loss(params, batch)
    assert (kmm.launches, kfa.launches) == before
    for p in _leaves(params):
        p.requires_grad_(False)
    with torch.no_grad():
        le, _ = model.train_loss(params, batch)
        with inject(prog):
            lk, _ = model.train_loss(params, batch)
    assert (kmm.launches - before[0], kfa.launches - before[1]) == (15, 2)
    assert abs(float(lk) - float(le)) <= 5e-3 * abs(float(le))


# ---------------------------------------------------------------------------
# seed-0 weights on every device, and the kernels at the inputs of
# StarCoder2-7B, ChatGLM3-6B, Phi-3-Vision-4.2B and SeamlessM4T-medium
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["starcoder2_7b", "qwen3_8b", "stablelm_3b",
                                  "chatglm3_6b", "llama4_maverick_400b",
                                  "xlstm_1_3b", "phi3_vision_4_2b",
                                  "seamless_m4t_medium", "jamba_v0_1_52b"])
def test_seed0_init_is_the_same_on_the_cpu_and_the_card(cuda, arch, dtype):
    """Every leaf of the reduced config's seed-0 init, bitwise, in f32 and
    in bf16 (the f32 product by the scale and the cast are exact IEEE
    operations on both)."""
    from repro_torch.checkpoint.checkpoint import _flat
    model = build_model(get_config(arch).reduced(dtype=dtype))
    on_cpu = _flat(model.init(seed=0, device="cpu"))
    on_card = _flat(model.init(seed=0, device=cuda))
    assert [k for k, _ in on_card] == [k for k, _ in on_cpu]
    for (k, a), (_, b) in zip(on_cpu, on_card):
        assert b.is_cuda and torch.equal(a, b.cpu()), k


@pytest.mark.parametrize("hq,hkv,tiles,causal", [
    (16, 16, (128, 512), False),    # SeamlessM4T's encoder and cross-attn
    (16, 16, (128, 128), True),     # its decoder
    (36, 4, (128, 512), True),      # StarCoder2's groups of 9
    (32, 2, (128, 512), True),      # ChatGLM3's groups of 16
])
def test_flash_kernel_at_gqa_groups_and_head_dim_64(cuda, hq, hkv, tiles, causal):
    """K2 at D = 64 non-causal with Sq = Skv = 512 (no earlier path ran K2
    non-causal below D = 128), D = 64 causal, and the GQA groups of 9 and
    16 at D = 128, in the served layout, against its plain version."""
    d = 64 if hq == hkv else 128
    q, k, v = _attention_inputs(2, hq, hkv, 512, 512, _MODEL, cuda, seed=40,
                                d=d)
    y, ran = _flash_variant_ran(lambda: ops.flash_attention(
        q, k, v, causal=causal, scale=d ** -0.5, tiles=tiles))
    assert ran == {"tma_wgmma": 1, "unaligned": 0}
    yp = kfa.flash_attention_plain(q, k, v, causal=causal, scale=d ** -0.5,
                                   bq=tiles[0], bkv=tiles[1])
    assert torch.isfinite(y.float()).all()
    assert float((y.float() - yp.float()).abs().max()) < K2_ABS_TOL


def test_matmul_at_the_seamless_lm_head(cuda):
    """K1 at SeamlessM4T's ``lm_head``, ``4x256206x1024`` through
    ``head.T`` (an output row of 512412 bytes, not a multiple of 16), at
    the baseline tile against the f32 product and the plain version; the
    plan never splits K there (the output grid exceeds the SMs)."""
    from repro_torch.core.costmodel import baseline_matmul_tiles
    M, N, K = 4, 256206, 1024
    x = _normal(41, M, K, device=cuda)
    head = _normal(42, N, K, device=cuda)
    tiles = baseline_matmul_tiles(M, N, K)
    before = dict(kmm.launches_by_variant)
    y = ops.matmul(x, head.T, tiles=tiles)
    torch.cuda.synchronize()
    ran = {v: kmm.launches_by_variant[v] - before[v] for v in kmm.VARIANTS}
    assert ran == {"tma_wgmma": 1, "split_k": 0, "unaligned": 0, "f32": 0}
    assert y.shape == (M, N) and torch.isfinite(y.float()).all()
    assert _rel_err(y, x.float() @ head.float().T) < K1_REL_TOL
    assert _rel_err(y, kmm.matmul_plain(x, head.T).float()) < K1_REL_TOL


# ---------------------------------------------------------------------------
# K1 in f32 (the MoE router), and the kernels at the inputs of Llama-4
# Maverick and Jamba v0.1
# ---------------------------------------------------------------------------

K1_F32_TOL = 1e-5       # of the largest |output|: f32 sums in two orders


def _f32_normal(seed, *shape, device):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(device)


def _f32_ran(fn):
    before = dict(kmm.launches_by_variant)
    y = fn()
    torch.cuda.synchronize()
    return y, {v: kmm.launches_by_variant[v] - before[v]
               for v in kmm.VARIANTS}


@pytest.mark.parametrize("shape,tiles,layout", [
    ((2048, 128, 5120), (128, 128, 512), _W_ROW),    # Llama-4 router
    ((4, 128, 5120), (8, 128, 512), _W_ROW),
    ((2048, 16, 4096), (128, 128, 512), _W_ROW),     # Jamba router
    ((4, 16, 4096), (8, 128, 512), _W_ROW),
    ((513, 129, 257), (64, 512, 128), _W_ROW),       # ragged M, N, K
    ((37, 1000, 130), (16, 256, 128), _W_T),         # head.T
    ((300, 640, 384), (16, 512, 128), _W_ROW),       # a tile per row size
    ((300, 640, 384), (32, 256, 1024), _W_ROW),
    ((300, 640, 384), (64, 512, 4096), _W_T),
    ((300, 640, 384), (128, 256, 256), _W_ROW),
    ((300, 640, 384), (256, 128, 512), _W_T),
    ((2048, 2048, 2048), (128, 128, 512), _W_ROW),   # the corpus's b.f32
    ((4096, 128, 128), (128, 128, 128), _W_ROW),     # m.fft: one run
    ((64, 40, 700), (64, 128, 128), _W_T),           # a 64-column layout
])
def test_matmul_f32_variant_matches_the_f32_product(cuda, shape, tiles,
                                                    layout):
    """K1's f32 variant against the f32 product with TF32 off, within
    1e-5 of its largest |output| (a larger error would mean TF32 or a
    wrong sum); one launch of ``f32``, never ``split_k``."""
    M, N, K = shape
    x = _f32_normal(50, M, K, device=cuda)
    if layout == _W_T:
        w = _f32_normal(51, N, K, device=cuda).T
    else:
        w = _f32_normal(51, K, N, device=cuda)
    y, ran = _f32_ran(lambda: ops.matmul(x, w, tiles=tiles))
    assert ran == {v: int(v == "f32") for v in kmm.VARIANTS}
    assert y.dtype == torch.float32 and y.shape == (M, N)
    assert not torch.backends.cuda.matmul.allow_tf32
    want = x @ w
    assert float((y - want).abs().max() / want.abs().max()) < K1_F32_TOL
    assert torch.equal(kmm.matmul_plain(x, w), want)


def test_matmul_f32_every_tile_gives_the_same_bits(cuda):
    """Every f32 tile sums K in order, one FFMA a step: the tiles agree
    bitwise, the unaligned operands (scalar loads) too."""
    x = _f32_normal(52, 300, 514, device=cuda)
    w = _f32_normal(53, 514, 300, device=cuda)
    y0 = ops.matmul(x, w, tiles=(128, 128, 512))
    for t in [(8, 128, 128), (32, 512, 256), (256, 128, 4096),
              (64, 256, 1024)]:
        assert torch.equal(ops.matmul(x, w, tiles=t), y0), t
    buf = torch.empty((300, 515), device=cuda)
    buf[:, 1:] = x
    xu = buf[:, 1:]     # pitch 515 floats, base 4 bytes past 16: no cp.async
    assert torch.equal(ops.matmul(xu, w, tiles=(64, 128, 512)), y0)


def test_matmul_f32_splits_k_by_k_alone(cuda):
    """At M = 4 the bf16 plan splits K over the SMs by the output grid;
    the f32 one splits it by K alone (``ops.f32_split``), the same runs at
    every tile and M, one CTA a run, and stays within 1e-5 of the f32
    product."""
    M, N, K = 4, 4096, 12288
    x = _f32_normal(54, M, K, device=cuda)
    w = _f32_normal(55, K, N, device=cuda)
    plans = {ops.matmul_launch_plan(m, N, K, t, 132, dtype="float32")[8:10]
             for m in (4, 2048)
             for t in [(8, 128, 512), (128, 128, 512), (32, 512, 4096)]}
    assert plans == {ops.f32_split(K)} and ops.f32_split(K)[0] > 1
    y, ran = _f32_ran(lambda: ops.matmul(x, w, tiles=(8, 128, 512)))
    assert ran == {v: int(v == "f32") for v in kmm.VARIANTS}
    assert ops.matmul_launch_plan(M, N, K, (8, 128, 512),
                                  132).variant == "split_k"
    assert float((y - x @ w).abs().max() / (x @ w).abs().max()) < K1_F32_TOL


@pytest.mark.parametrize("N,K", [(128, 5120), (16, 4096), (160, 5120)])
def test_matmul_f32_rows_are_the_same_bits_at_every_m(cuda, N, K):
    """A token's router logits do not depend on its batch: rows 0-3 of a
    2048-row call equal a 4-row call of the same rows bitwise, at the
    Llama-4, Jamba and DeepSeek-V2 (N = 160: two column tiles, the second
    32 wide) routers' K, under the baseline tiles of each M and PPO's
    router tile."""
    x = _f32_normal(56, 2048, K, device=cuda)
    w = _f32_normal(57, K, N, device=cuda)
    big = ops.matmul(x, w, tiles=(128, 128, 512))
    small = ops.matmul(x[:4].clone(), w, tiles=(8, 128, 512))
    assert torch.equal(big[:4], small)
    assert torch.equal(ops.matmul(x, w, tiles=(32, 128, 1024)), big)


def test_runner_times_an_f32_site_with_f32_operands(cuda):
    """The measured oracle builds f32 operands for an f32 site and times
    K1's f32 variant, not a bf16 cast."""
    from repro_torch.measure.runner import MeasureRunner
    from repro_torch.models.site import KernelSite
    site = KernelSite("moe.router", "matmul", m=2048, n=128, k=5120,
                      dtype="float32")
    runner = MeasureRunner(reps=2, device=cuda)
    before = dict(kmm.launches_by_variant)
    t = runner([site], np.array([[128, 128, 512]]))
    assert np.isfinite(t).all() and t[0] > 0 and runner.failed_pairs == 0
    assert kmm.launches_by_variant["f32"] > before["f32"]
    assert all(kmm.launches_by_variant[v] == before[v]
               for v in kmm.VARIANTS if v != "f32")


@pytest.mark.parametrize("hq,hkv,tiles", [(40, 8, (128, 512)),
                                          (32, 8, (128, 512))])
def test_flash_kernel_at_llama4_and_jamba_attention(cuda, hq, hkv, tiles):
    """K2 at Llama-4's 40/8 heads (groups of 5) and Jamba's 32/8, D = 128,
    in the served layout, against its plain version."""
    q, k, v = _attention_inputs(2, hq, hkv, 512, 512, _MODEL, cuda, seed=60)
    y, ran = _flash_variant_ran(lambda: ops.flash_attention(
        q, k, v, causal=True, scale=128 ** -0.5, tiles=tiles))
    assert ran == {"tma_wgmma": 1, "unaligned": 0}
    yp = kfa.flash_attention_plain(q, k, v, causal=True, scale=128 ** -0.5,
                                   bq=tiles[0], bkv=tiles[1])
    assert float((y.float() - yp.float()).abs().max()) < K2_ABS_TOL


@pytest.mark.parametrize("arch", ["llama4_maverick_400b", "jamba_v0_1_52b"])
def test_moe_archs_under_inject_match_eager_on_the_card(cuda, arch):
    """A bf16 reduced config of each arch, its prefill under the baseline
    program: K1 in bf16 and in f32 (one router matmul a MoE layer), K2,
    logits near eager's."""
    cfg = get_config(arch).reduced(dtype="bfloat16", d_model=128,
                                   n_heads=2, n_kv_heads=1, head_dim=64)
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda)
    sites = extract_serve_sites(model, 2, 64, 2)
    prog = baseline_program(sites)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), device=cuda)
    n_moe = sum(b.mlp == "moe" for b in cfg.period) * cfg.n_periods
    with torch.inference_mode():
        le, _ = model.prefill(params, {"tokens": tok},
                              model.make_cache(2, 66, device=cuda))
        before = dict(kmm.launches_by_variant)
        with inject(prog):
            lk, _ = model.prefill(params, {"tokens": tok},
                                  model.make_cache(2, 66, device=cuda))
        torch.cuda.synchronize()
    assert kmm.launches_by_variant["f32"] - before["f32"] == n_moe
    assert float((lk - le).abs().max() / le.abs().max()) < 5e-2


def _onehot_positions(eidx, E, e0=0):
    """The reference's capacity positions: a cumsum of the slot-major
    one-hot down the choices (``moe._positions``' oracle)."""
    a_e = eidx.T.reshape(-1)
    onehot = (a_e[:, None] == torch.arange(e0, e0 + E,
                                           device=eidx.device)).int()
    return (torch.cumsum(onehot, dim=0) * onehot).sum(-1)


def test_moe_routing_on_the_card_syncs_nothing_and_matches(cuda,
                                                           monkeypatch):
    """DeepSeek-V2's routing shape (T = 2048, E = 160, K = 6): ``route``
    on the card under the sync debug mode "error" (no host sync), its
    ``pos_tk``, ``keep_tk`` and ``idx`` the CPU's, with experts 0-7
    favoured so that their buffers overflow.  The logits are distinct
    multiples of 0.025 a token, so both devices' top-k agree.  Then a
    bf16 ``apply_moe`` at that routing shape on the card (its seeded
    router drops about 3% of the choices on the CPU), bitwise its output
    with the one-hot cumsum's positions."""
    from repro_torch.models import moe
    from repro_torch.models.common import WeightDraw
    cfg = get_config("deepseek_v2_236b").reduced(
        dtype="bfloat16", d_model=128, moe_d_ff=64, n_experts=160,
        moe_top_k=6)
    T, E = 2048, 160
    rng = np.random.default_rng(80)
    logits = rng.permuted(np.tile(np.arange(E, dtype=np.float32), (T, 1)),
                          axis=1) * 0.05
    logits[:, :8] += 4.025
    lc = torch.from_numpy(logits)
    want = moe.route(cfg, lc)
    lg = lc.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = moe.route(cfg, lg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for name, i in (("eidx", 0), ("pos_tk", 1), ("keep_tk", 2), ("idx", 4)):
        assert torch.equal(got[i].cpu(), want[i]), name
    assert not bool(want[2].all())

    p = moe.moe_init(cfg, WeightDraw(0), torch.bfloat16, cuda)
    x = _normal(81, 2, T // 2, cfg.d_model, device=cuda)
    with torch.inference_mode():
        y, _ = moe.apply_moe(cfg, p, x)
        monkeypatch.setattr(moe, "_positions", _onehot_positions)
        y_ref, _ = moe.apply_moe(cfg, p, x)
    assert torch.equal(y, y_ref)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): K2 at head dims up to 192 with a value dim of its own
# ---------------------------------------------------------------------------

def _mla_inputs(B, h, S, d, dv, layout, device, seed=70):
    """q, k at D and v at Dv; under the model's layout (``models/mla.py``)
    q and k are contiguous concatenations and v the (b, s, h, d) einsum
    output seen as (b, h, s, d); the runner's layout is contiguous."""
    q = _normal(seed, B, h, S, d, device=device)
    k = _normal(seed + 1, B, h, S, d, device=device)
    if layout == _MODEL:
        v = _normal(seed + 2, B, S, h, dv, device=device).transpose(1, 2)
    else:
        v = _normal(seed + 2, B, h, S, dv, device=device)
    return q, k, v


@pytest.mark.parametrize("d,dv,layout,causal,tiles,keys,ring", [
    (192, 128, _MODEL, True, (128, 512), 64, 3),    # mla.core, the baseline
    (192, 128, _MODEL, True, (64, 128), 64, 4),     # a tile PPO can pick
    (192, 128, _MODEL, False, (128, 256), 64, 3),
    (192, 192, _CONTIG, True, (128, 512), 64, 2),   # the runner's D = Dv
    (192, 192, _CONTIG, False, (64, 64), 64, 3),
    (136, 136, _CONTIG, True, (128, 128), 64, 2),   # a third slab part past D
    (192, 64, _MODEL, True, (128, 512), 64, 3),     # Dv in two slabs, one
])                                                  # empty
def test_flash_kernel_at_mla_head_dims(cuda, d, dv, layout, causal, tiles,
                                       keys, ring):
    """K2 at D > 128 (three 64-column slabs of Q.K^T, 64-key stages in the
    deepest ring that fits) with a value dim of its own (P.V at 128 or 192
    in one tile), against its plain version at the true dims
    and the scale 1/sqrt(D); the output is (B, H, S, Dv) and nothing is
    written at or past column Dv."""
    B, h, S = 2, 8, 512
    q, k, v = _mla_inputs(B, h, S, d, dv, layout, cuda)
    p = ops.attention_launch_plan(S, S, d, *tiles, Dv=dv)
    assert (p.stage_keys, p.ring) == (keys, ring)
    y, ran = _flash_variant_ran(lambda: ops.flash_attention(
        q, k, v, causal=causal, scale=d ** -0.5, tiles=tiles))
    assert ran == {"tma_wgmma": 1, "unaligned": 0}
    yp = kfa.flash_attention_plain(q, k, v, causal=causal, scale=d ** -0.5,
                                   bq=tiles[0], bkv=tiles[1])
    assert y.shape == (B, h, S, dv) and torch.isfinite(y.float()).all()
    assert float((y.float() - yp.float()).abs().max()) < K2_ABS_TOL
    variant, yc, canary = _flash_into_canary(q, k, v, causal, tiles)
    assert variant == "tma_wgmma" and torch.equal(yc, y)
    assert bool((canary == 7.0).all())


# (D, Dv) at each compiled width: D = Dv, and Dv below D where the rule
# admits it (a narrower P.V width, or the same width with columns past Dv)
_WIDTH_PAIRS = [(16, 16), (24, 24), (24, 16), (64, 64), (64, 32), (72, 72),
                (72, 40), (80, 80), (80, 48), (96, 96), (96, 64),
                (104, 104), (104, 56), (136, 136), (136, 64), (192, 192),
                (192, 128), (192, 64)]


@pytest.mark.parametrize("d,dv", _WIDTH_PAIRS)
@pytest.mark.parametrize("B,hq,hkv,sq,skv,tiles,causal,layout", [
    (2, 8, 2, 512, 512, (128, 512), True, _MODEL),     # served, GQA
    (1, 4, 4, 256, 384, (64, 128), False, _CONTIG),    # Sq < Skv, 1 WG
    (2, 4, 2, 96, 200, (128, 256), True, _MODEL),      # ragged last stage
])
def test_flash_kernel_at_its_own_widths(cuda, d, dv, B, hq, hkv, sq, skv,
                                        tiles, causal, layout):
    """K2 at Q.K^T's and P.V's own padded widths (``ops.attn_widths``: 64,
    96 as a 64- and a 32-column slab, 128, 192) against its plain version
    at the true D and Dv, causal and not, in the model's layout (v the
    transposed view of its projection) and contiguous; nothing is written
    at or past column Dv."""
    q = _normal(110, B, hq, sq, d, device=cuda)
    k = _normal(111, B, hkv, skv, d, device=cuda)
    if layout == _MODEL:
        v = _normal(112, B, skv, hkv, dv, device=cuda).transpose(1, 2)
    else:
        v = _normal(112, B, hkv, skv, dv, device=cuda)
    p = ops.attention_launch_plan(sq, skv, d, *tiles, Dv=dv)
    assert (p.d_pad, p.dv_pad) == ops.attn_widths(d, dv)
    y, ran = _flash_variant_ran(lambda: ops.flash_attention(
        q, k, v, causal=causal, scale=d ** -0.5, tiles=tiles))
    assert ran == {"tma_wgmma": 1, "unaligned": 0}
    yp = kfa.flash_attention_plain(q, k, v, causal=causal, scale=d ** -0.5,
                                   bq=tiles[0], bkv=tiles[1])
    assert y.shape == (B, hq, sq, dv) and torch.isfinite(y.float()).all()
    assert float((y.float() - yp.float()).abs().max()) < K2_ABS_TOL
    variant, yc, canary = _flash_into_canary(q, k, v, causal, tiles)
    assert variant == "tma_wgmma" and torch.equal(yc, y)
    assert bool((canary == 7.0).all())


def test_flash_kernel_at_192_computes_the_scores_once(cuda):
    """At D = Dv = 192 (the runner's MLA layout) the kernel walks one tile
    a (query block, batch, head): P.V at 192 columns in the tile that
    computed the scores, none computed twice."""
    import ctypes
    B, h, S, bq = 1, 16, 512, 128
    tiles_of = kfa._fn("repro_flash_tma_tiles", [ctypes.c_int] * 4)
    assert tiles_of(B, h, S, bq) == (S // bq) * B * h
    assert tiles_of(B, h, S, 96) == -1
    p = ops.attention_launch_plan(S, S, 192, bq, 512, Dv=192)
    assert (p.d_pad, p.dv_pad, p.stage_keys, p.ring) == (192, 192, 64, 2)
    q, k, v = _mla_inputs(B, h, S, 192, 192, _CONTIG, cuda, seed=120)
    y, ran = _flash_variant_ran(lambda: ops.flash_attention(
        q, k, v, causal=True, scale=192 ** -0.5, tiles=(bq, 512)))
    assert ran == {"tma_wgmma": 1, "unaligned": 0}
    assert kfa.tma_last_launch() == dict(
        warpgroups=2, stage_keys=64, d_pad=192, dv_pad=192, ring=2,
        smem=p.smem)
    yp = kfa.flash_attention_plain(q, k, v, causal=True, scale=192 ** -0.5,
                                   bq=bq, bkv=512)
    assert float((y.float() - yp.float()).abs().max()) < K2_ABS_TOL


def test_flash_entry_point_runs_at_the_widths_it_is_given(cuda):
    """Variant A's entry point runs at the widths the plan passes it: D =
    Dv = 64 given (128, 128) in a ring of 2 gives the output of its own
    (64, 64) bit for bit (the columns past 64 add exact zeros) and its
    launch reads back (128, 128); a pair of widths it does not compile, or
    one narrower than D or Dv, is refused with nothing written."""
    B, h, S, d = 2, 4, 256, 64
    q, k, v = (_normal(130 + i, B, h, S, d, device=cuda) for i in range(3))
    variant, fn, args = kfa._prepare(q, k, v, True, 128, 128)
    assert variant == "tma_wgmma" and args[20:23] == (2, 64, 64)

    def run(fn, q, k, a, ring, dqk, dvp):
        out = torch.full((B, h, S, d), 7.0, dtype=torch.bfloat16,
                         device=cuda)
        a = list(a)
        a[20:23] = ring, dqk, dvp
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *a, d ** -0.5, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        return rc, out

    rc, own = run(fn, q, k, args, 2, 64, 64)
    assert rc == 0 and kfa.tma_last_launch()["d_pad"] == 64
    rc, wide = run(fn, q, k, args, 2, 128, 128)
    assert rc == 0 and torch.equal(wide, own)
    assert kfa.tma_last_launch() == dict(
        warpgroups=2, stage_keys=128, d_pad=128, dv_pad=128, ring=2,
        smem=2 * 2 * 64 * 128 * 2 + 2 * 4 * 128 * 128 + 1024)
    for dqk, dvp in ((96, 64), (64, 96), (160, 160), (48, 48), (192, 96)):
        rc, out = run(fn, q, k, args, 2, dqk, dvp)
        assert rc == 1 and bool((out == 7.0).all()), (dqk, dvp)
    q80 = _normal(136, B, h, S, 80, device=cuda)
    k80 = _normal(137, B, h, S, 80, device=cuda)
    _, fn80, args80 = kfa._prepare(q80, k80, v, True, 128, 128)
    assert args80[21:23] == (96, 96)
    rc, out = run(fn80, q80, k80, args80, 2, 64, 64)   # D = 80 past 64
    assert rc == 1 and bool((out == 7.0).all())


@pytest.mark.parametrize("d,dv", [(192, 128), (192, 192), (136, 136)])
def test_flash_unaligned_variant_at_mla_head_dims(cuda, d, dv):
    """The unaligned variant (q 2 bytes into its storage) at three slabs
    of D and a value dim of its own."""
    q = _normal(80, 1, 4, 256, d + 1, device=cuda)[..., 1:]
    k = _normal(81, 1, 4, 256, d, device=cuda)
    v = _normal(82, 1, 4, 256, dv, device=cuda)
    y, ran = _flash_variant_ran(lambda: ops.flash_attention(
        q, k, v, causal=True, scale=d ** -0.5, tiles=(64, 128)))
    assert ran == {"tma_wgmma": 0, "unaligned": 1}
    yp = kfa.flash_attention_plain(q, k, v, causal=True, scale=d ** -0.5,
                                   bq=64, bkv=128)
    assert float((y.float() - yp.float()).abs().max()) < K2_ABS_TOL
    variant, yc, canary = _flash_into_canary(q, k, v, True, (64, 128))
    assert variant == "unaligned" and torch.equal(yc, y)
    assert bool((canary == 7.0).all())


def test_flash_kernel_at_head_dim_128_runs_the_plan_before_mla(cuda):
    """At D = Dv = 128 (Qwen3-8B's prefill in the served layout) the call
    passes the C entry point the arguments of the plan it had before K2
    took D > 128: 128-key stages, a ring of 2, two warpgroups, and the
    widths 128 and 128."""
    q, k, v = _attention_inputs(4, 32, 8, 512, 512, _MODEL, cuda, seed=90)
    variant, _, args = kfa._prepare(q, k, v, True, 128, 512)
    assert variant == "tma_wgmma"
    assert args[5:7] == (128, 128)
    assert args[-8:] == (128, 2, 128, 4, 2, 128, 128, 1)
    y, ran = _flash_variant_ran(lambda: ops.flash_attention(
        q, k, v, causal=True, scale=128 ** -0.5, tiles=(128, 512)))
    yp = kfa.flash_attention_plain(q, k, v, causal=True, scale=128 ** -0.5,
                                   bq=128, bkv=512)
    assert float((y.float() - yp.float()).abs().max()) < K2_ABS_TOL


def test_flash_refuses_a_value_dim_past_192_before_the_device(cuda):
    """Dv = 200 raises in the wrapper's check, before any launch or any
    allocation on the card."""
    q = torch.zeros((1, 2, 64, 192), dtype=torch.bfloat16, device=cuda)
    v = torch.zeros((1, 2, 64, 200), dtype=torch.bfloat16, device=cuda)
    before, mem = kfa.launches, torch.cuda.memory_allocated()
    with pytest.raises(ValueError, match="value dim"):
        kfa.flash_attention_cuda(q, q, v, causal=True, scale=0.1, bq=64,
                                 bkv=64)
    assert kfa.launches == before
    assert torch.cuda.memory_allocated() == mem


def test_deepseek_under_inject_matches_eager_on_the_card(cuda):
    """A bf16 reduced DeepSeek-V2 at MLA's full head dims (D = 128 + 64,
    Dv = 128): its prefill under the baseline program runs K2 at D = 192,
    Dv = 128 once a layer and the f32 router once a MoE layer, and its
    logits lie near eager's; three absorbed decode steps follow."""
    cfg = get_config("deepseek_v2_236b").reduced(
        dtype="bfloat16", d_model=256, n_heads=4, qk_nope_dim=128,
        qk_rope_dim=64, v_head_dim=128, n_layers=2)
    model = build_model(cfg)
    params = model.init(seed=0, device=cuda)
    sites = extract_serve_sites(model, 2, 128, 4)
    prog = baseline_program(sites)
    tok = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda)
    with torch.inference_mode():
        le, _ = model.prefill(params, {"tokens": tok},
                              model.make_cache(2, 132, device=cuda))
        before = (dict(kmm.launches_by_variant), kfa.launches)
        with inject(prog):
            cache = model.make_cache(2, 132, device=cuda)
            lk, cache = model.prefill(params, {"tokens": tok}, cache)
            for i in range(3):
                lk_d, cache = model.decode_step(
                    params, lk.argmax(-1)[:, None], 128 + i, cache)
        torch.cuda.synchronize()
    assert kmm.launches_by_variant["f32"] - before[0]["f32"] == 2 * 4
    assert kfa.launches - before[1] == 2
    assert float((lk - le).abs().max() / le.abs().max()) < 5e-2
    assert torch.isfinite(lk_d).all()


# ---------------------------------------------------------------------------
# the serving layer on the card: the fused tuner's graph and the batcher
# (the card's machine has no JAX: the port's CPU route stands in for the
# JAX package here)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus_sites():
    from repro_torch.core import dataset
    return dataset.arch_sites()


@pytest.mark.parametrize("legality", ["h100", "cpu", "tpu_v5e"])
def test_fused_tuner_on_the_card_matches_its_cpu_route(cuda, corpus_sites,
                                                       legality):
    """Over the ten-arch corpus the card's graph picks what the CPU route
    picks, at the same f32 costs bit for bit (the analytic kernels are
    IEEE elementwise operations), in one dispatch and one capture."""
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.serving import FusedTuner
    gpu = FusedTuner(DEFAULT, legality=legality, device="cuda")
    cpu = FusedTuner(DEFAULT, legality=legality, device="cpu")
    got, want = gpu._run(corpus_sites), cpu._run(corpus_sites)
    np.testing.assert_array_equal(got[:, :6], want[:, :6])
    np.testing.assert_array_equal(got[:, 6], want[:, 6])
    assert gpu.dispatch_count == 1 and gpu.trace_count == 1
    gpu.actions(corpus_sites[:70])          # the same bucket: no capture
    assert gpu.trace_count == 1 and gpu.dispatch_count == 2


def test_fused_graph_replay_equals_the_eager_pipeline(cuda, corpus_sites):
    import torch
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.serving import FusedTuner, bucket_size
    from repro_torch.serving.fused import _pack_sites
    tuner = FusedTuner(DEFAULT, legality="h100", device="cuda")
    sites = corpus_sites[:40]
    replayed = tuner._run(sites)
    packed = torch.from_numpy(_pack_sites(sites, bucket_size(len(sites)),
                                          "h100")).cuda()
    eager = tuner._nograd_impl(packed).cpu().numpy()[:len(sites)]
    np.testing.assert_array_equal(replayed, eager)
    # a second bucket captures a second graph; both replay correctly
    again = tuner._run(corpus_sites)
    assert tuner.trace_count == 2
    np.testing.assert_array_equal(again[:40], replayed)


@pytest.mark.parametrize("mode", ["discrete", "cont1", "cont2",
                                  "two_agents"])
def test_agent_batch_ppo_on_the_card_batched_equals_solo(cuda, mode):
    """AgentBatch's bucketed forward against each request's solo act, on
    the card, with the legal masks of legality h100 (the bucket's batch
    size may take another cuBLAS algorithm than a request's alone)."""
    from repro_torch.configs.neurovec import NeuroVecConfig
    from repro_torch.core.agents import PPOAgent
    from repro_torch.core.env import CostModelEnv
    from repro_torch.core import dataset
    from repro_torch.serving import AgentBatch
    nv = NeuroVecConfig(train_batch=64, sgd_minibatch=32, ppo_epochs=2)
    env = CostModelEnv(nv, legality="h100")
    sites = [s for s in dataset.generate(80, seed=3)
             if np.isfinite(env.cost_grid([s])).any()]
    agent = PPOAgent(nv, mode=mode, device="cuda").fit(sites, env,
                                                       total_steps=128)
    reqs = [sites[:5], sites[5:17], sites[17:30]]
    solo = [agent.act(r, legal=np.isfinite(env.cost_grid(r))) for r in reqs]
    got = AgentBatch(agent).act_many(reqs, [env] * len(reqs))
    for a, b in zip(got, solo):
        np.testing.assert_array_equal(a, b)
