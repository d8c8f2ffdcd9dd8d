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
    x = torch.zeros((16, 128), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.matmul(x, x.T)


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
    """K2 takes head dims that are multiples of 8 up to 128 (the launch
    rule, ``ops.head_dim_ok``); others raise before any launch."""
    before = kfa.launches
    for d in (20, 136, 192):
        q = torch.zeros((1, 2, 64, d), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_attention(q, q, q, causal=True, scale=0.1)
    assert kfa.launches == before


def _flash_into_canary(q, k, v, causal, tiles):
    """K2 through its C entry point into an output buffer followed by a
    canary: the output's rows are D apart, so a column at or past D
    written by the last row lands on the canary.  Returns the output and
    the canary."""
    B, H, Sq, D = q.shape
    n = B * H * Sq * D
    buf = torch.full((n + 1024,), 7.0, dtype=torch.bfloat16, device=q.device)
    variant, fn, args = kfa._prepare(q, k, v, causal, *tiles)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(), *args,
            float(D ** -0.5), torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()
    return variant, buf[:n].view(B, H, Sq, D), buf[n:]


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
