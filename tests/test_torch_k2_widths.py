"""K2 at head dims other than 128: ``Q.K^T`` and ``P.V`` at the head dims'
own padded widths, as far as the CPU can check them.

The kernel runs only on the card (``tests/test_torch_gpu.py`` holds it
against its plain version there, with the output canary).  Here, over
every (D, Dv) the launch rule admits and every tile of the action space:
the plan's widths cover D and Dv in multiples of 32, its shared memory
fits, its ring is at least 2 wherever the plan before the redesign had
2, the width-128 plan is that plan field for field, and the source
compiles each (warpgroups, keys, widths) a plan names.  The rule itself
(``head_dim_ok``, ``attention_tiles_legal``, ``tile_ok`` over the
ten-arch corpus, the cost grids under ``h100`` and ``cpu``) is bitwise a
frozen copy of the one these widths were designed under.  Exact integer
checks: no tolerance.
"""
import itertools
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs.neurovec import DEFAULT as NV
from repro_torch.core import costmodel_vec, dataset
from repro_torch.core.env import CostModelEnv
from repro_torch.kernels import ops

DIMS = range(8, 193, 8)
TILES = list(itertools.product(NV.bq_choices, NV.bkv_choices))
# (Sq, Skv): the served prefills (512; Phi-3's 768), a runner's short and
# long sequences, Sq < Skv, and blocks below 128 keys
SEQS = ((64, 64), (128, 128), (256, 256), (512, 512), (768, 768),
        (128, 512), (2048, 2048))
SMEM_DYN = 232448 - 1024


def _frozen_head_dim_ok(D, Dv=None):
    """The head-dim clause as the widths were designed under, written out:
    D and Dv multiples of 8 up to 192, Dv's class (128 up to 128, 192
    above) no wider than D's."""
    D = np.asarray(D, np.int64)
    Dv = D if Dv is None else np.asarray(Dv, np.int64)

    def one(d):
        return (d >= 8) & (d % 8 == 0) & (d <= 192)

    def cls(d):
        return np.where(d <= 128, 128, 192)
    return one(D) & one(Dv) & (cls(Dv) <= cls(D))


def _frozen_tiles_legal(Sq, Skv, D, bq, bkv, *, dtype="bfloat16",
                        route="cuda"):
    """K2's launch predicate, written out: bf16 on the card (any dtype on
    the CPU route), positive blocks clamped to the sequence, at most two
    64-row warpgroups, blocks that divide it; decode always."""
    bq, bkv = np.asarray(bq, np.int64), np.asarray(bkv, np.int64)
    bq_e = np.maximum(np.minimum(bq, Sq), 1)
    bkv_e = np.maximum(np.minimum(bkv, Skv), 1)
    launched = (_frozen_head_dim_ok(D) & (bq_e <= 128)
                & (Sq % bq_e == 0) & (Skv % bkv_e == 0))
    dt = np.asarray(dtype)
    dt_ok = (np.ones(dt.shape, bool) if route == "cpu"
             else np.isin(dt, ("bfloat16",)))
    return dt_ok & (bq > 0) & (bkv > 0) & ((np.asarray(Sq) == 1) | launched)


def _parent_plan(Sq, Skv, D, bq, bkv, Dv):
    """K2's plan before this redesign, field for field (variant, bq, bkv,
    warpgroups, stage keys, stages, ring, smem): Q.K^T at 128 (192 above),
    P.V in 128-column parts, 128-key stages only where bkv >= 128 and D <=
    128, a ring of at most 2."""
    if not _frozen_tiles_legal(Sq, Skv, D, bq, bkv) or (
            Sq > 1 and not _frozen_head_dim_ok(D, Dv)):
        return None
    bq, bkv = min(bq, Sq), min(bkv, Skv)
    if Sq % bq or Skv % bkv:
        return None
    wgs = -(-bq // 64)
    d_pad = 128 if D <= 128 else 192
    keys = 128 if bkv >= 128 and d_pad == 128 else 64
    n_stages = -(-Skv // keys)
    stage = 2 * keys * (d_pad + 128)
    q_bytes, o_bytes = wgs * 64 * d_pad * 2, wgs * 64 * 128 * 2
    fit = (SMEM_DYN - 1024 - q_bytes - o_bytes) // stage
    ring = max(1, min(2, fit, 4, n_stages))
    return ("tma_wgmma", bq, bkv, wgs, keys, n_stages, ring,
            q_bytes + o_bytes + ring * stage + 1024)


def _compiled_cases():
    """(warpgroups, stage keys, DQK, DV) of every tma_wgmma kernel
    ``csrc/flash_attention.cu`` compiles, read from its dispatch."""
    src = (Path(ops.__file__).resolve().parent.parent / "csrc" /
           "flash_attention.cu").read_text()
    return {tuple(int(v) for v in m) for m in re.findall(
        r"^\s*REPRO_FA_CASE\((\d+), (\d+), (\d+), (\d+)\)", src, re.M)}


PAIRS = [(d, dv) for d in DIMS for dv in DIMS if _frozen_head_dim_ok(d, dv)]
COMPILED = _compiled_cases()


@pytest.fixture(scope="module")
def corpus():
    sites = dataset.arch_sites()
    assert len(sites) == 105
    return sites


@pytest.mark.parametrize("D,Dv", PAIRS)
def test_plan_at_the_head_dims_own_widths(D, Dv):
    """At every tile and sequence: the plan exists where the parent's did;
    its widths are of ``ops.ATTN_WIDTHS``, multiples of 32, at least D and
    Dv; its ring is the deepest whose shared memory (Q at D's width, the
    staging and the V tiles at Dv's, the 96-column staging rows a chunk
    longer) fits, up to 4 (2 at the width 128), no deeper than the stages,
    and so at least 2 wherever the parent's was (where a 128-key stage now
    holds all of a 128-key sequence, its one stage); at the width 128 it
    is the parent's plan; the source compiles its kernel."""
    n = 0
    for (Sq, Skv), t in itertools.product(SEQS, TILES):
        want = _parent_plan(Sq, Skv, D, *t, Dv)
        p = ops.attention_launch_plan(Sq, Skv, D, *t, Dv=Dv)
        assert (p is None) == (want is None), (Sq, Skv, t)
        if p is None:
            continue
        n += 1
        assert (p.d_pad, p.dv_pad) in ops.ATTN_WIDTHS
        assert p.d_pad % 32 == 0 and p.dv_pad % 32 == 0
        assert p.d_pad >= D and p.dv_pad >= Dv
        assert p.d_pad == min(w for w in (64, 96, 128, 192)
                              if w >= max(D, Dv if D <= 128 else 0))
        staging = 64 * (2 * p.dv_pad + (16 if p.dv_pad == 96 else 0))
        fixed = p.warpgroups * (64 * p.d_pad * 2 + staging)
        stage = 2 * p.stage_keys * (p.d_pad + p.dv_pad)
        deepest = 2 if (p.d_pad, p.dv_pad) == (128, 128) else 4
        assert p.ring == max(1, min(deepest, (SMEM_DYN - 1024 - fixed)
                                    // stage, p.n_stages)), (Sq, Skv, t)
        assert p.smem == fixed + p.ring * stage + 1024
        assert p.smem <= ops.ATTN_SMEM_DYN == SMEM_DYN
        if want[6] >= 2:     # or one stage holds every key (a ring of 1)
            assert p.ring >= min(2, p.n_stages), (Sq, Skv, t)
        if (p.d_pad, p.dv_pad) == (128, 128):
            assert tuple(p)[:8] == want, (Sq, Skv, t)
        else:       # the same blocks, warpgroups, keys and stages
            assert tuple(p)[:6] == want[:6], (Sq, Skv, t)
        assert (p.warpgroups, p.stage_keys, p.d_pad, p.dv_pad) in COMPILED
    assert n > 0


def _c_params(src, name):
    """The parameters of the C function ``name`` in ``src``, as
    (type, name) pairs."""
    m = re.search(r'extern "C" \w+ ' + name + r"\(([^)]*)\)", src)
    return [tuple(p.strip().rsplit(" ", 1)) for p in
            " ".join(m.group(1).split()).split(",")]


def test_the_entry_point_takes_the_plans_widths():
    """Variant A's C entry point takes the plan's widths after its ring,
    the wrapper's argument types match its parameters one for one, and
    its dispatch launches a kernel only where the widths, warpgroups and
    stage keys passed are those of a compiled one (else it refuses)."""
    import ctypes

    from repro_torch.kernels import flash_attention as kfa
    src = (Path(ops.__file__).resolve().parent.parent / "csrc" /
           "flash_attention.cu").read_text()
    params = _c_params(src, "repro_flash_fwd_tma_bf16")
    ctype = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
             "int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    assert [ctype[t] for t, _ in params] == kfa._TMA_ARGTYPES
    names = [n for _, n in params]
    assert names[names.index("ring"):names.index("ring") + 4] == [
        "ring", "dqk", "dvp", "causal"]
    assert ("warpgroups == W_ && stage_keys == K_ && dqk == DQ_ && "
            "dvp == DV_") in " ".join(src.split())
    assert _c_params(src, "repro_flash_tma_tiles") == [
        ("int", n) for n in ("B", "Hq", "Sq", "bq")]


def test_widths_are_the_narrowest_compiled_pair():
    """``ops.attn_widths`` gives, for every admitted pair, the narrowest
    compiled (D, Dv) widths at least as wide as both: each rounded up to
    64, 96, 128 or 192, one width for both up to 128."""
    for D, Dv in PAIRS:
        got = ops.attn_widths(D, Dv)
        cover = [w for w in ops.ATTN_WIDTHS if w[0] >= D and w[1] >= Dv]
        assert got == min(cover, key=sum), (D, Dv)
    assert ops.attn_widths(80) == (96, 96)
    assert ops.attn_widths(64) == (64, 64)
    assert ops.attn_widths(192, 128) == (192, 128)
    assert ops.attn_widths(192) == (192, 192)
    assert ops.attn_widths(128, 40) == (128, 128)


def test_the_source_compiles_the_widths_and_stages_plans_name():
    """The compiled kernels are the instantiated widths (D = Dv in {64, 96,
    128, 192}, and D = 192 with Dv = 128), the width-128 ones the four of
    the first redesign, and every one is named by some plan."""
    assert {c[2:] for c in COMPILED} == set(ops.ATTN_WIDTHS)
    assert {c[:2] for c in COMPILED if c[2:] == (128, 128)} == {
        (1, 64), (1, 128), (2, 64), (2, 128)}
    named = set()
    for (D, Dv), (Sq, Skv), t in itertools.product(
            ((64, 64), (96, 96), (128, 128), (192, 128), (192, 192)),
            SEQS + ((64, 128),), TILES + [(128, 64), (64, 64)]):
        p = ops.attention_launch_plan(Sq, Skv, D, *t, Dv=Dv)
        if p is not None:
            named.add((p.warpgroups, p.stage_keys, p.d_pad, p.dv_pad))
    assert named == COMPILED


def test_mla_and_the_runner_compute_their_scores_once():
    """MLA's served ``mla.core`` (D = 192, Dv = 128) and the runner's D =
    Dv = 192 plan P.V at Dv's own width: one tile a (query block, batch,
    head), 64 keys a stage in a ring of 3 and 2 at two warpgroups, 4 and
    3 at one; StableLM-3B's D = 80 at 96 in a ring of 3, SeamlessM4T's 64
    in a ring of 4, Phi-3's 96 at its PPO tile in a ring of 4."""
    def plan(S, D, t, Dv=None):
        p = ops.attention_launch_plan(S, S, D, *t, Dv=Dv)
        return (p.warpgroups, p.stage_keys, p.n_stages, p.ring, p.d_pad,
                p.dv_pad)
    assert plan(512, 192, (128, 512), 128) == (2, 64, 8, 3, 192, 128)
    assert plan(512, 192, (64, 128), 128) == (1, 64, 8, 4, 192, 128)
    assert plan(512, 192, (128, 512)) == (2, 64, 8, 2, 192, 192)
    assert plan(512, 192, (64, 512)) == (1, 64, 8, 3, 192, 192)
    assert plan(512, 80, (128, 512)) == (2, 128, 4, 3, 96, 96)
    assert plan(512, 64, (128, 512)) == (2, 128, 4, 4, 64, 64)
    assert plan(768, 96, (64, 128)) == (1, 128, 6, 4, 96, 96)
    assert plan(768, 96, (128, 256)) == (2, 128, 6, 3, 96, 96)
    assert plan(512, 128, (128, 512)) == (2, 128, 4, 2, 128, 128)


@pytest.mark.parametrize("route", ["cuda", "cpu"])
def test_the_rule_is_the_frozen_predicate(route):
    """``head_dim_ok`` over every (D, Dv) from 0 to 256 and
    ``attention_tiles_legal`` over the action space and smaller blocks at
    every head dim from 0 to 256, in bf16 and f32, bitwise the frozen
    copy."""
    d = np.arange(0, 257)
    assert np.array_equal(ops.head_dim_ok(d[:, None], d[None, :]),
                          _frozen_head_dim_ok(d[:, None], d[None, :]))
    bq = np.array(sorted(set(NV.bq_choices) | {0, 16, 32, 96}))
    bkv = np.array(sorted(set(NV.bkv_choices) | {0, 16, 64}))
    for (Sq, Skv), dtype in itertools.product(SEQS + ((1, 512), (96, 200)),
                                              ("bfloat16", "float32")):
        args = (Sq, Skv, d[:, None, None], bq[None, :, None],
                bkv[None, None, :])
        got = ops.attention_tiles_legal(*args, dtype=dtype, route=route)
        want = _frozen_tiles_legal(*args, dtype=dtype, route=route)
        assert np.array_equal(got, want), (Sq, Skv, dtype)


def test_tile_ok_over_the_corpus_is_the_frozen_predicate(corpus):
    """Every attention site of the ten-arch corpus, every tile of the
    action space, both routes."""
    n = 0
    for s in corpus:
        if s.kind != "attention":
            continue
        for t, route in itertools.product(TILES, ("cuda", "cpu")):
            want = bool(_frozen_tiles_legal(s.m, s.k, s.n, *t,
                                            dtype=s.dtype, route=route))
            assert ops.tile_ok(s, t, route) == want, (s.key(), t, route)
            n += want
    assert n > 0


@pytest.mark.parametrize("legality", ["h100", "cpu"])
def test_cost_grids_are_the_frozen_predicates(corpus, legality,
                                              monkeypatch):
    """Every cost grid under the card's rules over the corpus is, bit for
    bit, the grid the frozen predicate gives: the same legal sets and
    prices, so every agent tunes the same ``TileProgram``."""
    env = CostModelEnv(NV, legality=legality)
    got = env.cost_grid(corpus)
    monkeypatch.setattr(ops, "attention_tiles_legal", _frozen_tiles_legal)
    want = costmodel_vec.cost_grid(env.space, corpus, legality)
    assert np.array_equal(got, want)
