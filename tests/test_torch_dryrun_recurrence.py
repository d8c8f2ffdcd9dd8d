"""The dry-run's count of the sLSTM's loop over time: under the counting
``OpCounter`` the loop runs as one batched body plus the bytes and saved
storage by which S stepwise steps exceed it (``models/xlstm.py``,
``_slstm_counted``), as the reference counts a ``lax.scan`` body once
times its trip count (``repro/launch/hlo_analysis.py``).  Held against
the stepwise loop counted in full: flops and collective bytes exactly,
bytes within 1% and peak within 5%.  Found on the CPU: flops, bytes,
collectives and the cells' peaks are all equal; the sLSTM alone, where
it makes the peak, counts the same bytes and a peak from 2.8% below to
2.0% above the loop's (0.9717-1.0197).  A real forward never takes the
stand-in."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import BlockDesc, ShapeConfig
from repro_torch.launch import dryrun, op_analysis
from repro_torch.models import xlstm

# one period of the 7:1 stack cut to an mLSTM and an sLSTM block
CFG = get_config("xlstm_1_3b").reduced(
    n_layers=2, period=(BlockDesc("mlstm", "none"), BlockDesc("slstm",
                                                             "none")))
BYTES_TOL, PEAK_TOL = 0.01, 0.05


@pytest.fixture
def stepwise(monkeypatch):
    """Count the loop step by step: the stand-in's predicate off."""
    def off():
        monkeypatch.setattr(op_analysis, "counting_active",
                            lambda *a: False)
    return off


@pytest.fixture
def stand_in_calls(monkeypatch):
    calls = []
    orig = xlstm._slstm_counted

    def counted(*a, **k):
        calls.append(a[2].shape)
        return orig(*a, **k)
    monkeypatch.setattr(xlstm, "_slstm_counted", counted)
    return calls


def _close(got, want, tol):
    return abs(got / want - 1) <= tol


@pytest.mark.parametrize("kind,block", [("train", xlstm.COUNT_BLOCK),
                                        ("prefill", 4)])
def test_cell_counts_equal_the_stepwise_loop(kind, block, stepwise,
                                             stand_in_calls, monkeypatch):
    """``run_cell`` at S = 32 on a fake (2, 2) mesh, the sLSTM on its
    local shards under ``local_map``: the same flops and collective bytes
    as the stepwise trace, by kind; bytes and peak within tolerance.
    Without a backward the loop's peak holds one step's temporaries, so
    there the body's blocks are cut to 4 steps, an eighth of S, as the
    default 512 is a small part of a full-width S (4096 or 32768)."""
    monkeypatch.setattr(xlstm, "COUNT_BLOCK", block)
    shape = ShapeConfig(f"{kind}_small", 32, 8, kind)
    run = lambda: dryrun.run_cell("xlstm_1_3b", shape.name, False,
                                  accum=1, mesh_shape=(2, 2), cfg=CFG,
                                  shape=shape)
    batched = run()
    assert stand_in_calls, "the stand-in never ran"
    n_calls = len(stand_in_calls)
    stepwise()
    loop = run()
    assert len(stand_in_calls) == n_calls
    assert batched["status"] == loop["status"] == "ok"
    assert batched["flops"] == loop["flops"] > 0
    assert batched["collectives"] == loop["collectives"]
    assert loop["collectives"]["total"] > 0
    assert _close(batched["bytes_accessed"], loop["bytes_accessed"],
                  BYTES_TOL), (batched["bytes_accessed"],
                               loop["bytes_accessed"])
    assert _close(batched["memory"]["peak_bytes"],
                  loop["memory"]["peak_bytes"], PEAK_TOL)
    assert batched["memory"]["argument_bytes"] == \
        loop["memory"]["argument_bytes"]


def _slstm_counts(S, grad, B=2):
    """apply_slstm alone, forward and (with ``grad``) backward, counted."""
    d, h = CFG.d_model, CFG.n_heads
    counter = op_analysis.OpCounter()
    with counter.counting():
        p = {"wx": torch.empty(d, 4 * d), "r": torch.empty(4, h, d // h,
                                                          d // h),
             "b": torch.empty(4 * d), "mlp_up": torch.empty(d, 256),
             "mlp_down": torch.empty(128, d), "gn": torch.empty(d)}
        x = torch.empty(B, S, d)
        for t in (*p.values(), x):
            t.requires_grad_(grad)
        counter.reset()
        for t in (*p.values(), x):
            counter.track(t)
        with torch.set_grad_enabled(grad):
            y = xlstm.apply_slstm(CFG, p, x)
            if grad:
                torch.autograd.grad(y, [x, *p.values()], torch.empty_like(y))
    return counter.flops, counter.bytes, counter.peak_bytes


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("S", [2, 9, 32, 33])
def test_slstm_alone_counts_equal_the_stepwise_loop(S, grad, stepwise,
                                                    monkeypatch):
    """Where the sLSTM makes the peak: S = 2 is the smallest the stand-in
    takes, the others lie beyond the probes' 3, 4 and 5 steps, and 33 in
    blocks of 8 ends in a block of one step.  Without a backward, blocks
    of an eighth of S (as in the prefill cell above)."""
    block = xlstm.COUNT_BLOCK if grad else max(2, S // 8)
    monkeypatch.setattr(xlstm, "COUNT_BLOCK", 8 if S == 33 and grad
                        else block)
    flops, nbytes, peak = _slstm_counts(S, grad)
    stepwise()
    lflops, lbytes, lpeak = _slstm_counts(S, grad)
    assert flops == lflops > 0
    assert _close(nbytes, lbytes, BYTES_TOL), (nbytes, lbytes)
    assert _close(peak, lpeak, PEAK_TOL), (peak, lpeak)


def test_a_real_forward_never_takes_the_stand_in(monkeypatch):
    """Real tensors on the CPU take the loop, also while a counter counts
    elsewhere, and their values are the loop's."""
    def refuse(*a, **k):
        raise AssertionError("the stand-in ran on real tensors")
    gen = torch.Generator().manual_seed(0)
    d, h = CFG.d_model, CFG.n_heads
    p = {"wx": torch.randn(d, 4 * d, generator=gen) * 0.1,
         "r": torch.randn(4, h, d // h, d // h, generator=gen) * 0.02,
         "b": torch.zeros(4 * d), "mlp_up": torch.randn(d, 256,
                                                        generator=gen),
         "mlp_down": torch.randn(128, d, generator=gen),
         "gn": torch.ones(d)}
    x = torch.randn(2, 6, d, generator=gen)
    want = xlstm.apply_slstm(CFG, p, x)
    monkeypatch.setattr(xlstm, "_slstm_counted", refuse)
    assert not op_analysis.counting_active(x)
    with op_analysis.OpCounter().counting():
        assert op_analysis.counting_active()
        assert not op_analysis.counting_active(x)
    got = xlstm.apply_slstm(CFG, p, x)
    assert torch.equal(got, want) and torch.isfinite(got).all()
    assert not op_analysis.counting_active()
