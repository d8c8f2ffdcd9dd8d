"""The plain reference against the program, the lower-precision control
against the limit, and a run with its timed path broken underneath."""
import dataclasses

import pytest
import torch

from perfbench import harness, reference, weights
from perfbench.spec import spec_from_config
from perfbench.tests.conftest import TINY_GQA, TINY_LIMITS, TINY_MLA, \
    TINY_TRAFFIC, make_root

SEED = 2 ** 31 + 17
CONFIGS = {"gqa": TINY_GQA, "mla": TINY_MLA}


def _program(cfg: dict, dtype: str):
    from repro_torch.models.lm import build_model
    cell = harness.Cell("t", 1, dict(cfg, torch_dtype=dtype), "t",
                        TINY_TRAFFIC, spec_from_config(cfg))
    kind = harness.load_module(harness.ROOT / "perfbench" / "kinds"
                               / "prefill.py")
    return cell, build_model(kind.port_config(cell))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_is_the_programs_eager_prefill_in_f32(name):
    """At f32 the program's eager prefill and the reference agree to the
    summation order: every layer's mathematics is the same."""
    cell, model = _program(CONFIGS[name], "float32")
    g = weights.generator(SEED, "cpu")
    params = weights.draw_params(model.init(device="meta"), g, "cpu")
    tokens = torch.randint(0, cell.spec.vocab, (2, 64), generator=g)
    cache = model.make_cache(2, 64, device="cpu")
    with torch.inference_mode():
        out, _ = model.prefill(params, {"tokens": tokens}, cache)
    ref = reference.prefill_logits(cell.spec, params, tokens)
    assert float(reference.rel_err(out, ref).max()) < 2e-5


def _tiny_root(tmp_path, limits):
    cfgs = {f"tiny_{k}": dict(v, limits=limits[k])
            for k, v in CONFIGS.items()}
    return make_root(tmp_path, cfgs, {"tiny": TINY_TRAFFIC},
                     [(f"tiny_{k}.tiny", f"tiny_{k}", "tiny")
                      for k in CONFIGS])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_control_fails_the_limit_the_program_passes(tmp_path, name):
    """The reference in float8 e4m3 in the program's place fails a limit;
    the program's bf16 prefill passes every one."""
    root = _tiny_root(tmp_path, TINY_LIMITS)
    cell = harness.load_cell(harness.load_manifest(root), f"tiny_{name}.tiny",
                             root)
    kind = harness.load_module(root / "perfbench" / "kinds" / "prefill.py")
    model = kind.build(cell)
    from repro_torch.core.vectorizer import inject
    prog, _, _ = kind.tune(cell, model, "cpu")
    for seed in (SEED, SEED + 1, SEED + 2):
        params, prompts = kind.draw(cell, model, seed, torch.device("cpu"))
        prefill = kind.Prefill(cell, model, params, prompts,
                               torch.device("cpu"))
        idx = range(int(cell.traffic["pool"]))
        with torch.inference_mode(), inject(prog):
            outs = {i: [prefill(i)] for i in idx}
        ok = kind.judge(cell, kind.errors(cell, params, prompts, outs))
        assert all(v <= lim for v, lim in ok.values())
        ctl = {i: [reference.prefill_logits(cell.spec, params, prompts[i],
                                            quant="fp8")] for i in idx}
        bad = kind.judge(cell, kind.errors(cell, params, prompts, ctl))
        assert any(v > lim for v, lim in bad.values())


def _broken(fault):
    """``make_prefill_step`` with the step broken by ``fault``."""
    from repro_torch.train import steps
    make = steps.make_prefill_step

    def make_broken(model):
        step = make(model)
        first = {}

        def broken(params, batch, cache):
            tokens = batch["tokens"]
            if fault == "unchanged":    # returns what it returned first
                if "out" not in first:
                    first["out"] = step(params, batch, cache)
                return first["out"]
            if fault == "half_batch":   # half the rows, copied over the rest
                h = tokens.shape[0] // 2
                half = {"caches": tuple(
                    {k: v[:, :h] for k, v in slot.items()}
                    for slot in cache["caches"])}
                out, _ = step(params, {"tokens": tokens[:h]}, half)
                return torch.cat([out, out]), cache
            if fault == "token_altered":  # each prompt's last token
                tokens = tokens.clone()
                tokens[:, -1] = (tokens[:, -1] + 1) % model.cfg.vocab_size
                return step(params, {"tokens": tokens}, cache)
            raise ValueError(fault)
        return broken
    return make_broken


# one chip: no exchange between chips to leave out
@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "token_altered"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, name,
                                            fault):
    from repro_torch.train import steps
    root = _tiny_root(tmp_path, TINY_LIMITS)
    ok = harness.run(f"tiny_{name}.tiny", SEED, 0.3, False, device="cpu",
                     root=root)
    assert ok["correct"] is True
    monkeypatch.setattr(steps, "make_prefill_step", _broken(fault))
    res = harness.run(f"tiny_{name}.tiny", SEED, 0.3, False, device="cpu",
                      root=root)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_capacity_and_slot_major_routing():
    """The reference's MoE rule by hand: 8 tokens, 2 experts, top 2,
    capacity 8; every token's slot 0 before any slot 1."""
    spec = dataclasses.replace(spec_from_config(TINY_MLA), n_experts=2,
                               top_k=2, capacity_factor=1.0)
    assert reference.capacity(spec, 8) == 8
    assert reference.capacity(spec, 100) == 104
    logits = torch.tensor([[2.0, 0.0]] * 8)
    experts, gates, kept = reference.route(spec, logits)
    assert experts[:, 0].tolist() == [0] * 8 and kept.all()
    spec = dataclasses.replace(spec, n_experts=4, top_k=1)
    logits = torch.zeros(40, 4)
    logits[:, 1] = 1.0                  # all 40 tokens choose expert 1
    experts, gates, kept = reference.route(spec, logits)
    assert reference.capacity(spec, 40) == 16
    assert kept[:, 0].tolist() == [True] * 16 + [False] * 24
    assert torch.allclose(gates, torch.ones_like(gates))
