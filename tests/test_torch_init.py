"""Seed-0 weights that do not depend on the device: the port's
``WeightDraw`` (``repro_torch.models.common``), on the CPU.

Each element is a pure function of ``(seed, leaf, element index)``:
splitmix64 on int64 tensors, then a table of normal quantiles.  The card
side (CPU and CUDA inits bitwise equal) is in ``tests/test_torch_gpu.py``.
Tolerances: the mean and standard deviation of a 1 M draw within 1e-2 of
0 and 1 (their sampling error is about 1e-3).
"""
import pytest
import torch

from repro_torch.checkpoint.checkpoint import _flat
from repro_torch.configs import get_config
from repro_torch.configs.base import PORTED_ARCHS
from repro_torch.models import common
from repro_torch.models.common import WeightDraw, dense_init
from repro_torch.models.lm import build_model


def _draws(seed, n_leaves, shape=(64, 32), dtype=torch.float32):
    draw = WeightDraw(seed)
    return [dense_init(draw, shape, dtype, "cpu") for _ in range(n_leaves)]


def test_dense_init_is_a_function_of_seed_and_leaf():
    a, b = _draws(0, 3), _draws(0, 3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    other = _draws(1, 1)[0]
    assert not torch.equal(a[0], other)


def test_a_leaf_does_not_depend_on_the_chunking(monkeypatch):
    want = _draws(3, 2, shape=(1000, 7))
    monkeypatch.setattr(common, "DRAW_CHUNK", 333)
    got = _draws(3, 2, shape=(1000, 7))
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_a_million_draws_are_standard_normal():
    x = dense_init(WeightDraw(0), (1000, 1000), torch.float32, "cpu",
                   scale=1.0)
    assert abs(float(x.mean())) < 1e-2
    assert abs(float(x.std()) - 1.0) < 1e-2
    # both tails, symmetric: the table holds the quantiles at midpoints
    assert float(x.min()) < -4 and float(x.max()) > 4


def test_the_fan_in_scale_and_the_cast_are_the_references_rule():
    draw = WeightDraw(5)
    w = dense_init(draw, (256, 64), torch.bfloat16, "cpu")
    assert w.dtype == torch.bfloat16
    again = WeightDraw(5)
    f = dense_init(again, (256, 64), torch.float32, "cpu", scale=1.0)
    # one f32 product by the scale, then one rounding to bf16
    assert torch.equal(w, (f * torch.tensor(256 ** -0.5)).bfloat16())


def test_the_tensor_mix_is_the_exact_splitmix64():
    vals = [0, 1, 2, (1 << 63) - 1, (1 << 63) + 5, (1 << 64) - 1,
            0x123456789ABCDEF0]
    z = torch.tensor([common._signed(v) for v in vals], dtype=torch.int64)
    common._mix64_(z)
    assert [int(t) for t in z] == [common._signed(common._mix64(v))
                                   for v in vals]


def test_meta_allocates_shapes_only():
    w = dense_init(None, (3, 5), torch.bfloat16, "meta")
    assert w.device.type == "meta" and w.shape == (3, 5)
    params = build_model(get_config("qwen3_8b")).init(device="meta")
    assert params["embed"].device.type == "meta"
    assert params["blocks"][0]["mlp"]["wi"].shape == (36, 4096, 12288)


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_model_init_is_deterministic_and_seeded(arch):
    """Every leaf the same from one seed, every random leaf another from
    another seed."""
    model = build_model(get_config(arch).reduced())
    a, b, c = (_flat(model.init(seed=s, device="cpu")) for s in (0, 0, 1))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert all(torch.isfinite(x).all() for _, x in a)
    drawn = [(k, x, y) for (k, x), (_, y) in zip(a, c)
             if x.unique().numel() > 64]
    assert drawn and all(not torch.equal(x, y) for _, x, y in drawn)
