"""The port's config helpers and sharding rules against the JAX
package's, bitwise: parameter counts and shape support for all ten archs,
and ``param_specs``, ``batch_specs`` and ``cache_specs`` leaf for leaf,
at the reduced config and at full size, with no mesh, on the production
``{data: 16, model: 16}`` and ``{pod: 2, data: 16, model: 16}`` meshes
(their axis sizes only: no device is needed) and with ``fsdp=False``.
The port's trees are built on ``meta``; the reference's come from
``jax.eval_shape``."""
import jax
import pytest

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import supported_shapes as jsupported_shapes
from repro.distributed import sharding as jshd
from repro.models.lm import build_model as jbuild_model
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.steps import make_train_state as jmake_train_state
from repro_torch.configs import (ARCH_IDS, PORTED_ARCHS, SHAPES, all_configs,
                                 get_config, supported_shapes)
from repro_torch.distributed import sharding as shd
from repro_torch.models.common import torch_dtype
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import make_train_state


class FakeMesh:
    """Axis sizes and names, as the rules read a mesh (both packages)."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


MESHES = {"none": None,
          "16x16": FakeMesh(data=16, model=16),
          "2x16x16": FakeMesh(pod=2, data=16, model=16)}


def test_arch_ids_are_the_references():
    assert ARCH_IDS == JARCH_IDS == PORTED_ARCHS
    assert list(all_configs()) == list(ARCH_IDS)
    assert list(SHAPES) == list(JSHAPES)


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_config_helpers_equal_the_references(arch):
    for size in ("full", "reduced"):
        cfg, ref = get_config(arch), jget_config(arch)
        if size == "reduced":
            cfg, ref = cfg.reduced(), ref.reduced()
        for name in ("d_head_total", "d_kv_total", "attention_free",
                     "subquadratic", "n_periods"):
            assert getattr(cfg, name) == getattr(ref, name), (size, name)
        assert cfg.param_count() == ref.param_count()
        assert cfg.active_param_count() == ref.active_param_count()
        assert supported_shapes(cfg) == jsupported_shapes(ref)


def test_param_counts_match_published():
    """The reference's published-count cases, on the port."""
    expect = {"starcoder2_7b": 7.4e9, "qwen3_8b": 8.2e9,
              "deepseek_v2_236b": 239e9, "llama4_maverick_400b": 401e9,
              "jamba_v0_1_52b": 51e9}
    for arch, n in expect.items():
        got = get_config(arch).param_count()
        assert abs(got - n) / n < 0.05, (arch, got, n)
    active = {"deepseek_v2_236b": 21.4e9, "llama4_maverick_400b": 17.2e9,
              "jamba_v0_1_52b": 12e9}
    for arch, n in active.items():
        got = get_config(arch).active_param_count()
        assert abs(got - n) / n < 0.05, (arch, got, n)


def test_supported_shapes_policy():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        sup = supported_shapes(cfg)
        assert sup["train_4k"] == "run"
        if cfg.family in ("ssm", "hybrid"):
            assert sup["long_500k"] == "run"
        else:
            assert sup["long_500k"].startswith("SKIP")


def _jflat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [(jshd._path_str(p), x) for p, x in flat]


def _pflat(tree):
    return [(shd._path_str(p), x) for p, x in shd.flatten_with_path(tree)]


def _assert_specs_equal(port, ref):
    port, ref = _pflat(port), _jflat(ref)
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(port, ref):
        assert tuple(a) == tuple(b), path


_STATES = {}


def _states(arch, size):
    """(port state on meta, reference state from jax.eval_shape)."""
    key = (arch, size)
    if key not in _STATES:
        cfg, ref = get_config(arch), jget_config(arch)
        if size == "reduced":
            cfg, ref = cfg.reduced(), ref.reduced()
        port = make_train_state(build_model(cfg), 0, AdamWConfig(),
                                device="meta")
        jm = jbuild_model(ref)
        want = jax.eval_shape(
            lambda k: jmake_train_state(jm, k, JAdamWConfig()),
            jax.random.PRNGKey(0))
        _STATES[key] = (port, want)
    return _STATES[key]


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", JARCH_IDS)
def test_param_specs_equal_the_references(arch, size):
    port, ref = _states(arch, size)
    for mesh in MESHES.values():
        for fsdp in (True, False):
            for part in ("params", "opt"):
                _assert_specs_equal(
                    shd.param_specs(port[part], mesh, fsdp=fsdp),
                    jshd.param_specs(ref[part], mesh, fsdp=fsdp))


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_batch_and_cache_specs_equal_the_references(arch):
    cfg, ref = get_config(arch), jget_config(arch)
    model, jm = build_model(cfg), jbuild_model(ref)
    for name, shape in SHAPES.items():
        if supported_shapes(cfg)[name] != "run":
            continue
        for mesh in (MESHES["16x16"], MESHES["2x16x16"]):
            assert shd.batch_specs(cfg, shape, mesh) == \
                {k: tuple(v) for k, v in
                 jshd.batch_specs(ref, JSHAPES[name], mesh).items()}
            if shape.kind == "train":
                continue
            cache = model.make_cache(shape.global_batch, shape.seq_len,
                                     torch_dtype(cfg.dtype), device="meta")
            jcache = jax.eval_shape(lambda: jm.make_cache(
                shape.global_batch, shape.seq_len, jax.numpy.dtype(
                    ref.dtype)))
            _assert_specs_equal(
                shd.cache_specs(cfg, shape, mesh, cache),
                jshd.cache_specs(ref, JSHAPES[name], mesh, jcache))


def test_fit_spec_drops_indivisible_axes():
    """The reference's ``_fit_spec`` case."""
    mesh = {"model": 16, "data": 16}
    assert shd._fit_spec(shd.P(None, "model"), (4, 85), mesh) == (None, None)
    assert shd._fit_spec(shd.P("data", "model"), (32, 512), mesh) == \
        ("data", "model")
    assert shd._fit_spec(shd.P(("pod", "data"), None), (64, 3),
                         {"pod": 2, "data": 16}) == (("pod", "data"), None)
    assert shd._fit_spec(shd.P(("pod", "data"), None), (16, 3),
                         {"pod": 2, "data": 16}) == (None, None)


def test_placements_shard_a_dim_over_each_of_its_axes():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh(pod=2, data=16, model=16)
    assert shd.placements(mesh, shd.P(("pod", "data"), None, "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert shd.placements(mesh, shd.P(None, "data")) == \
        [Replicate(), Shard(1), Replicate()]
    assert shd.placements(mesh, shd.P()) == [Replicate()] * 3
    assert shd.dp_axes(mesh) == ("pod", "data")
    assert shd.dp_axes({"data": 4, "model": 2}) == ("data",)
