"""The dry-run's pieces against the JAX package's: the abstract inputs
(``launch.specs``) for every arch and supported shape, the op analyzer
(``launch.op_analysis``) on the reference analyzer's four closed forms,
and ``run_cell`` on a fake process group of 8 against the reference's
lower-and-compile on 8 host devices, at the reduced Qwen3-8B and
Llama-4 Maverick on a ``(2, 4)`` and a ``(1, 1)`` mesh."""
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch.specs import input_shardings as jinput_shardings
from repro.launch.specs import input_specs as jinput_specs
from repro.models.lm import build_model as jbuild_model
from repro_torch.configs import ARCH_IDS, get_config, supported_shapes
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import OpCounter, analyze
from repro_torch.launch.specs import input_shardings, input_specs
from repro_torch.models.lm import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeMesh:
    def __init__(self, **sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def _jflat(tree, leaf_type):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, leaf_type))
    return [("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path), x) for path, x in flat]


def _pflat(tree):
    return [(shd._path_str(p), x) for p, x in shd.flatten_with_path(tree)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_shardings_equal_the_references(arch):
    cfg = get_config(arch)
    model, jm = build_model(cfg), jbuild_model(jget_config(arch))
    jmesh = jax.sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    mesh = FakeMesh(pod=2, data=16, model=16)
    for name in JSHAPES:
        if supported_shapes(cfg)[name] != "run":
            continue
        kind, ab = input_specs(model, name)
        jkind, jab = jinput_specs(jm, name)
        assert kind == jkind
        got = _pflat(ab)
        want = _jflat(jab, jax.ShapeDtypeStruct)
        assert [p for p, _ in got] == [p for p, _ in want], name
        for (path, t), (_, s) in zip(got, want):
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(s.shape), (name, path)
            assert str(t.dtype).removeprefix("torch.") == str(s.dtype), \
                (name, path)
        specs = input_shardings(model, name, mesh, ab)
        jspecs = jinput_shardings(jm, name, jmesh, jab)
        got = _pflat(specs)
        want = _jflat(jspecs, jax.sharding.NamedSharding)
        assert [p for p, _ in got] == [p for p, _ in want], name
        for (path, a), (_, b) in zip(got, want):
            assert tuple(a) == tuple(b.spec), (name, path)


# ---------------------------------------------------------------------------
# the op analyzer on the reference analyzer's closed forms
# (tests/test_hlo_analysis.py), written in PyTorch
# ---------------------------------------------------------------------------

D = 2 * 512 ** 3


def _flat(w, x):
    for _ in range(10):
        x = torch.tanh(x @ w)
    return (x @ w).sum()


def _nested(w, x):          # 3 x 5 dots
    for _ in range(3):
        for _ in range(5):
            x = x @ w
    return x.sum()


def _remat_grad(w, x):      # 10 fwd + 10 recompute + 20 bwd
    from torch.utils.checkpoint import checkpoint
    w = w.requires_grad_(True)
    y = x
    for _ in range(10):
        y = checkpoint(lambda y: torch.tanh(y @ w), y, use_reentrant=False)
    return torch.autograd.grad((y ** 2).sum(), w)


@pytest.mark.parametrize("fn,dots", [(_flat, 11), (_nested, 15),
                                     (_remat_grad, 40)])
def test_analyzer_on_closed_forms(fn, dots):
    w, x = torch.empty(512, 512), torch.empty(512, 512)
    res = analyze(fn, w, x)
    # the remat probe's first step needs no input gradient: 39 of 40
    assert abs(res["flops"] / (dots * D) - 1) <= 0.05
    assert res["collectives"] == {"total": 0}
    assert res["bytes"] > 0


def test_analyzer_counts_per_device_on_a_sharded_probe():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor
    with dryrun.fake_process_group(8):
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("d",))
        counter = OpCounter()
        with counter:
            w = distribute_tensor(torch.empty(512, 512), mesh, [Shard(1)])
            x = distribute_tensor(torch.empty(512, 512), mesh, [Shard(0)])
        res = analyze(_flat, w, x, counter=counter)
    assert abs(res["flops"] / (11 * D / 8) - 1) <= 0.05
    assert res["collectives"]["total"] > 0
    assert res["top_collectives"][0]["bytes"] > 0


# ---------------------------------------------------------------------------
# run_cell against the reference's lower-and-compile
# ---------------------------------------------------------------------------

SMALL = ShapeConfig("train_small", 64, 16, "train")
ACCUM = 4

_REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
sys.path.insert(0, "src")
import jax
from repro.configs import get_config
from repro.configs.base import SHAPES, ShapeConfig
from repro.distributed import sharding as shd
from repro.launch import hlo_analysis
from repro.launch.specs import input_shardings, input_specs
from repro.models import compute
from repro.models.lm import build_model
from repro.optim.adamw import AdamWConfig
from repro.train.steps import make_train_step
arch, S, B, accum = sys.argv[1], *map(int, sys.argv[2:5])
SHAPES["train_small"] = ShapeConfig("train_small", S, B, "train")
out = {}
for dims in ((2, 4), (1, 1)):
    mesh = jax.make_mesh(dims, ("data", "model"),
                         devices=jax.devices()[:dims[0] * dims[1]],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    model = build_model(get_config(arch).reduced())
    opt = AdamWConfig()
    kind, abstract = input_specs(model, "train_small", opt)
    sh = input_shardings(model, "train_small", mesh, abstract)
    fn = make_train_step(model, opt, accum=accum, mb_specs=shd.batch_specs(
        model.cfg, SHAPES["train_small"], mesh))
    with mesh, compute.sharding_hints(dp=shd.dp_axes(mesh), tp="model"):
        c = jax.jit(fn, in_shardings=sh, out_shardings=(sh[0], None),
                    donate_argnums=(0,)).lower(*abstract).compile()
    ana = hlo_analysis.analyze(c.as_text())
    out["x".join(map(str, dims))] = {
        "argument_bytes": int(c.memory_analysis().argument_size_in_bytes),
        "flops": ana["flops"], "collectives": ana["collectives"]["total"]}
print(json.dumps(out))
"""


def _reference_cells(arch):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REF, arch,
                        str(SMALL.seq_len), str(SMALL.global_batch),
                        str(ACCUM)], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=110)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ["qwen3_8b", "llama4_maverick_400b"])
def test_run_cell_against_the_references_compile(arch):
    """``argument_bytes`` equal; per-device flops within 5% of the
    reference's.  Llama-4's MoE is the exception: the port splits every
    expert product over both mesh axes, where GSPMD repeats part of the
    layer's dot work over the data axis (its (2, 4) count times 8 is
    7.6% above its (1, 1) count), so there the port is held to the
    reference's (1, 1) count over 8 and to at most its (2, 4) count.
    ``bytes`` is not compared: the port's is un-fused eager traffic,
    the reference's XLA's post-fusion figure."""
    want = _reference_cells(arch)
    cfg = get_config(arch).reduced()
    for dims in ((2, 4), (1, 1)):
        name = "x".join(map(str, dims))
        got = dryrun.run_cell(arch, SMALL.name, False, accum=ACCUM,
                              mesh_shape=dims, cfg=cfg, shape=SMALL)
        assert got["status"] == "ok" and got["kind"] == "train"
        assert got["mesh"] == name
        assert got["memory"]["argument_bytes"] == \
            want[name]["argument_bytes"], name
        mem = got["memory"]
        assert mem["peak_bytes"] == (mem["argument_bytes"]
                                     + mem["output_bytes"]
                                     + mem["temp_bytes"]
                                     - mem["alias_bytes"])
        flops, ref = got["flops"], want[name]["flops"]
        if arch == "qwen3_8b" or dims == (1, 1):
            assert abs(flops / ref - 1) <= 0.05, (name, flops, ref)
        else:
            ideal = want["1x1"]["flops"] / 8
            assert abs(flops / ideal - 1) <= 0.05, (name, flops, ideal)
            assert flops <= ref
        if dims == (1, 1):
            assert got["collectives"]["total"] == 0
            assert want[name]["collectives"] == 0
        else:
            assert got["collectives"]["total"] > 0
            assert want[name]["collectives"] > 0
    assert got["params"] == cfg.param_count()
    for key in ("compile_s", "hlo_ops", "collectives_unrolled_once"):
        assert got[key] is None


@pytest.mark.parametrize("arch", ["stablelm_3b", "qwen3_8b",
                                  "seamless_m4t_medium", "jamba_v0_1_52b"])
def test_run_cell_serves_on_a_fake_mesh(arch):
    """Prefill and decode cells: multi-head attention (heads over TP),
    GQA, the encoder-decoder at a vocab TP does not divide, and the
    recurrent mixers."""
    cfg = get_config(arch).reduced(vocab_size=250)
    for kind in ("prefill", "decode"):
        shape = ShapeConfig(f"{kind}_small", 64, 8, kind)
        res = dryrun.run_cell(arch, shape.name, False, mesh_shape=(2, 4),
                              cfg=cfg, shape=shape)
        assert res["status"] == "ok" and res["kind"] == kind
        mem = res["memory"]
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
        assert res["flops"] > 0 and res["collectives"]["total"] > 0


def test_run_cell_skips_as_the_reference_does_and_leaves_no_group():
    import torch.distributed as dist
    res = dryrun.run_cell("qwen3_8b", "long_500k", False)
    assert res["status"] == "skip"
    assert res["reason"] == supported_shapes(get_config("qwen3_8b"))[
        "long_500k"]
    assert not dist.is_initialized()


def test_dryrun_main_writes_one_json_a_cell(tmp_path):
    rc = dryrun.main(["--arch", "qwen3_8b,stablelm_3b", "--shape",
                      "long_500k", "--mesh", "both", "--out",
                      str(tmp_path)])
    assert rc == 0
    files = sorted(os.listdir(tmp_path))
    assert files == sorted(f"{m}__{a}__long_500k.json"
                           for m in ("16x16", "2x16x16")
                           for a in ("qwen3_8b", "stablelm_3b"))
    for f in files:
        with open(tmp_path / f) as fh:
            assert json.load(fh)["status"] == "skip"
