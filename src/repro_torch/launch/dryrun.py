"""Multi-pod dry-run: trace every (architecture x input shape) on the
production meshes and record memory, op and collective counts (the
counterpart of ``repro/launch/dryrun.py``, with its CLI and JSON keys).

The reference lowers and compiles each step with XLA on 512 placeholder
host devices.  The port has no compiler: it builds the mesh over a
*fake* process group of 256 or 512 ranks (the ``"fake"`` backend with a
``FakeStore``: collectives return at once), places the step's inputs as
DTensors of fake tensors (no memory), and runs the step once, as rank 0,
under the sharding hints and :mod:`repro_torch.launch.op_analysis`.
Every figure is a count on fake tensors, per device, not a measurement:

* ``memory.argument_bytes`` — the local shards of the step's inputs,
  summed exactly;
* ``memory.peak_bytes`` — the most live fake storage during the step
  (arguments included); ``output_bytes`` the outputs' local shards,
  ``alias_bytes`` those that are arguments updated in place, and
  ``temp_bytes`` the rest of the peak (``peak = argument + output +
  temp - alias``, the reference's identity);
* ``flops``, ``hlo`` and ``collectives`` — ``op_analysis``'s counts.

``compile_s``, ``memory.code_bytes``, ``hlo_ops`` and
``collectives_unrolled_once`` are XLA's and are ``null`` here: no
compiled program exists.  The fake group starts only inside
:func:`run_cell` (never at import) and is destroyed after each cell.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --out build/dryrun [--jobs 8]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, supported_shapes
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.optim.adamw import AdamWConfig


@contextlib.contextmanager
def fake_process_group(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, for
    the duration of the block.  Raises when a group is already running."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running; the "
                           "dry-run starts its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_name(mesh_shape) -> str:
    return "x".join(str(n) for n in mesh_shape)


def _placed(tree, specs, mesh, counter):
    """The fake DTensor of each ``meta`` leaf, placed by its spec."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import sharding as shd
    flat = dict(shd.flatten_with_path(specs))

    def one(path, t):
        fake = torch.empty(t.shape, dtype=t.dtype, device="cpu")
        return distribute_tensor(fake, mesh,
                                 shd.placements(mesh, flat[path]),
                                 src_data_rank=None)
    with counter:
        return shd.map_with_path(one, tree)


def _local_bytes(tree) -> int:
    from repro_torch.distributed import sharding as shd
    total = 0
    for _, t in shd.flatten_with_path(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if type(t).__name__ == "DTensor" else t
            total += t.numel() * t.element_size()
    return total


def _storages(tree) -> set:
    from repro_torch.distributed import sharding as shd
    out = set()
    for _, t in shd.flatten_with_path(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if type(t).__name__ == "DTensor" else t
            out.add(t.untyped_storage()._cdata)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             accum: int = 4, accum_dtype: str = "float32",
             fsdp: bool = True, carry_tp: bool = True, *,
             mesh_shape: Optional[tuple] = None,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None) -> dict:
    """One cell's JSON.  ``mesh_shape`` stands in for the production
    mesh (``(data, model)`` or ``(pod, data, model)``), ``cfg`` for
    ``get_config(arch)`` and ``shape`` for ``SHAPES[shape_name]``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.launch.specs import input_shardings, input_specs
    from repro_torch.models import compute
    from repro_torch.models.lm import build_model
    from repro_torch.train.steps import (make_prefill_step, make_serve_step,
                                         make_train_step)
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    sup = supported_shapes(cfg).get(shape_name, "run")
    production = mesh_shape is None
    if production:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    meta = {"arch": arch, "shape": shape_name,
            "mesh": _mesh_name(mesh_shape), "family": cfg.family,
            "params": cfg.param_count(),
            "active_params": cfg.active_param_count()}
    if sup != "run":
        return {**meta, "status": "skip", "reason": sup}

    world = 1
    for n in mesh_shape:
        world *= n
    model = build_model(cfg)
    opt_cfg = AdamWConfig()
    kind, abstract = input_specs(model, shape_name, opt_cfg, shape=shape)
    with fake_process_group(world):
        mesh = make_production_mesh(multi_pod=multi_pod) if production \
            else init_device_mesh("cpu", tuple(mesh_shape), mesh_dim_names=(
                "pod", "data", "model")[3 - len(mesh_shape):])
        specs = input_shardings(model, shape_name, mesh, abstract,
                                fsdp=fsdp, shape=shape)
        counter = OpCounter()
        if kind == "train":
            mb_specs = shd.batch_specs(cfg, shape, mesh)
            step = make_train_step(model, opt_cfg, accum=accum,
                                   mb_specs=mb_specs,
                                   accum_dtype=getattr(torch, accum_dtype))
            args = (_placed(abstract[0], specs[0], mesh, counter),
                    _placed(abstract[1], specs[1], mesh, counter))
        elif kind == "prefill":
            step = make_prefill_step(model)
            args = tuple(_placed(a, s, mesh, counter)
                         for a, s in zip(abstract, specs))
        else:
            serve = make_serve_step(model)
            # the last position of a full cache (a Python int: the port's
            # decode takes ``pos`` as one)
            step = lambda p, tok, pos, c: serve(p, tok, shape.seq_len - 1, c)
            args = tuple(_placed(a, s, mesh, counter)
                         for a, s in zip(abstract, specs))
        arg_bytes = _local_bytes(args)
        arg_storages = _storages(args)
        t0 = time.time()
        with counter.counting():
            counter.reset()
            for _, t in shd.flatten_with_path(args):
                counter.track(t)
            with compute.sharding_hints(shd.dp_axes(mesh), "model",
                                        carry_tp=carry_tp), \
                    implicit_replication(), torch.no_grad() \
                    if kind != "train" else contextlib.nullcontext():
                out = step(*args)
        t_lower = time.time() - t0
        out_bytes = _local_bytes(out)
        alias = sum(
            t.to_local().numel() * t.to_local().element_size()
            if type(t).__name__ == "DTensor" else t.numel() * t.element_size()
            for _, t in shd.flatten_with_path(out)
            if isinstance(t, torch.Tensor) and (
                t.to_local() if type(t).__name__ == "DTensor" else t
            ).untyped_storage()._cdata in arg_storages)
        ana = counter.result()
        peak = counter.peak_bytes
        del out, args
    res = {**meta, "status": "ok", "kind": kind,
           "lower_s": round(t_lower, 2), "compile_s": None,
           "accum": accum if kind == "train" else None,
           "knobs": {"accum_dtype": accum_dtype, "fsdp": fsdp,
                     "carry_tp": carry_tp}}
    res["memory"] = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                     "temp_bytes": peak - arg_bytes - out_bytes + alias,
                     "alias_bytes": alias, "code_bytes": None,
                     "peak_bytes": peak}
    res["flops"] = ana["flops"]
    res["bytes_accessed"] = ana["bytes"]
    res["hlo"] = {"flops": ana["flops"], "bytes": ana["bytes"]}
    res["collectives"] = ana["collectives"]
    res["top_collectives"] = ana["top_collectives"]
    res["collectives_unrolled_once"] = None
    res["hlo_ops"] = None
    return res


def _cell_path(out, mesh_name, arch, shape_name):
    return os.path.join(out, f"{mesh_name}__{arch}__{shape_name}.json")


def _run_and_write(arch, shape_name, multi_pod, path, args) -> str:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    try:
        res = run_cell(arch, shape_name, multi_pod, accum=args.accum,
                       accum_dtype=args.accum_dtype,
                       fsdp=not args.no_fsdp,
                       carry_tp=not args.no_carry_tp)
    except Exception:
        res = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "status": "FAIL", "error": traceback.format_exc()[-2000:]}
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    st = res["status"]
    extra = ""
    if st == "ok":
        mem = res["memory"]["peak_bytes"]
        extra = (f" trace={res['lower_s']:.0f}s "
                 f"peak={mem / 2**30:.2f}GiB "
                 f"coll={res['collectives'].get('total', 0) / 2**20:.0f}MiB")
    print(f"[done]   {mesh_name} {arch} {shape_name} -> {st}{extra}",
          flush=True)
    return st


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--accum", type=int, default=4)
    ap.add_argument("--accum-dtype", default="float32")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-carry-tp", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    todo = []
    for multi_pod in meshes:
        mesh_name = "2x16x16" if multi_pod else "16x16"
        for arch in archs:
            for shape_name in shapes:
                path = _cell_path(args.out, mesh_name, arch, shape_name)
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {mesh_name} {arch} {shape_name}")
                    continue
                todo.append((arch, shape_name, multi_pod, path))
    failures = 0
    if args.jobs <= 1:
        for arch, shape_name, multi_pod, path in todo:
            print(f"[run]    {'2x16x16' if multi_pod else '16x16'} {arch} "
                  f"{shape_name} ...", flush=True)
            failures += _run_and_write(arch, shape_name, multi_pod, path,
                                       args) == "FAIL"
    else:
        # one process a cell (a fake group a process), ``--jobs`` at once
        base = [a for a in (argv if argv is not None else sys.argv[1:])]
        base = _strip(base, ("--arch", "--shape", "--mesh", "--jobs"))
        running = []
        for arch, shape_name, multi_pod, path in todo:
            while len(running) >= args.jobs:
                running = _reap(running)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   *base, "--arch", arch, "--shape", shape_name,
                   "--mesh", "multi" if multi_pod else "single", "--force"]
            running.append(subprocess.Popen(cmd))
        while running:
            running = _reap(running)
        for *_, path in todo:
            if not os.path.exists(path):     # the cell's process died
                failures += 1
                continue
            with open(path) as f:
                failures += json.load(f)["status"] == "FAIL"
    print(f"done; {failures} failures")
    return 1 if failures else 0


def _strip(argv, flags):
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in flags:
            skip = True
            continue
        if any(a.startswith(f + "=") for f in flags):
            continue
        out.append(a)
    return out


def _reap(running):
    time.sleep(0.2)
    return [p for p in running if p.poll() is None]


if __name__ == "__main__":
    raise SystemExit(main())
