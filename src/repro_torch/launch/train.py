"""Training driver: data pipeline -> train step -> checkpoints, with
fault-tolerance wiring (auto-resume, preemption checkpointing, straggler
monitor); the port of ``repro/launch/train.py``.  Runs on the GPU unless
``--device cpu`` is given::

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b \\
      --steps 50 --ckpt-dir /tmp/ckpt --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_3b \\
      --full --batch 4 --seq 512 --steps 5

Training is eager: no kernel has a backward (nor has any Pallas kernel of
the reference), so ``--tune prog.json`` injects the tile program and the
first step raises ``NotImplementedError`` (``kernels.ops.refuse_grad``),
as the reference's does.

Under a process group (``torchrun`` sets ``WORLD_SIZE``), or with
``--model-parallel`` above 1, it trains on a ``("data", "model")`` mesh
of the group's ranks (``launch.mesh.make_local_mesh``): the state is
drawn whole from the seed on every rank, then distributed as DTensors by
``distributed.sharding.param_specs``, each batch by ``batch_specs``, and
the step runs under ``compute.sharding_hints``, so a mesh of any shape
trains the weights one card does.  Checkpoints hold full tensors (rank 0
writes them), so one written on a mesh resumes on one card and the other
way round.  ``--tune`` with a mesh raises.  On one card::

  torchrun --standalone --nproc-per-node 1 -m repro_torch.launch.train \\
      --arch stablelm_3b --full --batch 4 --seq 512 --steps 5

On the card it also prints, before its last line, the median ms
of a step after the first from CUDA events (forward and backward, and
the optimizer, apart), tokens/s and the peak of
``torch.cuda.max_memory_allocated``.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import statistics
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.ft.monitor import PreemptionHandler, StepMonitor
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.steps import make_train_state, make_train_step


@dataclass
class TrainResult:
    """What one training run produced, for callers that check it."""
    losses: list
    grad_norms: list
    state: dict
    # each step's MoE losses {"lb_loss", "router_z"} (zero without MoE)
    aux: list = field(default_factory=list)
    start_step: int = 0
    # (forward + backward ms, optimizer ms) a step from CUDA events, and
    # their medians after the first step; empty and None on the CPU
    step_ms: list = field(default_factory=list)
    fwd_bwd_ms: Optional[float] = None
    optimizer_ms: Optional[float] = None
    peak_bytes: Optional[int] = None     # torch.cuda.max_memory_allocated
    mesh: Optional[object] = None        # the DeviceMesh of the mesh path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (default: the "
                         "reduced test config)")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--tune", default="",
                    help="TileProgram json from repro_torch.core.vectorizer; "
                         "routes hot ops through the tuned kernels, which "
                         "have no backward: the first step raises")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _median_step_ms(step_ms: list) -> tuple:
    """Median forward + backward and optimizer ms after the first step
    (which includes the allocator's warmup); the one step if that is all."""
    rest = step_ms[1:] or step_ms
    return (statistics.median(fb for fb, _ in rest),
            statistics.median(opt for _, opt in rest))


def wants_mesh(args) -> bool:
    """The mesh path: under a process group, or a model axis above 1."""
    return args.model_parallel > 1 or "WORLD_SIZE" in os.environ


def _distribute(tree, specs, mesh):
    """Each full leaf placed by its spec; every rank holds the same full
    tensor, so none is sent."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import sharding
    flat = dict(sharding.flatten_with_path(specs))
    return sharding.map_with_path(
        lambda path, t: distribute_tensor(
            t, mesh, sharding.placements(mesh, flat[path]),
            src_data_rank=None), tree)


def _full_state(state):
    """A state of full tensors (a collective on a mesh: every rank calls
    it)."""
    from repro_torch.distributed import sharding
    return sharding.map_with_path(
        lambda _, t: t.full_tensor() if type(t).__name__ == "DTensor"
        else t, state)


def run(args, cfg: Optional[ModelConfig] = None) -> TrainResult:
    """Train as ``args`` say; ``cfg``, when given, is the model in place
    of the one ``--arch`` and ``--full`` name (a published width at a cut
    depth, say)."""
    device = resolve_device(args.device)
    mesh, rank = None, 0
    if wants_mesh(args):
        if args.tune:
            raise NotImplementedError(
                "--tune with a mesh: the tuned kernels have no backward "
                "and no sharding rule")
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh(args.model_parallel, device)
        rank = dist.get_rank()
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    if cfg is None:
        cfg = get_config(args.arch)
        if not args.full:
            cfg = cfg.reduced()
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 10))
    pipe = SyntheticPipeline(cfg, shape, DataConfig(seed=0), device=device)
    step_fn = make_train_step(model, opt_cfg, accum=args.accum)

    state = make_train_state(model, 0, opt_cfg, device=device)
    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        state, restored = mgr.restore(state)
        if restored is not None:
            start_step = restored
            print(f"[train] resumed from step {restored}")
    hints = contextlib.nullcontext
    next_batch = pipe.batch_at
    if mesh is not None:
        from repro_torch.distributed import sharding
        from repro_torch.models.compute import sharding_hints
        state = _distribute(state, sharding.param_specs(state, mesh), mesh)
        bspecs = sharding.batch_specs(cfg, shape, mesh)
        next_batch = lambda step: _distribute(pipe.batch_at(step), bspecs,
                                              mesh)
        hints = lambda: sharding_hints(sharding.dp_axes(mesh), "model")

    def save(step, block):
        full = _full_state(state) if mesh is not None else state
        if rank == 0:
            mgr.save(full, step, block=block)

    tune_ctx = None
    if args.tune:
        from repro_torch.core.vectorizer import TileProgram, inject
        prog = TileProgram.load(args.tune)
        tune_ctx = inject(prog)
        tune_ctx.__enter__()
        print(f"[tune] injected {len(prog.tiles)} kernel-site tile choices")

    cuda = device.type == "cuda"
    marks, step_ms = {}, []

    def mark(label):
        marks[label] = torch.cuda.Event(enable_timing=True)
        marks[label].record()

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    monitor = StepMonitor()
    preempt = PreemptionHandler()
    losses, gnorms, aux = [], [], []
    try:
        for step in range(start_step, args.steps):
            batch = next_batch(step)
            monitor.start()
            with hints():
                state, metrics = step_fn(state, batch,
                                         mark if cuda else None)
            loss = float(metrics["loss"])
            ev = monitor.stop(step)
            losses.append(loss)
            gnorms.append(float(metrics["grad_norm"]))
            aux.append({k: float(metrics[k])
                        for k in ("lb_loss", "router_z")})
            if cuda:
                marks["end"].synchronize()
                step_ms.append((marks["start"].elapsed_time(marks["grads"]),
                                marks["grads"].elapsed_time(marks["end"])))
            if ev:
                print(f"[ft] straggler flagged: {ev}")
            if step % 10 == 0 or step == args.steps - 1:
                moe = (f"lb_loss {aux[-1]['lb_loss']:.4f} router_z "
                       f"{aux[-1]['router_z']:.4f} " if cfg.n_experts
                       else "")
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {gnorms[-1]:.3f} {moe}"
                      f"lr {float(metrics['lr']):.2e}")
            if mgr and ((step + 1) % args.ckpt_every == 0):
                save(step + 1, block=False)
            if preempt.should_stop:
                print("[ft] preemption signal — checkpointing and exiting")
                if mgr:
                    save(step + 1, block=True)
                break
        if mgr:
            mgr.wait()
    finally:
        preempt.restore()
        if tune_ctx is not None:
            tune_ctx.__exit__(None, None, None)
    peak = fb = opt = None
    if cuda:
        peak = torch.cuda.max_memory_allocated(device)
        if step_ms:
            fb, opt = _median_step_ms(step_ms)
            tok_s = args.batch * args.seq / ((fb + opt) / 1e3)
            print(f"[train] ms a step (CUDA events, median of "
                  f"{max(1, len(step_ms) - 1)} after the first): forward+"
                  f"backward {fb:.2f}, optimizer {opt:.2f}, total "
                  f"{fb + opt:.2f}; {tok_s:.0f} tokens/s; peak memory "
                  f"{peak / 2**30:.2f} GiB "
                  f"(torch.cuda.max_memory_allocated)")
    print(f"[train] done: first loss {losses[0]:.4f} -> last "
          f"{losses[-1]:.4f}")
    return TrainResult(losses=losses, grad_norms=gnorms, state=state,
                       aux=aux, start_step=start_step, step_ms=step_ms,
                       fwd_bwd_ms=fb, optimizer_ms=opt, peak_bytes=peak,
                       mesh=mesh)


def main(argv=None) -> list:
    """The reference's entry point: the losses of the steps run."""
    return run(parse_args(argv)).losses


if __name__ == "__main__":
    main()
