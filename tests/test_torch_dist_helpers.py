"""Process launching for the port's multi-process tests (no tests here).

``run_ranks(target, world, *args)`` starts ``world`` processes with
``torchrun``'s environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` on a free localhost port), each calling
``target(rank, *args)``, and returns their results in rank order.  A
process that is not done within ``timeout`` seconds is killed and the
call raises, so a hang fails the test instead of stalling the suite.
The processes are spawned and take this file's imports only; each
imports torch and the port itself.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import socket
import traceback


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(target, rank, world, port, args, queue):
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    try:
        import torch
        torch.set_num_threads(1)
        out = target(rank, *args)
        queue.put((rank, "ok", out))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(target, world: int, *args, timeout: float = 100.0) -> list:
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry,
                         args=(target, r, world, port, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in range(world):
            rank, status, out = queue.get(timeout=timeout)
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------------------
# targets (module-level, so that spawned processes can import them)
# ---------------------------------------------------------------------------

def train_target(rank, argv, cfg_overrides):
    """The train driver on this rank's slice of the mesh; returns the
    losses, grad norms and (rank 0) every leaf of the final state as
    numpy arrays, keyed by path."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import train
    args = train.parse_args(argv)
    cfg = None
    if cfg_overrides is not None:
        from repro_torch.configs import get_config
        cfg = get_config(args.arch).reduced(**cfg_overrides)
    res = train.run(args, cfg=cfg)
    full = train._full_state(res.state)
    leaves = {sharding._path_str(p): t.detach().float().numpy()
              for p, t in sharding.flatten_with_path(full)} \
        if rank == 0 else None
    return {"losses": res.losses, "grad_norms": res.grad_norms,
            "leaves": leaves,
            "mesh": None if res.mesh is None else tuple(
                res.mesh.mesh_dim_names)}


def psum_target(rank, xs):
    """``compressed_psum`` of ``xs[rank]`` over a ``(world, 1)`` mesh."""
    import torch
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(1, device="cpu")
    return compressed_psum(torch.as_tensor(xs[rank]), mesh).numpy()
