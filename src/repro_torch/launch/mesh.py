"""Device meshes (the port of ``repro/launch/mesh.py``).

Functions, not module-level constants, so importing this module touches
no device and starts no process group.  A mesh's axes are named as the
reference's: ``("data", "model")``, and ``("pod", "data", "model")`` for
two pods.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's ``(16, 16)`` or ``(2, 16, 16)`` mesh over the ranks
    of the running process group, which must have 256 or 512 of them (the
    dry-run starts a fake group of that size; its tensors are fake, on
    the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def init_local_group(device) -> None:
    """Start the process group this process runs under, if none is
    running: from ``torchrun``'s environment (``WORLD_SIZE`` and the
    rest) where it is set, else a group of this one rank.  NCCL on a
    card, gloo on the CPU; a rank's card is ``LOCAL_RANK``'s."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_local_mesh(model_parallel: int = 1, device="cuda"):
    """A ``("data", "model")`` mesh over the ranks of the running process
    group, ``model_parallel`` of them on the model axis; a group of one
    rank is started when none is running (:func:`init_local_group`)."""
    from torch.distributed.device_mesh import init_device_mesh
    device = torch.device(device)
    n = dist.get_world_size() if dist.is_initialized() else int(
        os.environ.get("WORLD_SIZE", 1))
    if n % model_parallel:
        raise ValueError(f"--model-parallel {model_parallel} does not "
                         f"divide the {n} ranks")
    init_local_group(device)
    return init_device_mesh(device.type, (n // model_parallel,
                                          model_parallel),
                            mesh_dim_names=("data", "model"))
