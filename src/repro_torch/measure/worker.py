"""Measurement worker: the subprocess end of the worker-pool transport
(the port of ``repro/measure/worker.py``, speaking its protocol).

One worker is one process with one
:class:`~repro_torch.measure.runner.MeasureRunner` and, on the card, its
own CUDA context, so a kernel that crashes, wedges or poisons the context
costs a *worker*, never the tuning process.  The parent
(:class:`~repro_torch.measure.pool.WorkerPoolTransport`) speaks
length-prefixed JSON frames over the worker's stdin and stdout:

==========  ============================================================
direction   frame
==========  ============================================================
parent →    ``{"type": "init", "runner": {...}, "factory": mod:attr|null}``
worker →    ``{"type": "ready", "backend": <runner.backend_key>}``
parent →    ``{"type": "job", "id": n, "site": {...}, "tiles": [a, b, c]}``
worker →    ``{"type": "result", "id": n, "v": seconds | null}``
parent →    ``{"type": "exit"}`` (or EOF): the worker exits 0
==========  ============================================================

``"v": null`` is a failed measurement (the parent reads ``inf``).  A
worker whose runner cannot be built answers ``{"type": "error", ...}``
instead of ``ready`` and exits (``MeasureRunner(device="cuda")`` without a
card, for one): the pool then fails to start.  On the card, ``ready``
means able to time: the kernels' libraries are loaded and the context is
up before it is sent.

A CUDA error that poisons the context (an illegal address, a device-side
assert) makes every later call in this process raise.  So after a
non-finite result in a process that has used CUDA, the worker checks its
context; if the context is dead it exits with :data:`CONTEXT_LOST`
without answering, and the pool requeues the job to a fresh worker as
after any death.  A tile the kernel refuses leaves the context alive and
is answered ``inf``.

``factory`` names a ``module:attribute`` callable returning a runner
(``(sites, tiles) -> (n,) seconds`` with ``backend_key``, and ``device``
where it runs on the card): the seam through which tests run
deterministic or crashing runners inside real workers.  The worker imports
torch only for a runner that needs it, so such a worker starts at once.

With ``REPRO_TORCH_LAUNCH_DIR`` set, the worker writes its kernel launch
counters (K1, K2 and K3, and K1's and K2's by variant) to
``<dir>/worker-<pid>.json`` after every job, so a caller can see which
kernels ran in its workers: the counters are per process.  The file also
holds what the worker's timings did with the card's lock
(:mod:`repro_torch.measure.lock`): ``timing_lock`` (acquisitions, seconds
waited and held) and ``timing_lock_spans`` (the last ``(enter, exit)``
times on the host's monotonic clock).
"""
from __future__ import annotations

import importlib
import json
import os
import sys

from repro_torch.measure import lock
from repro_torch.measure.wire import read_frame, write_frame

#: exit code of a worker whose CUDA context is dead
CONTEXT_LOST = 4
LAUNCH_DIR_ENV = "REPRO_TORCH_LAUNCH_DIR"


def _build_runner(init: dict):
    factory = init.get("factory")
    if factory:
        mod, _, attr = factory.partition(":")
        return getattr(importlib.import_module(mod), attr)()
    from repro_torch.measure.runner import MeasureRunner
    return MeasureRunner(**(init.get("runner") or {}))


def _on_card(runner) -> bool:
    dev = getattr(runner, "device", None)
    if dev is None:
        return False
    import torch
    return torch.device(dev).type == "cuda"


def _ready_card() -> None:
    """Load every kernel library and bring the context up."""
    import torch
    from repro_torch.kernels import build
    for name in build.SOURCES:
        build.load(name)
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()


def _context_alive() -> bool:
    """False when this process's CUDA context no longer runs work."""
    torch = sys.modules.get("torch")    # not imported: CUDA never used
    if torch is None or not torch.cuda.is_initialized():
        return True
    try:
        torch.cuda.synchronize()
        x = torch.ones(1, device="cuda").add_(1)
        return float(x.item()) == 2.0
    except Exception:
        return False


def _write_launches(launch_dir: str) -> None:
    from repro_torch.kernels import chunk_scan, flash_attention, matmul
    counts = {"matmul": matmul.launches,
              "flash_attention": flash_attention.launches,
              "chunk_scan": chunk_scan.launches,
              "matmul_by_variant": dict(matmul.launches_by_variant),
              "matmul_by_layout": dict(matmul.launches_by_layout),
              "flash_attention_by_variant":
                  dict(flash_attention.launches_by_variant),
              "timing_lock": lock.stats.as_dict(),
              "timing_lock_spans": [list(s) for s in lock.stats.spans]}
    path = os.path.join(launch_dir, f"worker-{os.getpid()}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(counts, f)
    os.replace(path + ".tmp", path)


def _site(d: dict):
    from repro_torch.models.site import KernelSite
    return KernelSite(**d)


def main() -> int:
    # the protocol owns fd 1: stray prints (torch warnings, nvcc, user
    # runners) go to stderr and can never tear a frame
    proto_out = os.fdopen(os.dup(1), "wb")
    # advertised so a fault-injecting runner (faults.ChaosRunner) can tear
    # a result frame
    os.environ["REPRO_WORKER_PROTO_FD"] = str(proto_out.fileno())
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    inp = sys.stdin.buffer

    init = read_frame(inp)
    if init is None or init.get("type") != "init":
        return 2
    try:
        runner = _build_runner(init)
        if _on_card(runner):
            _ready_card()
    except Exception as e:
        write_frame(proto_out, {"type": "error",
                                "error": f"{type(e).__name__}: {e}"})
        raise
    write_frame(proto_out, {"type": "ready",
                            "backend": getattr(runner, "backend_key",
                                               "unknown")})
    launch_dir = os.environ.get(LAUNCH_DIR_ENV)

    import numpy as np
    while True:
        msg = read_frame(inp)
        if msg is None or msg.get("type") == "exit":
            return 0
        if msg.get("type") != "job":
            continue
        try:
            v = float(np.asarray(runner([_site(msg["site"])],
                                        np.asarray([msg["tiles"]],
                                                   np.int64))).reshape(-1)[0])
        except Exception:
            # a runner that raises must not kill the worker (a death costs
            # a respawn and an attempt): answer the failure marker
            v = float("inf")
        if not np.isfinite(v) and not _context_alive():
            os._exit(CONTEXT_LOST)      # the pool requeues the job
        if launch_dir:
            _write_launches(launch_dir)
        write_frame(proto_out, {"type": "result", "id": msg["id"],
                                "v": None if not np.isfinite(v) else v})


if __name__ == "__main__":
    sys.exit(main())
