"""Fleet daemons: ``python -m repro_torch.fleet serve-worker|serve-artifacts``.

Each subcommand binds, prints one flushed ``ready`` line with the bound
address (``--port 0`` picks an ephemeral port: read it from the line),
then serves until SIGINT or SIGTERM and drains.

    # a measurement host: a local pool of 2 subprocess workers on the card
    python -m repro_torch.fleet serve-worker --port 7761 \\
        --transport pool --workers 2 --reps 3

    # the shared artifact service, with keep-3 versioned snapshots
    python -m repro_torch.fleet serve-artifacts --port 7762 \\
        --measure-db /data/measure.jsonl \\
        --program-store /data/programs.jsonl \\
        --versions-dir /data/versions --keep 3

``serve-worker``'s runner options are the port's (``--reps``, ``--warmup``,
``--device``, default ``cuda``, and the reference's shape caps
``--max-dim`` and ``--max-batch``); a runner that asks for the card where
there is none fails to start.
"""
import argparse
import signal
import sys
import threading


def _serve(server, what: str) -> int:
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    server.start()
    print(f"[fleet] {what} ready on {server.address}", flush=True)
    stop.wait()
    print(f"[fleet] {what} on {server.address}: draining", flush=True)
    server.close()
    return 0


def _serve_worker(args) -> int:
    from repro_torch.fleet.worker_server import MeasureServer
    from repro_torch.measure import (InProcessTransport, WorkerPoolTransport,
                                     make_transport)

    if args.factory:
        # the test seam, as the pool's: a "module:attr" runner factory
        if args.transport == "pool":
            transport = WorkerPoolTransport(workers=args.workers,
                                            factory=args.factory)
        else:
            import importlib
            mod, _, attr = args.factory.partition(":")
            transport = InProcessTransport(
                getattr(importlib.import_module(mod), attr)())
    else:
        caps = {k: v for k, v in (("max_dim", args.max_dim),
                                  ("max_batch", args.max_batch))
                if v is not None}
        transport = make_transport(
            args.transport,
            workers=args.workers if args.transport == "pool" else None,
            reps=args.reps, warmup=args.warmup, device=args.device, **caps)
    server = MeasureServer(transport, host=args.host, port=args.port)
    print(f"[fleet] serve-worker: transport={args.transport} "
          f"slots={server.slots} backend={transport.backend_key}",
          flush=True)
    try:
        return _serve(server, "serve-worker")
    finally:
        transport.close()


def _serve_artifacts(args) -> int:
    from repro_torch.fleet.artifacts import ArtifactServer

    server = ArtifactServer(
        measure_db=args.measure_db, program_store=args.program_store,
        host=args.host, port=args.port, versions_dir=args.versions_dir,
        keep_n=args.keep, snapshot_every=args.snapshot_every)
    print(f"[fleet] serve-artifacts: stores={','.join(server.stores)}"
          + (f" versions={args.versions_dir} keep={args.keep}"
             if args.versions_dir else ""), flush=True)
    return _serve(server, "serve-artifacts")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.fleet",
                                 description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    w = sub.add_parser("serve-worker",
                       help="serve local measurements to fleet clients")
    w.add_argument("--host", default="0.0.0.0")
    w.add_argument("--port", type=int, default=7761,
                   help="0 = ephemeral (printed in the ready line)")
    w.add_argument("--transport", choices=("inproc", "pool"),
                   default="pool", help="the local transport to front")
    w.add_argument("--workers", type=int, default=2,
                   help="pool size when --transport pool")
    w.add_argument("--reps", type=int, default=1,
                   help="timing repetitions per (site, tile) pair")
    w.add_argument("--warmup", type=int, default=1)
    w.add_argument("--device", default="cuda",
                   help="where the runner measures: cuda (default) or cpu")
    w.add_argument("--max-dim", type=int, default=None,
                   help="cap every site dimension (0: none; default: "
                        "the device's, none on the card, 128 on the CPU)")
    w.add_argument("--max-batch", type=int, default=None,
                   help="cap the batch dimension (0: none; default: "
                        "the device's, none on the card, 2 on the CPU)")
    w.add_argument("--factory", default=None,
                   help="module:attr runner factory override (test seam)")

    a = sub.add_parser("serve-artifacts",
                       help="serve a shared MeasureDB/ProgramStore")
    a.add_argument("--host", default="0.0.0.0")
    a.add_argument("--port", type=int, default=7762,
                   help="0 = ephemeral (printed in the ready line)")
    a.add_argument("--measure-db", default=None,
                   help="JSONL timing-store path to front")
    a.add_argument("--program-store", default=None,
                   help="JSONL program-store path to front")
    a.add_argument("--versions-dir", default=None,
                   help="enable keep-N versioned snapshots in this dir")
    a.add_argument("--keep", type=int, default=3,
                   help="complete versions to keep (GC the rest)")
    a.add_argument("--snapshot-every", type=int, default=None,
                   help="auto-snapshot every N appends")

    args = ap.parse_args(argv)
    if args.cmd == "serve-worker":
        if args.workers < 1:
            ap.error(f"--workers must be >= 1, got {args.workers}")
        if args.reps < 1:
            ap.error(f"--reps must be >= 1, got {args.reps}")
        return _serve_worker(args)
    if args.measure_db is None and args.program_store is None:
        ap.error("serve-artifacts needs --measure-db and/or "
                 "--program-store")
    if args.keep < 1:
        ap.error(f"--keep must be >= 1, got {args.keep}")
    return _serve_artifacts(args)


if __name__ == "__main__":
    sys.exit(main())
