"""Serving under an SLO on the PyTorch port: N concurrent clients against
one admission queue.

``TuningService(serving=...)`` runs every session's ``tune``/``tune_async``
through a deadline-aware ``repro_torch.serving.Server``: concurrent
requests coalesce into batches (brute force over the cost model becomes
one fused device dispatch a batch, a CUDA graph replay on the card), each
request carries an SLO budget, and past ``max_queue`` depth the server
sheds with a typed ``QueueFull``.

    PYTHONPATH=src python examples/torch_serving_autotune.py \\
        [--device cpu] [--clients 4] [--slo-ms 200] [--rounds 6]

Phase 1 (nominal load) drives ``--clients`` threads through one server
and prints the client-observed p50/p99 against the SLO with zero shed.
Phase 2 (overload) bursts requests at a 2-deep queue and prints the
nonzero shed count.  It prints ``OK`` at the end.
"""
import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))


def small_cfg():
    from repro_torch.api import NeuroVecConfig
    return NeuroVecConfig(
        bm_choices=(16, 32, 64), bn_choices=(128,), bk_choices=(128,),
        bq_choices=(64, 128), bkv_choices=(128,), chunk_choices=(32, 64),
        train_batch=32, sgd_minibatch=16, ppo_epochs=2, lr=5e-4)


def client_sites(i, n=3):
    from repro_torch.models.compute import KernelSite
    return [KernelSite(site=f"cl{i}.mm{j}", kind="matmul",
                       m=32 * (j + 1), n=128, k=128) for j in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: where the fused tuner runs")
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent client threads (sessions)")
    ap.add_argument("--slo-ms", type=float, default=200.0,
                    help="per-request SLO budget at nominal load")
    ap.add_argument("--rounds", type=int, default=6,
                    help="tune rounds per client")
    args = ap.parse_args(argv)
    if args.clients < 2:
        ap.error(f"--clients must be >= 2, got {args.clients}")

    import numpy as np

    from repro_torch.api import TuningService
    from repro_torch.serving import QueueFull

    cfg = small_cfg()

    # -- phase 1: nominal load, N clients, p99 inside the SLO ---------------
    with TuningService(cfg, serving={"slo_ms": args.slo_ms},
                       device=args.device) as svc:
        print(f"== serving: {args.clients} concurrent clients, "
              f"slo {args.slo_ms:.0f} ms, on {svc.device} ==")
        pairs = [(svc.open_session(agent="brute", oracle="model"),
                  client_sites(i)) for i in range(args.clients)]
        for s, ss in pairs:
            s.fit(ss)
        # warm round: each bucket's first use (a graph capture on the
        # card) is paid here, for the full coalesced batch and a solo one
        for f in [s.tune_async(ss) for s, ss in pairs]:
            f.result(timeout=300)
        pairs[0][0].tune(pairs[0][1])

        lat, errors = [], []
        barrier = threading.Barrier(args.clients)
        lock = threading.Lock()

        def client(sess, ss):
            try:
                for _ in range(args.rounds):
                    barrier.wait()           # rounds arrive together
                    t0 = time.perf_counter()
                    prog = sess.tune(ss)
                    dt = time.perf_counter() - t0
                    assert len(prog.tiles) == len(ss)
                    with lock:
                        lat.append(dt)
            except Exception as e:           # surfaced below
                errors.append(e)
                barrier.abort()              # release waiting peers

        threads = [threading.Thread(target=client, args=p) for p in pairs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if errors:
            raise errors[0]

        st = svc.server.stats()
        p50 = float(np.percentile(lat, 50)) * 1e3
        p99 = float(np.percentile(lat, 99)) * 1e3
        ok = p99 <= args.slo_ms
        print(f"serving: {len(lat)} tunes, p50 {p50:.2f} ms, "
              f"p99 {p99:.2f} ms (slo {args.slo_ms:.0f} ms): within SLO: "
              f"{'yes' if ok else 'MISS'}")
        print(f"shed: {st['serving_shed_total']}, deadline misses: "
              f"{st['serving_deadline_misses_total']}, batches: "
              f"{st['serving_batches_total']}, fused dispatches: "
              f"{st['serving_fused_dispatches_total']} "
              f"(largest batch {st['serving_batch_requests_max']} requests)")
        print(f"health: {svc.server.health()}")
        snap = svc.registry.snapshot()
        n_series = sum(1 for k in snap if k.startswith("serving_"))
        print(f"obs: {n_series} serving_* metric series in the registry")
        assert ok, f"p99 {p99:.2f} ms blew the {args.slo_ms:.0f} ms SLO"
        assert st["serving_shed_total"] == 0, st

    # -- phase 2: overload, admission control sheds, typed ------------------
    burst = 16
    with TuningService(cfg, serving={"slo_ms": 60_000.0, "max_queue": 2,
                                     "max_wait_ms": 250.0},
                       device=args.device) as svc:
        s = svc.open_session(agent="brute", oracle="model")
        ss = client_sites(0)
        s.fit(ss)
        futs, shed = [], 0
        for _ in range(burst):               # the queue holds 2; rest shed
            try:
                futs.append(s.tune_async(ss))
            except QueueFull:
                shed += 1
        for f in futs:                       # every admitted request lands
            assert len(f.result(timeout=300).tiles) == len(ss)
        print(f"overload: shed={shed} of {burst} burst requests at "
              f"max_queue=2 (typed QueueFull), {len(futs)} admitted, all "
              f"served, health {svc.server.health()}")
        assert shed > 0, "burst never tripped admission control"
    print("serving OK")
    return lat


if __name__ == "__main__":
    main()
