"""Service-oriented autotuning on the PyTorch port: concurrent sessions
over one worker pool.

``repro_torch.service.TuningService`` owns a shared measurement transport,
here a ``WorkerPoolTransport`` fanning (site, tiles) batches out to N
subprocess workers, each timing the Hopper kernels (or, with ``--device
cpu``, their plain versions at capped shapes), and hands out sessions,
each an agent paired with an oracle view.  Two sessions tune below (PPO
trained on measured rewards, and brute force sweeping the same grid
concurrently); their overlapping (site, tiles) keys coalesce inside the
transport and every timing streams into one persistent ``MeasureDB``.

    PYTHONPATH=src python examples/torch_service_autotune.py \\
        [--device cpu] [--workers 2] [--db /tmp/service_measure.jsonl] \\
        [--steps 48]

Run it twice with the same ``--db`` and the second run performs zero
kernel timings.  It prints ``OK`` at the end.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))


def small_cfg():
    """A compact action space: measured tuning times real kernels, so the
    demo keeps the grid to tens of pairs, each timed once thanks to the
    DB."""
    from repro_torch.api import NeuroVecConfig
    return NeuroVecConfig(
        bm_choices=(16, 32, 64), bn_choices=(128,), bk_choices=(128,),
        bq_choices=(64, 128), bkv_choices=(128,), chunk_choices=(32, 64),
        train_batch=32, sgd_minibatch=16, ppo_epochs=2, lr=5e-4)


def demo_sites():
    from repro_torch.models.compute import KernelSite
    return [
        KernelSite(site="ex.qkv", kind="matmul", m=64, n=128, k=256),
        KernelSite(site="ex.ffn", kind="matmul", m=128, n=128, k=128),
        KernelSite(site="ex.attn", kind="attention", m=128, n=64, k=128,
                   batch=2, causal=True),
        KernelSite(site="ex.scan", kind="chunk_scan", m=64, n=32, k=16,
                   batch=2),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--workers", type=int, default=2,
                    help="worker-pool size (subprocesses)")
    ap.add_argument("--db", default="/tmp/repro_torch_service_measure.jsonl",
                    help="persistent measurement-DB path shared by every "
                         "session")
    ap.add_argument("--steps", type=int, default=48,
                    help="PPO environment steps for the RL session")
    ap.add_argument("--reps", type=int, default=1,
                    help="timing repetitions per (site, tile) pair")
    ap.add_argument("--prune-topk", type=int, default=None,
                    help="only time each site's top-K surrogate-ranked "
                         "tile candidates per session; the rest are priced "
                         "by a learned cost model trained from --db "
                         "(needs a warm DB: run once without it first)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the service's final metrics snapshot to "
                         "this JSON file")
    ap.add_argument("--chaos", action="store_true",
                    help="after the normal run, close the transport and "
                         "show tuning degrade to the cost model (prints "
                         "the resulting health line)")
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error(f"--reps must be >= 1, got {args.reps}")
    if args.prune_topk is not None and args.prune_topk < 1:
        ap.error(f"--prune-topk must be >= 1, got {args.prune_topk}")

    from repro_torch.api import TileProgram, TuningService, program_speedup

    cfg = small_cfg()
    sites = demo_sites()

    with TuningService(cfg, transport="pool", workers=args.workers,
                       db_path=args.db, reps=args.reps, warmup=1,
                       device=args.device) as svc:
        print(f"== TuningService: pool of {args.workers} workers "
              f"({svc.transport.backend_key}) ==")
        rl = svc.open_session(agent="ppo", oracle="measured",
                              prune_topk=args.prune_topk)
        sweep = svc.open_session(agent="brute", oracle="measured",
                                 prune_topk=args.prune_topk)

        # brute's exhaustive sweep times concurrently with PPO's training:
        # overlapping pairs coalesce inside the transport
        sweep_fut = sweep.fit(sites).tune_async(sites)
        rl.fit(sites, total_steps=args.steps)
        rl_prog = rl.tune(sites)
        sweep_prog = sweep_fut.result()
        assert isinstance(rl_prog, TileProgram)
        assert len(rl_prog.tiles) == len(sweep_prog.tiles) == len(sites)

        for handle in (rl, sweep):
            s = handle.stats()
            print(f"[{s['session']}] agent={s['agent']} "
                  f"tunes={s['session_tunes_total']} "
                  f"sites={s['session_sites_tuned_total']} "
                  f"fit {s['session_fit_seconds_total']:.2f}s "
                  f"tune {s['session_tune_seconds_total']:.2f}s "
                  f"| transport delta: "
                  f"{s['transport']['transport_timed_pairs_total']} timed, "
                  f"{s['transport']['transport_hits_total']} hits, "
                  f"{s['transport']['transport_coalesced_total']} coalesced")
        for k in sorted(sweep_prog.tiles):
            print(f"  {k}: rl={rl_prog.tiles[k]} brute={sweep_prog.tiles[k]}")

        if args.chaos:
            # the transport dies, yet the session still tunes: the
            # MeasuredEnv's circuit breaker opens and prices with the
            # analytic cost model
            print("== chaos: closing the measurement transport mid-life ==")
            svc.transport.close()
            env = rl.oracle.oracle          # the session's MeasuredEnv
            env.clear_result_cache()
            chaos_prog = rl.tune(sites)
            assert len(chaos_prog.tiles) == len(sites)
            sp = program_speedup(chaos_prog, sites, env=env)
            print(f"[chaos] health: {rl.health()}; tuned "
                  f"{len(chaos_prog.tiles)} sites via the cost model "
                  f"(modelled speedup {sp:.2f}x, breaker_open="
                  f"{env.breaker_open})")

        snap = svc.registry.snapshot()
        n_tunes = sum(v for k, v in snap.items()
                      if k.startswith("session_tunes_total"))
        print(f"obs: {len(snap)} metric series, {int(n_tunes)} tunes "
              f"recorded")
        if args.metrics_out:
            import json
            with open(args.metrics_out, "w") as f:
                json.dump(snap, f, indent=1, default=str)
        st = svc.transport.stats()
    print(f"measurements: {st['transport_timed_pairs_total']} timed, "
          f"{st['transport_hits_total']} DB hits, "
          f"{st['transport_coalesced_total']} coalesced, "
          f"{st['transport_retries_total']} retries across "
          f"{st['pool_workers_count']} workers; rerun with the same --db and "
          f"timed goes to 0")
    print("service OK")
    return rl_prog, sweep_prog, st


if __name__ == "__main__":
    main()
