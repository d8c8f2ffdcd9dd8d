"""Measured autotuning end to end on the PyTorch port: train PPO against
*timed* rewards.

This is the paper's loop (eq. 2: the agent learns from measured
execution time, not a cost model): every reward below comes from timing
the port's Hopper kernels (K1, K2, K3) through ``oracle="measured"``.
With ``--device cpu`` the runner times their plain PyTorch versions at
capped shapes, a proxy that runs the whole measure, reward, train and
deploy chain without a card.

    PYTHONPATH=src python examples/torch_measured_autotune.py \\
        [--device cpu] [--steps 96] [--db /tmp/measure.jsonl] \\
        [--agent ppo] [--transport pool --workers 2]

Run it twice with the same ``--db`` and the second run performs zero
kernel timings: every (site, tile) pair is served from the persistent
measurement database (under either transport: the pool streams its
results into the same DB).  It prints ``OK`` at the end.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))
# deterministic cuBLAS, for deterministic()
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


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


def deterministic():
    """The same fit from the same seed and rewards, run after run: the
    agent's embedding gradient accumulates by index, which PyTorch adds
    in a nondeterministic order on several CPU threads or on the card
    unless asked not to."""
    import torch
    torch.use_deterministic_algorithms(True, warn_only=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--steps", type=int, default=96,
                    help="PPO environment steps (measured rewards)")
    ap.add_argument("--agent", default="ppo",
                    help="any repro_torch.api registry name (ppo, brute, "
                         "...)")
    ap.add_argument("--db", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_measure.jsonl"),
        help="persistent measurement-DB path")
    ap.add_argument("--reps", type=int, default=1,
                    help="timing repetitions per (site, tile) pair")
    ap.add_argument("--prune-topk", type=int, default=None,
                    help="only time each site's top-K surrogate-ranked "
                         "tile candidates; the rest are priced by a "
                         "learned cost model trained from --db (needs a "
                         "warm DB: run once without it first)")
    ap.add_argument("--transport", choices=("inproc", "pool"),
                    default="inproc",
                    help="measure in this process or across a subprocess "
                         "worker pool")
    ap.add_argument("--workers", type=int, default=2,
                    help="pool size for --transport pool")
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_measured_tiles.json"))
    args = ap.parse_args(argv)
    if args.reps < 1:
        ap.error(f"--reps must be >= 1, got {args.reps}")
    if args.prune_topk is not None and args.prune_topk < 1:
        ap.error(f"--prune-topk must be >= 1, got {args.prune_topk}")

    from repro_torch.device import resolve_device
    resolve_device(args.device)         # no card: raise before any work

    from repro_torch.api import NeuroVectorizer, TileProgram

    deterministic()
    cfg = small_cfg()
    sites = demo_sites()
    nv = NeuroVectorizer(cfg, agent=args.agent, oracle="measured", seed=0,
                         db_path=args.db, transport=args.transport,
                         workers=(args.workers
                                  if args.transport == "pool" else None),
                         prune_topk=args.prune_topk,
                         oracle_kwargs=dict(reps=args.reps, warmup=1),
                         device=args.device)
    transport = nv.oracle.measure_fn.transport
    print(f"== fit {args.agent} vs measured oracle "
          f"(transport={args.transport}, {transport.backend_key}) ==")
    fit_kw = {"total_steps": args.steps} if args.agent == "ppo" else {}
    nv.fit(sites, **fit_kw)

    prog = nv.tune_sites(sites)
    assert isinstance(prog, TileProgram) and len(prog.tiles) == len(sites)
    prog.save(args.out)

    print(f"tuned {len(prog.tiles)} sites -> {args.out}")
    for k, t in prog.tiles.items():
        print(f"  {k}: tiles={t}")
    print(f"measured speedup vs heuristic baseline: "
          f"{nv.speedup(prog, sites):.2f}x")
    st = transport.stats()
    print(f"measurements: {st['transport_timed_pairs_total']} timed, "
          f"{st['transport_hits_total']} DB hits, "
          f"{st['transport_misses_total']} misses, "
          f"{st['transport_coalesced_total']} coalesced "
          f"(hit rate {st['transport_hit_ratio']:.2f}); rerun with the "
          f"same --db and timed goes to 0")
    if args.prune_topk is not None:
        state = ("active" if nv.oracle.prune_active
                 else "inactive (DB too cold to train the surrogate)")
        print(f"pruning top-{args.prune_topk}: {state}, "
              f"{nv.oracle.pruned_pairs} pairs surrogate-priced")
    nv.close()                 # the pool's workers, the DB file
    from repro_torch.kernels import chunk_scan, flash_attention, matmul
    print(f"kernel launches in this process: K1 {matmul.launches}, K2 "
          f"{flash_attention.launches}, K3 {chunk_scan.launches} (the "
          f"plain versions on the CPU count none)")
    print("measured autotune OK")
    return prog, st


if __name__ == "__main__":
    main()
