"""Warm-start autotuning from persistent artifacts on the PyTorch port
(``repro_torch.artifacts``).

The paper's deployment story (§4): train once, then greedy inference only
on new code.  The trained artifact survives the process; this script is
the proof, split across two invocations so that the warm phase runs in a
fresh process:

    # phase 1: fit, save the facade artifact, record the cold decisions
    PYTHONPATH=src python examples/torch_warmstart_autotune.py \\
        --phase fit --artifact /tmp/nv_artifact \\
        --store /tmp/nv_programs.jsonl [--device cpu]

    # phase 2 (a fresh process): load, tune twice through the ProgramStore
    PYTHONPATH=src python examples/torch_warmstart_autotune.py \\
        --phase warm --artifact /tmp/nv_artifact \\
        --store /tmp/nv_programs.jsonl [--device cpu]

The warm phase asserts three invariants end to end:

* the loaded facade's tile program is bitwise the one tuned before
  saving (a round trip across processes);
* the first warm tune is already a ``ProgramStore`` lookup, since the fit
  phase shared the store (zero agent inferences in this process);
* the second tune of the same site set performs 0 agent inferences
  (the ``tune 2: agent inferences 0`` line).

The agent's network lives on the card unless ``--device cpu``.  It prints
``OK`` at the end.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

_TMP = tempfile.gettempdir()


def small_cfg():
    from repro_torch.api import NeuroVecConfig
    return NeuroVecConfig(train_batch=32, sgd_minibatch=16, ppo_epochs=2,
                          lr=5e-4)


def demo_sites():
    from repro_torch.models.compute import KernelSite
    return [
        KernelSite(site="ws.qkv", kind="matmul", m=64, n=128, k=256),
        KernelSite(site="ws.ffn", kind="matmul", m=128, n=128, k=128),
        KernelSite(site="ws.attn", kind="attention", m=128, n=64, k=128,
                   batch=2, causal=True),
        KernelSite(site="ws.scan", kind="chunk_scan", m=64, n=32, k=16,
                   batch=2),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("fit", "warm"), required=True)
    ap.add_argument("--device", default="cuda",
                    help="where the agent runs: cuda (default) or cpu")
    ap.add_argument("--artifact",
                    default=os.path.join(_TMP, "repro_torch_nv_artifact"),
                    help="facade artifact directory (nv.save/load)")
    ap.add_argument("--store",
                    default=os.path.join(_TMP, "repro_torch_programs.jsonl"),
                    help="shared ProgramStore path")
    ap.add_argument("--agent", default="ppo")
    ap.add_argument("--steps", type=int, default=96,
                    help="PPO budget for --phase fit")
    ap.add_argument("--expect",
                    default=os.path.join(_TMP, "repro_torch_cold_tiles.json"),
                    help="cold tile program recorded by fit, verified "
                         "bitwise by warm")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    resolve_device(args.device)         # no card: raise before any work

    from repro_torch.api import NeuroVectorizer, TileProgram

    sites = demo_sites()

    if args.phase == "fit":
        nv = NeuroVectorizer(small_cfg(), agent=args.agent, seed=0,
                             program_store=args.store, device=args.device)
        fit_kw = {"total_steps": args.steps} if args.agent == "ppo" else {}
        nv.fit(sites, **fit_kw)
        prog = nv.tune_sites(sites)
        prog.save(args.expect)
        fp = nv.save(args.artifact)
        print(f"== cold fit: {args.agent}, {len(prog.tiles)} sites tuned, "
              f"{nv.agent_inferences} agent inferences ==")
        print(f"saved facade artifact -> {args.artifact} "
              f"(agent fingerprint {fp[:16]})")
        print(f"cold tiles -> {args.expect}; store -> {args.store}")
        nv.close()
        print("warm-start fit OK")
        return prog

    # -- phase warm: a fresh process restores everything ------------------
    nv = NeuroVectorizer.load(args.artifact, program_store=args.store,
                              device=args.device)
    print(f"== warm start: loaded {args.artifact} "
          f"(agent={nv.agent.name}) ==")

    prog1 = nv.tune_sites(sites)
    print(f"tune 1: agent inferences {nv.agent_inferences}, "
          f"store hits {nv.store_hits}, misses {nv.store_misses}")
    first = nv.agent_inferences
    prog2 = nv.tune_sites(sites)
    print(f"tune 2: agent inferences {nv.agent_inferences - first}, "
          f"store hits {nv.store_hits}, misses {nv.store_misses}")

    assert prog2.tiles == prog1.tiles, "second tune diverged"
    assert first == 0 and nv.store_hits >= 1, \
        "the first warm tune must be a store lookup"
    assert nv.agent_inferences - first == 0, \
        "second tune of a stored site set must perform zero inferences"
    expect = TileProgram.load(args.expect)
    assert prog1.tiles == expect.tiles, (
        f"cross-process round trip broke: {prog1.tiles} != {expect.tiles}")
    print("round-trip invariant: OK (warm tiles bitwise-equal to cold "
          "tiles from the fit process)")
    st = nv.program_store.stats()
    print(f"program store: {st['entries']} entries, hit rate "
          f"{st['hit_rate']:.2f}")
    nv.close()
    print("warm-start OK")
    return prog1


if __name__ == "__main__":
    main()
