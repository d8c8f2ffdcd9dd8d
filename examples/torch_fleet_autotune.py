"""A cross-host tuning fleet end to end on the PyTorch port
(``repro_torch.fleet``).

The client in this process never times a kernel: measurements ship over
TCP to ``serve-worker`` daemons, and both persistent stores (the timing
DB and the tuned-program store) live behind one shared ``serve-artifacts``
daemon that every fleet client subscribes to.

Start the daemons (one terminal each, or in the background; ``--port 0``
picks a free port and prints it in the ``ready on HOST:PORT`` line):

    PYTHONPATH=src python -m repro_torch.fleet serve-worker \\
        --port 7761 --transport pool --workers 2 --reps 1 [--device cpu]
    PYTHONPATH=src python -m repro_torch.fleet serve-artifacts \\
        --port 7762 --measure-db /tmp/fleet_measure.jsonl \\
        --program-store /tmp/fleet_programs.jsonl

then run this twice:

    PYTHONPATH=src python examples/torch_fleet_autotune.py \\
        --hosts 127.0.0.1:7761 --artifacts 127.0.0.1:7762 [--steps 48] \\
        [--device cpu]

Run 1 times every (site, tile) pair on the serve-worker hosts, and a
second, independent subscriber in this process observes the finished
tile program arrive by push, without reopening the store.  Run 2 finds
the shared DB warm (zero timings fleet-wide) and the program store
answers the whole tune by lookup.  ``--device`` is where this client's
agent runs (the workers measure where their own ``--device`` says).  It
prints ``OK`` at the end.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_measured_autotune import (demo_sites, deterministic,  # noqa: E402
                                     small_cfg)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", required=True,
                    help="comma-separated serve-worker host:port list")
    ap.add_argument("--artifacts", required=True,
                    help="serve-artifacts host:port (shared MeasureDB and "
                         "ProgramStore)")
    ap.add_argument("--device", default="cuda",
                    help="where the agent runs: cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=48,
                    help="PPO environment steps (measured rewards)")
    ap.add_argument("--agent", default="ppo",
                    help="any repro_torch.api registry name (ppo, brute, "
                         "...)")
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_fleet_tiles.json"))
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    resolve_device(args.device)         # no card: raise before any work

    from repro_torch.api import NeuroVectorizer, TileProgram
    from repro_torch.fleet import RemoteProgramStore

    # run 2's fit must give run 1's agent state bit for bit, or its
    # program-store key misses
    deterministic()
    hosts = [h.strip() for h in args.hosts.split(",") if h.strip()]
    art = f"fleet://{args.artifacts}"
    cfg = small_cfg()
    sites = demo_sites()

    # an independent subscriber, opened before tuning: if the tune below
    # makes a fresh program, this client must see it arrive by push (the
    # serving process's half of fleet store invalidation)
    watcher = RemoteProgramStore(art)
    baseline_entries = len(watcher)

    nv = NeuroVectorizer(cfg, agent=args.agent, oracle="measured", seed=0,
                         transport="socket", hosts=hosts,
                         db_path=art, program_store=art, device=args.device)
    t = nv.oracle.measure_fn.transport
    print(f"== fleet tune: {len(hosts)} host(s) "
          f"[{', '.join(hosts)}], artifacts {args.artifacts}, "
          f"backend {t.backend_key} ==")
    fit_kw = {"total_steps": args.steps} if args.agent == "ppo" else {}
    nv.fit(sites, **fit_kw)
    prog = nv.tune_sites(sites)
    assert isinstance(prog, TileProgram) and len(prog.tiles) == len(sites)
    prog.save(args.out)
    print(f"tuned {len(prog.tiles)} sites -> {args.out}")

    if nv.store_hits:
        print(f"store warm: {nv.store_hits} tune(s) answered by shared "
              f"program-store lookup ({nv.agent_inferences} agent "
              f"inferences)")
    else:
        # a fresh program: wait for the server to push it to the watcher
        deadline = time.time() + 10.0
        while time.time() < deadline and (
                watcher.pushes_received == 0
                or len(watcher) <= baseline_entries):
            time.sleep(0.05)
        assert watcher.pushes_received >= 1, \
            "watcher never received the push"
        print("push-invalidation: serving client observed the tuned "
              "program without reopening the store "
              f"({watcher.pushes_received} push(es), "
              f"{len(watcher)} entries)")

    st = t.stats()
    print(f"fleet hosts: {st['fleet_hosts_live']}/{st['fleet_hosts_count']}"
          f" live, {st['fleet_reconnects_total']} reconnects, health "
          f"{st['health']}")
    print(f"measurements: {st['transport_timed_pairs_total']} timed, "
          f"{st['transport_hits_total']} DB hits, "
          f"{st['transport_misses_total']} misses, "
          f"{st['transport_coalesced_total']} coalesced "
          f"(hit rate {st['transport_hit_ratio']:.2f}); rerun and timed "
          f"goes to 0")
    watcher.close()
    nv.close()
    print("fleet autotune OK")
    return prog, st


if __name__ == "__main__":
    main()
