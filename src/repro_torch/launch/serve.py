"""Serving driver: batched prefill + greedy decode with a KV/state cache,
under a tile program a PPO agent tuned (the port of
``repro/launch/serve.py``).

The paper's train-once, tune-and-deploy loop (§4.2): extract the kernel
sites of the prefill and decode steps, fit an agent (``--autotune ppo``,
``brute`` or ``baseline``) against a reward oracle with
``legality="h100"`` on the card (tiles the Hopper kernels cannot launch
are illegal; ``"cpu"`` with ``--device cpu``, the same rule without its
dtype clause), greedily tune the sites into a ``TileProgram`` (the greedy
pick taken over the legal tiles), and with ``--inject`` run every matmul
and prefill-attention site through the hand-written kernels with exactly
those tiles: a tile they cannot launch (from ``--tiles``) stops the run
with ``TileError``, and on the card a site whose dtype or head dim the
kernels refuse stops it before tuning.  Runs on the GPU unless
``--device cpu`` is given::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_8b --full \\
      --batch 4 --prompt-len 512 --gen 16 --autotune ppo --measured --inject

The oracle is the analytic cost model (TPU v5e constants: its speedup is
not an H100 number) unless ``--measured`` is given: then the reward is
the measured time of the kernels themselves at each site's shapes (paper
eq. 2; ``repro_torch.measure``), on the card, or of their plain versions
at capped shapes with ``--device cpu``; ``--autotune brute --measured``
times every legal tile of every site and takes the fastest.
``--measure-db PATH`` keeps the timings, so a repeat run times nothing;
``--measure-reps`` sets the timing repetitions per pair.  ``--transport
pool --workers N`` times in N subprocess workers, each with its own CUDA
context (a kernel that crashes or poisons its context costs a worker, not
this process); ``--transport socket --hosts a:7761,b:7761`` ships the
timings to ``python -m repro_torch.fleet serve-worker`` daemons, and a
``fleet://host:port`` ``--measure-db`` or ``--program-store`` attaches
the shared artifact service.

Warm starts and telemetry: ``--agent-ckpt DIR`` restores a fitted agent
saved by ``NeuroVectorizer.save`` or ``save_agent`` and skips the fit;
``--program-store PATH`` memoizes finished tile programs (a site set seen
before is a lookup, no agent inference); ``--trace-out`` appends the
tuning span tree (session, fit, tune, submit/drain) to a JSONL trace and
``--metrics-out`` writes the metrics registry's final snapshot.

After one untimed pass, prefill ms is the median of ``PREFILL_REPS``
timed prefills and decode tokens/s the median of ``DECODE_REPS`` timed
decode windows; every prefill starts from a fresh cache and every decode
window from the cache the prefill left (the xLSTM state is recurrent).
"""
from __future__ import annotations

import argparse
import contextlib
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.neurovec import DEFAULT
from repro_torch.core import costmodel_vec
from repro_torch.core.env import ActionSpace, CostModelEnv
from repro_torch.core.protocols import resolve_health
from repro_torch.core.extractor import extract_serve_sites
from repro_torch.core.vectorizer import TileProgram, inject, program_speedup
from repro_torch.device import resolve_device
from repro_torch.kernels import chunk_scan as kcs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops
from repro_torch.models.lm import build_model
from repro_torch.train.steps import make_prefill_step, make_serve_step

AUTOTUNE = ("ppo", "brute", "baseline")     # the ported agents
PREFILL_REPS = 5        # timed prefills, after one untimed pass
DECODE_REPS = 3         # timed decode windows of gen - 1 steps each


@dataclass
class ServeResult:
    """What one serve run produced, for callers that check it."""
    model: object
    params: dict
    prompts: torch.Tensor
    seq: torch.Tensor                   # (B, gen) greedy tokens
    prefill_logits: torch.Tensor        # (B, V) f32
    prefill_ms: float                   # median of the timed prefills
    decode_tok_s: float                 # median of the timed decode windows
    prog: Optional[TileProgram] = None
    sites: list = field(default_factory=list)
    modelled_speedup: Optional[float] = None
    launches: dict = field(default_factory=dict)   # phase -> kernel -> n,
                                                   # for one untimed pass
    prefill_ms_runs: list = field(default_factory=list)
    decode_tok_s_runs: list = field(default_factory=list)
    tuning: dict = field(default_factory=dict)     # see _tile_plan


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (default: the "
                         "reduced test config)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--autotune", choices=AUTOTUNE, default=None,
                    help="tune the serving kernels' tiles with this agent")
    ap.add_argument("--autotune-steps", type=int, default=2000,
                    help="RL budget for --autotune ppo")
    ap.add_argument("--tiles", default=None,
                    help="load a saved TileProgram instead of tuning")
    ap.add_argument("--save-tiles", default=None)
    ap.add_argument("--measured", action="store_true",
                    help="tune against the measured times of the kernels "
                         "(repro_torch.measure) instead of the cost model")
    ap.add_argument("--measure-db", default=None,
                    help="persistent measurement-DB path (repeat runs "
                         "against the same path time nothing)")
    ap.add_argument("--measure-reps", type=int, default=3,
                    help="timing repetitions per (site, tile) pair")
    ap.add_argument("--transport", choices=("inproc", "pool", "socket"),
                    default="inproc",
                    help="how measurements execute: this process, a "
                         "subprocess worker pool (repro_torch.measure), or "
                         "a remote serve-worker fleet (repro_torch.fleet)")
    ap.add_argument("--workers", type=int, default=2,
                    help="pool size for --transport pool")
    ap.add_argument("--hosts", default=None,
                    help="comma-separated serve-worker host:port list for "
                         "--transport socket (start them with `python -m "
                         "repro_torch.fleet serve-worker`)")
    ap.add_argument("--agent-ckpt", default=None,
                    help="warm-start --autotune from a saved agent "
                         "artifact directory (skips the fit)")
    ap.add_argument("--program-store", default=None,
                    help="persistent ProgramStore path (or fleet://host:"
                         "port): a site set tuned before is a lookup")
    ap.add_argument("--trace-out", default=None,
                    help="append the tuning span tree to this JSONL trace "
                         "file (repro_torch.obs)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the final metrics snapshot to this JSON "
                         "file")
    ap.add_argument("--inject", action="store_true",
                    help="run the model through the kernels with the tiles")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.inject and not (args.autotune or args.tiles):
        ap.error("--inject requires a tile plan: pass --autotune or --tiles")
    if args.autotune and args.tiles:
        ap.error("pass --autotune or --tiles, not both")
    if args.gen < 1 or args.batch < 1 or args.prompt_len < 1:
        ap.error("--batch, --prompt-len and --gen must be >= 1")
    if args.measured and (args.tiles or not args.autotune):
        ap.error("--measured requires --autotune and no --tiles (it "
                 "changes the tuning oracle; --tiles loads a finished plan)")
    if args.measure_reps < 1:
        ap.error(f"--measure-reps must be >= 1, got {args.measure_reps}")
    if args.measure_db and not args.measured:
        ap.error("--measure-db applies only to --measured tuning")
    if (args.agent_ckpt or args.program_store) and not args.autotune:
        ap.error("--agent-ckpt/--program-store warm-start the tuning "
                 "pipeline: pass --autotune (they do not apply to --tiles, "
                 "which loads a finished plan)")
    if args.workers < 1:
        ap.error(f"--workers must be >= 1, got {args.workers}")
    if args.transport == "socket" and not args.hosts:
        ap.error("--transport socket needs --hosts host:port[,host:port...] "
                 "naming the serve-worker daemons")
    if args.hosts and args.transport != "socket":
        ap.error("--hosts applies only to --transport socket")
    if args.trace_out and not args.autotune:
        ap.error("--trace-out records the tuning span tree: pass "
                 "--autotune (loading --tiles produces no spans)")
    return args


def legality_for(device) -> str:
    """The legality profile of a serve on ``device``: the kernels' launch
    rule on the card, the plain versions' on the CPU."""
    return "h100" if torch.device(device).type == "cuda" else "cpu"


def _measured_env(args, device, legality):
    """The measured oracle over ``args.transport``: the runner options are
    this process's for ``inproc`` and ``pool``, the hosts' for
    ``socket``."""
    from repro_torch.measure import make_measured_env
    runner_kw = {} if args.transport == "socket" else dict(
        reps=args.measure_reps, device=str(device))
    env = make_measured_env(
        DEFAULT, db_path=args.measure_db, transport=args.transport,
        workers=args.workers if args.transport == "pool" else None,
        hosts=(args.hosts.split(",") if args.transport == "socket"
               else None),
        legality=legality, **runner_kw)
    where = {"inproc": "-", "pool": f"workers={args.workers}",
             "socket": f"hosts={args.hosts}"}[args.transport]
    print(f"[serve] measured oracle: transport={args.transport} {where} "
          f"reps={runner_kw.get('reps', '-')} db={args.measure_db or '-'} "
          f"({env.measure_fn.transport.backend_key})", flush=True)
    return env


def _tile_plan(args, sites, device):
    """Tune (or load) a TileProgram for the serving sites.

    Tuning goes through the facade (``repro_torch.api``) with this
    serve's oracle: the program store, the agent warm start, the trace and
    the metrics are the facade's.  Returns ``(prog, speedup, tuning)``:
    ``tuning`` holds the wall seconds of the fit and the greedy tune
    (``fit_s``; building the measured oracle, a pool's spawn included, is
    ``oracle_setup_s``), ``agent_inferences``, the program store's
    ``store`` stats, and what the measured oracle did (``measured``,
    ``stats``, ``health``, ``backend_key``, ``failures``,
    ``breaker_open``, ``picks``: per site the pick, its time, the fastest
    tile timed and every timed tile's seconds)."""
    legality = legality_for(device)
    env, nv = CostModelEnv(DEFAULT, legality=legality), None
    tuning = {"measured": bool(args.measured)}
    if args.tiles:
        prog = TileProgram.load(args.tiles)
        missing = sorted({s.site for s in sites if s.key() not in prog.tiles})
        if missing:
            print(f"[serve] WARNING: the tile plan misses sites that run at "
                  f"baseline tiles: {', '.join(missing)}", file=sys.stderr)
    else:
        from repro_torch.api import NeuroVectorizer
        from repro_torch.artifacts import load_agent
        from repro_torch.core.agents import BruteForceAgent, make_agent
        if args.measured:
            t0 = time.perf_counter()
            env = _measured_env(args, device, legality)
            tuning["oracle_setup_s"] = time.perf_counter() - t0
        agent = make_agent(args.autotune, DEFAULT, seed=0,
                           device=str(device))
        nv = NeuroVectorizer(DEFAULT, agent=agent, oracle=env,
                             program_store=args.program_store,
                             trace=args.trace_out, device=device)
        t0 = time.perf_counter()
        if args.agent_ckpt:
            load_agent(args.agent_ckpt, agent=agent)
            if isinstance(agent, BruteForceAgent):
                agent.oracle = env      # brute prices with a live oracle
            print(f"[serve] agent warm-start: {args.agent_ckpt} (fit "
                  f"skipped)")
        else:
            nv.fit(sites, total_steps=args.autotune_steps)
        # the greedy pick over the tiles the oracle's legality admits; the
        # mask comes from the cost model under the same legality (a
        # measured env would time the whole grid for it)
        prog = nv.tune_sites(sites)
        tuning["fit_s"] = time.perf_counter() - t0
        if args.save_tiles:
            prog.save(args.save_tiles)
        tuning["agent_inferences"] = nv.agent_inferences
        if args.program_store:
            st = tuning["store"] = nv.program_store.stats()
            print(f"[serve] program store: {st['hits']} hits, "
                  f"{st['misses']} misses, {nv.agent_inferences} agent "
                  f"inferences ({st['entries']} stored programs)")
    sp = program_speedup(prog, sites, env)
    if args.measured:
        _report_measured(args, env, prog, sites, sp, tuning)
        env.measure_fn.transport.close()    # workers, DB handles
    else:
        print(f"[serve] tile plan: {len(prog.tiles)} tiles over "
              f"{len(sites)} sites, TPU-v5e-modelled speedup {sp:.3f}x "
              f"(cost model, not an H100 measurement)")
    if nv is not None:
        nv.close()                      # the store, the tracer
        if args.trace_out:
            print(f"[serve] trace: {nv.tracer.n_spans} spans + "
                  f"{nv.tracer.n_events} events -> {args.trace_out}")
    if args.metrics_out:
        import json
        from repro_torch.obs import get_registry
        with open(args.metrics_out, "w") as f:
            json.dump(get_registry().snapshot(), f, indent=1, default=str)
        print(f"[serve] metrics snapshot -> {args.metrics_out}")
    return prog, sp, tuning


def _report_measured(args, env, prog, sites, sp, tuning):
    """Print and keep what the measured oracle did: the measured speedup,
    the transport's counters, health, every failure the runner kept (in
    process only: a worker's runner keeps its own), and per site the
    agent's pick beside the fastest tile it timed."""
    t = env.measure_fn.transport
    st = t.stats()
    runner = getattr(t, "runner", None)
    if args.transport == "socket":
        where = f"the serve-worker fleet's ({t.backend_key})"
    elif torch.device(args.device).type == "cuda":
        where = torch.cuda.get_device_name(torch.device(args.device))
    else:
        where = "CPU plain-version"
    tuning.update(stats=st, health=resolve_health(env, t),
                  backend_key=t.backend_key,
                  failures=list(getattr(runner, "failures", ())),
                  breaker_open=env.breaker_open, picks={})
    print(f"[serve] tile plan: {len(prog.tiles)} tiles over {len(sites)} "
          f"sites, measured {where} time speedup {sp:.3f}x over the "
          f"baseline tiles (fit {tuning.get('fit_s', 0.0):.1f} s)")
    extra = ""
    if "pool_worker_restarts_total" in st:
        extra = (f", {st['pool_worker_restarts_total']} worker restarts, "
                 f"{st['pool_quarantined_total']} quarantined, spawn "
                 f"{st['pool_spawn_seconds_total']:.1f} s")
    elif "fleet_hosts_count" in st:
        extra = (f", {st['fleet_hosts_live']}/{st['fleet_hosts_count']} "
                 f"hosts live, {st['fleet_reconnects_total']} reconnects")
    print(f"[serve] measurements: {st['transport_timed_pairs_total']} timed, "
          f"{st['transport_failed_pairs_total']} failed, "
          f"{st['transport_hits_total']} DB hits, "
          f"{st['transport_coalesced_total']} coalesced{extra} "
          f"({t.backend_key}); health: {tuning['health']}"
          + (f" ({env.degraded_reason})" if env.breaker_open else ""))
    for key, tiles, err in tuning["failures"]:
        print(f"[serve] failed pair {key} {tiles}: {err}")
    for s in sites:
        pick = tuple(prog.tiles[s.key()])
        timed = env.timed_tiles(s)
        t_pick = float(env.tiles_costs([s], [pick[:3]])[0])
        best = min(timed, key=timed.get) if timed else None
        tuning["picks"][s.key()] = {
            "pick": pick, "pick_s": t_pick, "best": best,
            "best_s": timed[best] if best else None, "n_timed": len(timed),
            "timed": dict(timed)}
        print(f"[serve] {s.site}@m{s.m}: pick {pick} {t_pick * 1e3:.4f} ms; "
              f"fastest of {len(timed)} timed "
              f"{best} {timed[best] * 1e3 if best else float('nan'):.4f} ms")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counts():
    return {"matmul": kmm.launches, "flash_attention": kfa.launches,
            "chunk_scan": kcs.launches}


def _diff(after, before):
    return {k: after[k] - before[k] for k in after}


def _decode(serve, params, logits, cache, args):
    """Greedy decode from the prefill's logits: ((B, gen) tokens, cache)."""
    tok = logits.argmax(dim=-1)[:, None]
    out = [tok]
    for i in range(args.gen - 1):
        tok, logits, cache = serve(params, tok, args.prompt_len + i, cache)
        out.append(tok)
    return torch.cat(out, dim=1), cache


def _check_kernel_sites(cfg, sites) -> None:
    """Every site must have a tile the CUDA kernels launch: the launch
    rule (``ops.tile_ok``, under ``CostModelEnv(legality="h100")``) over
    the action space, at each site's dtype and head dim."""
    legal = np.isfinite(costmodel_vec.cost_grid(ActionSpace(DEFAULT), sites,
                                                "h100"))
    bad = [s for s, row in zip(sites, legal) if not row.any()]
    if bad:
        dtypes = sorted({s.dtype for s in bad})
        dims = sorted({s.n for s in bad if s.kind == "attention"})
        raise ValueError(
            f"{cfg.name}: no tile of the CUDA kernels launches at "
            f"{len(bad)} sites ({', '.join(sorted({s.site for s in bad}))})"
            f": they take "
            f"{ops.KERNEL_DTYPE} and attention head dims that are multiples "
            f"of 8 up to {ops.ATTN_D_PAD}; those sites have dtypes {dtypes} "
            f"and attention head dims {dims} (the reduced test config?); "
            f"pass --full")


def _copy_into(dst, src) -> None:
    """Copy a cache tree into another of the same structure, in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s_ in zip(dst, src):
            _copy_into(d, s_)
    else:
        dst.copy_(src)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


def run(args, params=None, prompts=None) -> ServeResult:
    """Serve one batch.  ``params`` (a parameter tree on ``args.device``)
    and ``prompts`` ((B, prompt_len) ints) replace the seeded ones."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg)
    sites = []
    if args.autotune or args.tiles:
        sites = extract_serve_sites(model, args.batch, args.prompt_len,
                                    args.gen)
        if args.inject and device.type == "cuda":
            _check_kernel_sites(cfg, sites)
    if params is None:
        params = model.init(seed=0, device=device)
    B = args.batch
    if prompts is None:
        gen = torch.Generator().manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                                generator=gen)
    prompts = torch.as_tensor(prompts, dtype=torch.long).to(device)
    fresh = model.make_cache(B, args.prompt_len + args.gen, device=device)
    cache = _clone(fresh)
    prefill = make_prefill_step(model)
    serve = make_serve_step(model)

    prog, sp, tuning = None, None, {}
    c_tune = _counts()
    if sites:
        prog, sp, tuning = _tile_plan(args, sites, device)
    tuning["launches"] = _diff(_counts(), c_tune)
    run_ctx = inject(prog) if (prog is not None and args.inject) \
        else contextlib.nullcontext()

    with torch.inference_mode(), run_ctx:
        # one untimed pass first: it loads every kernel variant the tiles
        # name and grows the allocator, so the timed passes see neither
        c0 = _counts()
        logits, cache = prefill(params, {"tokens": prompts}, cache)
        c1 = _counts()
        seq, cache = _decode(serve, params, logits, cache, args)
        launches = {"prefill": _diff(c1, c0), "decode": _diff(_counts(), c1)}
        # every prefill starts from a fresh cache, every decode window from
        # the cache the last prefill left (the copies are not timed)
        prefill_s, decode_s = [], []
        for _ in range(PREFILL_REPS):
            _copy_into(cache, fresh)
            _sync(device)
            t0 = time.perf_counter()
            logits, cache = prefill(params, {"tokens": prompts}, cache)
            _sync(device)
            prefill_s.append(time.perf_counter() - t0)
        after_prefill = _clone(cache)
        for _ in range(DECODE_REPS):
            _copy_into(cache, after_prefill)
            _sync(device)
            t0 = time.perf_counter()
            seq, cache = _decode(serve, params, logits, cache, args)
            _sync(device)
            decode_s.append(time.perf_counter() - t0)
    prefill_ms_runs = [t * 1e3 for t in prefill_s]
    n_dec = B * (args.gen - 1)
    decode_tok_s_runs = [n_dec / t if args.gen > 1 else 0.0 for t in decode_s]
    prefill_ms = statistics.median(prefill_ms_runs)
    decode_tok_s = statistics.median(decode_tok_s_runs)
    print(f"[serve] {cfg.name} on {device}: {B} requests x {args.prompt_len} "
          f"prompt tokens, prefill {prefill_ms:.2f} ms (median of "
          f"{PREFILL_REPS}, {min(prefill_ms_runs):.2f}-"
          f"{max(prefill_ms_runs):.2f}); {args.gen - 1} decode steps, "
          f"{decode_tok_s:.1f} tok/s (median of {DECODE_REPS}, "
          f"{min(decode_tok_s_runs):.1f}-{max(decode_tok_s_runs):.1f}) "
          f"({'kernels' if prog is not None and args.inject else 'eager'}; "
          f"after one untimed pass)")
    print("[serve] sample:", seq[0].tolist())
    return ServeResult(model=model, params=params, prompts=prompts, seq=seq,
                       prefill_logits=logits, prefill_ms=prefill_ms,
                       decode_tok_s=decode_tok_s, prog=prog, sites=sites,
                       modelled_speedup=sp, launches=launches, tuning=tuning,
                       prefill_ms_runs=prefill_ms_runs,
                       decode_tok_s_runs=decode_tok_s_runs)


def main(argv=None) -> ServeResult:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
