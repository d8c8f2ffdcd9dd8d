"""Serving driver: batched prefill + greedy decode with a KV cache, under a
tile program a PPO agent tuned (the port of ``repro/launch/serve.py``).

The paper's train-once, tune-and-deploy loop (§4.2): extract the kernel
sites of the prefill and decode steps, fit the PPO agent against the
analytic oracle (``legality="h100"``: tiles the Hopper kernels cannot
launch are illegal), greedily tune the sites into a ``TileProgram`` (the
greedy pick taken over the legal tiles), and with ``--inject`` run every
matmul and prefill-attention site through the hand-written kernels with
exactly those tiles: a tile they cannot launch (from ``--tiles``) stops the
run with ``TileError``.  Runs on the GPU unless ``--device cpu`` is given::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_8b --full \\
      --batch 4 --prompt-len 512 --gen 16 --autotune ppo --inject

After one untimed pass, prefill ms is the median of ``PREFILL_REPS`` timed
prefills and decode tokens/s the median of ``DECODE_REPS`` timed decode
windows.  The printed speedup is the cost model's (TPU v5e constants), not
an H100 measurement.
"""
from __future__ import annotations

import argparse
import contextlib
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.neurovec import DEFAULT
from repro_torch.core.env import CostModelEnv
from repro_torch.core.extractor import extract_serve_sites
from repro_torch.core.vectorizer import (TileProgram, inject,
                                         program_speedup, tune)
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.models.lm import build_model
from repro_torch.train.steps import make_prefill_step, make_serve_step

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


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3_8b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths and depth (default: the "
                         "reduced test config)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--autotune", choices=("ppo",), default=None,
                    help="tune the serving kernels' tiles with this agent")
    ap.add_argument("--autotune-steps", type=int, default=2000,
                    help="RL budget for --autotune ppo")
    ap.add_argument("--tiles", default=None,
                    help="load a saved TileProgram instead of tuning")
    ap.add_argument("--save-tiles", default=None)
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
    return args


def _tile_plan(args, model, device):
    """Extract the serving sites and tune (or load) a TileProgram."""
    sites = extract_serve_sites(model, args.batch, args.prompt_len, args.gen)
    env = CostModelEnv(DEFAULT, legality="h100")
    if args.tiles:
        prog = TileProgram.load(args.tiles)
        missing = sorted({s.site for s in sites if s.key() not in prog.tiles})
        if missing:
            print(f"[serve] WARNING: the tile plan misses sites that run at "
                  f"baseline tiles: {', '.join(missing)}", file=sys.stderr)
    else:
        from repro_torch.core.agents.ppo import PPOAgent
        agent = PPOAgent(DEFAULT, seed=0, device=str(device))
        agent.fit(sites, env, total_steps=args.autotune_steps)
        prog = tune(sites, agent, env.space, env)
        if args.save_tiles:
            prog.save(args.save_tiles)
    sp = program_speedup(prog, sites, env)
    print(f"[serve] tile plan: {len(prog.tiles)} tiles over {len(sites)} "
          f"sites, TPU-v5e-modelled speedup {sp:.3f}x (cost model, not an "
          f"H100 measurement)")
    return prog, sites, sp


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counts():
    return {"matmul": kmm.launches, "flash_attention": kfa.launches}


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


def run(args, params=None, prompts=None) -> ServeResult:
    """Serve one batch.  ``params`` (a parameter tree on ``args.device``)
    and ``prompts`` ((B, prompt_len) ints) replace the seeded ones."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if args.inject and device.type == "cuda" and (
            cfg.dtype != "bfloat16" or cfg.head_dim != kfa.HEAD_DIM):
        raise ValueError(
            f"{cfg.name}: the CUDA kernels take bfloat16 and head dim "
            f"{kfa.HEAD_DIM}, the config has {cfg.dtype} and "
            f"{cfg.head_dim} (the reduced test config); pass --full")
    model = build_model(cfg)
    if params is None:
        params = model.init(seed=0, device=device)
    B = args.batch
    if prompts is None:
        gen = torch.Generator().manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                                generator=gen)
    prompts = torch.as_tensor(prompts, dtype=torch.long).to(device)
    cache = model.make_cache(B, args.prompt_len + args.gen, device=device)
    prefill = make_prefill_step(model)
    serve = make_serve_step(model)

    prog, sites, sp = None, [], None
    if args.autotune or args.tiles:
        prog, sites, sp = _tile_plan(args, model, device)
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
        # each pass rewrites the same cache slots with the same values
        prefill_s, decode_s = [], []
        for _ in range(PREFILL_REPS):
            _sync(device)
            t0 = time.perf_counter()
            logits, cache = prefill(params, {"tokens": prompts}, cache)
            _sync(device)
            prefill_s.append(time.perf_counter() - t0)
        for _ in range(DECODE_REPS):
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
                       modelled_speedup=sp, launches=launches,
                       prefill_ms_runs=prefill_ms_runs,
                       decode_tok_s_runs=decode_tok_s_runs)


def main(argv=None) -> ServeResult:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
