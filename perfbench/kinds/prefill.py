"""Closed-loop prefill of a tuned program: one client, back to back.

Set-up builds the model from the configuration, draws its weights and a
pool of prompt batches from the seed on the device, extracts the serve
sites, makes the tile program through the facade (the traffic file's
agent, fixed seed, on the cost model under the card's launch rule) and
warms the cell's one shape up.  The window then runs
``train.steps.make_prefill_step`` under the program, cycling through the
pool, each prefill on a freshly zeroed cache, until ``seconds`` have
passed.  With ``trace`` the first prefills of the window run under
``torch.profiler`` (one warm-up step, then ``trace_prefills``).

Afterwards the outputs kept from the window (:class:`Kept`: each pool
batch's first, then a sample drawn from the seed) are compared row by
row with the plain reference's logits for their batch
(:mod:`perfbench.reference`), after the peak memory has been read and
the cache freed: the median row's relative error and the worst row's,
each against the configuration's limit where it gives one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import random
import statistics
import sys
import time

import torch

from perfbench import harness, reference, timeline, weights


def port_config(cell: harness.Cell):
    """The program's ``ModelConfig`` at the configuration file's sizes."""
    from repro_torch.configs import get_config
    base = get_config(cell.config["port_arch"])
    s = cell.spec
    kw = dict(name=cell.config_name, n_layers=s.n_layers,
              d_model=s.d_model, n_heads=s.n_heads, d_ff=s.d_ff,
              vocab_size=s.vocab, rope_theta=s.rope_theta, norm=s.norm,
              act={"gelu_tanh": "gelu", "silu": "silu"}[s.act],
              dtype=cell.config.get("torch_dtype", base.dtype))
    if s.mla:   # MLA replaces the GQA heads: their nominal sizes stay
        kw.update(mla=True, kv_lora_rank=s.kv_lora_rank,
                  q_lora_rank=s.q_lora_rank, qk_nope_dim=s.qk_nope_dim,
                  qk_rope_dim=s.qk_rope_dim, v_head_dim=s.v_head_dim)
    else:
        kw.update(n_kv_heads=s.n_kv_heads, head_dim=s.head_dim)
    if s.moe:
        kw.update(n_experts=s.n_experts,
                  n_shared_experts=s.n_shared_experts,
                  moe_top_k=s.top_k, moe_d_ff=s.moe_d_ff)
    return dataclasses.replace(base, **kw)


def program_hash(prog) -> str:
    return hashlib.sha256(json.dumps(
        sorted((k, list(v)) for k, v in prog.tiles.items())).encode()
    ).hexdigest()[:16]


def _log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def build(cell: harness.Cell):
    """The program's model at the configuration's sizes."""
    from repro_torch.models.lm import build_model
    return build_model(port_config(cell))


def draw(cell: harness.Cell, model, seed: int, dev):
    """The run's weights and its pool of prompt batches, from ``seed``."""
    tr = cell.traffic
    gen = weights.generator(seed, dev)
    params = weights.draw_params(model.init(device="meta"), gen, dev)
    prompts = weights.draw_prompts(gen, dev, int(tr["pool"]),
                                   int(tr["batch"]), int(tr["prompt_len"]),
                                   cell.spec.vocab)
    return params, prompts


def tune(cell: harness.Cell, model, device: str):
    """``(program, sites, seconds)``: the serve sites, fitted and tuned
    through the facade by the traffic file's agent, and the seconds of
    the fit and the tune."""
    from repro_torch.api import NeuroVectorizer
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.core.agents import make_agent
    from repro_torch.core.env import CostModelEnv
    from repro_torch.core.extractor import extract_serve_sites
    tr = cell.traffic
    sites = extract_serve_sites(model, int(tr["batch"]),
                                int(tr["prompt_len"]), int(tr["gen"]))
    nv = NeuroVectorizer(
        DEFAULT, agent=make_agent(tr["agent"], DEFAULT,
                                  seed=int(tr["agent_seed"]), device=device),
        oracle=CostModelEnv(DEFAULT, legality="h100"), metrics=False,
        device=device)
    try:
        t = time.perf_counter()
        nv.fit(sites, total_steps=int(tr["fit_steps"]))
        prog = nv.tune_sites(sites)
        return prog, sites, time.perf_counter() - t
    finally:
        nv.close()


class Kept:
    """The window's outputs kept for the check, copied into buffers made
    in set-up, so that the window allocates nothing: every pool batch's
    first output, then each output whose prefill number is ``phase``
    modulo ``STRIDE`` (``phase`` drawn from the seed), while slots
    last."""

    STRIDE = 5                  # prime to the pool: every batch recurs
    ROUNDS = 6                  # slots: this many times the pool

    def __init__(self, pool: int, seed: int, shape, dev):
        self.pool = pool
        self.phase = random.Random(seed).randrange(self.STRIDE)
        self.buf = torch.empty((self.ROUNDS * pool,) + tuple(shape),
                               dtype=torch.float32, device=dev)
        self.batch: list = []           # the pool batch of each slot

    def offer(self, n: int, i: int, logits) -> None:
        """Prefill number ``n`` of pool batch ``i`` returned ``logits``."""
        if len(self.batch) < len(self.buf) and (
                n < self.pool or n % self.STRIDE == self.phase):
            self.buf[len(self.batch)].copy_(logits)
            self.batch.append(i)

    def outs(self) -> dict:
        """Pool batch -> its kept outputs."""
        out: dict = {}
        for j, i in enumerate(self.batch):
            out.setdefault(i, []).append(self.buf[j])
        return out


class Prefill:
    """The timed path: one prefill of a pool batch on a freshly zeroed
    cache, through ``train.steps.make_prefill_step``, finished on the
    device when it returns."""

    def __init__(self, cell: harness.Cell, model, params, prompts, dev):
        from repro_torch.core.extractor import serve_ctx
        from repro_torch.train import steps
        tr = cell.traffic
        self.step = steps.make_prefill_step(model)
        self.cache = model.make_cache(
            int(tr["batch"]), serve_ctx(model.cfg, int(tr["prompt_len"]),
                                        int(tr["gen"])), device=dev)
        self.buffers = [v for slot in self.cache["caches"]
                        for v in slot.values()]
        self.params, self.prompts = params, prompts
        self.sync = ((lambda: torch.cuda.synchronize(dev))
                     if dev.type == "cuda" else (lambda: None))

    def __call__(self, i: int):
        for b in self.buffers:          # a fresh cache for every prefill
            b.zero_()
        logits, _ = self.step(self.params, {"tokens": self.prompts[i]},
                              self.cache)
        self.sync()
        return logits

    def free(self):
        del self.cache, self.buffers


def run(cell: harness.Cell, *, seed: int, seconds: float, trace: bool,
        device: str, t_start: float) -> harness.Record:
    from repro_torch.core.vectorizer import inject
    tr = cell.traffic
    B, S, pool = int(tr["batch"]), int(tr["prompt_len"]), int(tr["pool"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    t = time.perf_counter()
    model = build(cell)
    params, prompts = draw(cell, model, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    t_weights = time.perf_counter() - t
    t = time.perf_counter()
    prog, sites, tune_s = tune(cell, model, device)
    t_sites = time.perf_counter() - t - tune_s
    _log(f"program: {len(prog.tiles)} tiles over {len(sites)} sites, "
         f"agent {tr['agent']} (seed {tr['agent_seed']}), sha256 "
         f"{program_hash(prog)}")

    prefill = Prefill(cell, model, params, prompts, dev)
    kept = Kept(pool, seed, (B, cell.spec.vocab), dev)
    n_trace = int(tr["trace_prefills"]) if trace else 0
    lat, events = [], None
    after = [0, 0.0]
    with torch.inference_mode(), inject(prog):
        t = time.perf_counter()
        for _ in range(int(tr["warmup"])):
            prefill(0)
        t_warm = time.perf_counter() - t
        prof = _profiler(n_trace, cuda) if n_trace else None
        n = 0
        t_w0 = time.perf_counter()
        setup_s = t_w0 - t_start
        try:
            while True:
                i = n % pool
                t0 = time.perf_counter()
                with torch.profiler.record_function(timeline.WINDOW_MARK):
                    logits = prefill(i)
                t1 = time.perf_counter()
                lat.append(t1 - t0)
                kept.offer(n, i, logits)
                n += 1
                if prof is not None:
                    prof.step()
                    if n == n_trace + 1:        # the warm-up step, then N
                        prof.stop()
                        events = timeline.from_profiler(prof)
                        prof, t_after, n_after = None, time.perf_counter(), n
                # a traced run also ends its trace, and one prefill after
                if t1 - t_w0 >= seconds and prof is None and (
                        not n_trace or n > n_after):
                    break
        finally:
            if prof is not None:        # the window failed inside its trace
                prof.stop()
        window_s = t1 - t_w0
        if events is not None:
            after = [n - n_after, t1 - t_after]
    _log(f"set-up {setup_s:.3f} s: weights {t_weights:.3f}, sites "
         f"{t_sites:.3f}, fit and tune {tune_s:.3f}, warm-up {t_warm:.3f}; "
         f"window {window_s:.3f} s, {n} prefills")

    mem = torch.cuda.max_memory_allocated(dev) if cuda else 0
    prefill.free()
    del logits
    rec = harness.Record(
        spec=cell.spec, batch=B, seq=S, setup_s=setup_s, window_s=window_s,
        latencies_s=lat, tune_s=tune_s, after_trace=tuple(after),
        device={"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(mem)})
    if events is not None:
        t0, t1, k = timeline.window(events)
        rec.trace = harness.Trace(events, t0, t1, k)
        rec.device["busy_s"] = timeline.busy_us(events, t0, t1) * 1e-6
        rec.device["window_s"] = (t1 - t0) * 1e-6
    rec.checks = judge(cell, errors(cell, params, prompts, kept.outs()))
    rec.correct = all(v <= lim for v, lim in rec.checks.values())
    return rec


def _profiler(n_trace: int, cuda: bool):
    """A started ``torch.profiler`` over one warm-up step and ``n_trace``
    traced ones."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts, schedule=schedule(
        wait=0, warmup=1, active=n_trace, repeat=1))
    prof.start()
    return prof


def errors(cell: harness.Cell, params, prompts, outs) -> list:
    """Every checked output row's relative error against the reference's
    logits for its batch (``reference.rel_err``), each time the window
    produced it; ``inf`` for a row that is not finite."""
    out = []
    for i, got in outs.items():
        if not got:
            continue
        ref = reference.prefill_logits(cell.spec, params, prompts[i])
        for logits in got:
            e = reference.rel_err(logits, ref)
            out += [float(x) if math.isfinite(x) else math.inf
                    for x in e.tolist()]
    return out


def numbers(errs: list) -> dict:
    """The numbers the check compares: the median row's error and the
    worst row's (``inf`` where no row was checked)."""
    if not errs:
        return {"logits_err_median": math.inf, "logits_err_max": math.inf}
    return {"logits_err_median": statistics.median(errs),
            "logits_err_max": max(errs)}


def judge(cell: harness.Cell, errs: list) -> dict:
    """``{name: (value, limit)}`` for each number the configuration gives
    a limit."""
    lims = cell.config["limits"]
    return {k: (v, float(lims[k])) for k, v in numbers(errs).items()
            if k in lims}
