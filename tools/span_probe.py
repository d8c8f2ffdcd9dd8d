#!/usr/bin/env python3
"""Read a benchmark cell's span metrics from the program's own tracer.

  python3 tools/span_probe.py --workload <cell> --seed <n> [--prefills 10]
                              [--root DIR] [--device cuda]

Sets the cell up as ``perfbench/kinds/prefill.py`` does (weights and
prompts from the seed, site extraction, the facade's fit and tune, the
warm-up), with an in-memory ``repro_torch.obs.Tracer`` active over the
extraction and the fit and tune; then runs ``--prefills`` prefills under
``torch.profiler`` (after one warm-up step) with another active over
exactly those prefills.  Prints the card's name and power limit, then
one JSON line:

* ``sites_s``: the ``nv.extract`` span's seconds (site extraction);
* ``tune_s``: the facade's fit and tune, on the host's clock;
* ``idle_python_ms``: device idle ms a prefill whose innermost host range
  is an ``nv.*`` span (``perfbench/metrics/idle_python_ms.py``);
* ``moe_route_ms``: device ms a prefill of the kernels launched inside
  ``nv.moe.route`` (``perfbench.spans``);
* ``moe_slot_use_pct``: the ``moe.kept`` counter over the expert slots
  the prefills compute (``perfbench.spans.moe_slots``);
* ``device_ms_by_span``, ``idle_ms_by_host_op``: a prefill's device ms
  by the innermost ``nv.*`` range open at each launch, and its idle ms by
  the innermost host op, largest first;
* ``window_ms``: a traced prefill's host ms, tracer and profiler on.

``--root`` names another checkout-like root holding ``BENCHMARK.json``
and ``perfbench/`` (a test's tiny cell); ``--device cpu`` rehearses on the
CPU, where the device readings are left out.  Imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--prefills", type=int, default=10)
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def probe(args) -> dict:
    import torch
    from perfbench import harness, spans, timeline
    from repro_torch.core.vectorizer import inject
    from repro_torch.obs import Tracer, tracing
    manifest = harness.load_manifest(args.root)
    cell = harness.load_cell(manifest, args.workload, args.root)
    kind = harness.load_module(args.root / "perfbench" / "kinds"
                               / f"{cell.traffic['kind']}.py")
    tr = cell.traffic
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    model = kind.build(cell)
    params, prompts = kind.draw(cell, model, args.seed, dev)
    setup = Tracer()
    with tracing(setup):
        prog, _, tune_s = kind.tune(cell, model, args.device)
    extract = [r for r in setup.records() if r["name"] == "nv.extract"]
    prefill = kind.Prefill(cell, model, params, prompts, dev)
    n, pool = args.prefills, int(tr["pool"])
    step = Tracer()
    with torch.inference_mode(), inject(prog):
        for _ in range(int(tr["warmup"])):
            prefill(0)
        prof = kind._profiler(n, cuda)
        prefill(0)                       # the profiler's warm-up step
        prof.step()
        with tracing(step):
            for i in range(n):
                with torch.profiler.record_function(timeline.WINDOW_MARK):
                    prefill((i + 1) % pool)
                prof.step()
        prof.stop()
    events = timeline.from_profiler(prof)
    t0, t1, k = timeline.window(events)
    rec = harness.Record(spec=cell.spec, batch=int(tr["batch"]),
                         seq=int(tr["prompt_len"]), setup_s=0.0,
                         window_s=0.0, latencies_s=[])
    rec.trace = harness.Trace(events, t0, t1, k)
    by_span = spans.device_us_by_span(spans.launched(prof), events, t0, t1)
    tokens = rec.batch * rec.seq
    kept = step.counters().get("moe.kept")
    slots = spans.moe_slots(cell.spec, tokens) * k
    idle = harness.load_module(args.root / "perfbench" / "metrics"
                               / "idle_python_ms.py").read(rec)
    out = {"workload": args.workload, "seed": args.seed, "prefills": k,
           "sites_s": extract[0]["dur"] if extract else None,
           "tune_s": tune_s, "idle_python_ms": idle,
           "moe_route_ms": (by_span["nv.moe.route"] * 1e-3 / k
                            if by_span.get("nv.moe.route") else None),
           "moe_slot_use_pct": (100.0 * kept / slots
                                if kept is not None and slots else None),
           "device_ms_by_span": timeline.top(by_span, 12, 1e-3 / k),
           "idle_ms_by_host_op": timeline.top(
               timeline.idle_by_host_op(events, t0, t1), 12, 1e-3 / k),
           "window_ms": (t1 - t0) * 1e-3 / k if k else None,
           "spans_a_prefill": sum(
               1 for r in step.records() if r["type"] == "span") / k,
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    prefill.free()
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path[:0] = [str(args.root), str(ROOT), str(ROOT / "src")]
    build = args.root / "build" / "perfbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    print(f"card: {card()}", flush=True)
    t = time.perf_counter()
    out = probe(args)
    out["probe_s"] = time.perf_counter() - t
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
