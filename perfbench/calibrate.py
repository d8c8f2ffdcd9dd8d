"""Read the two ends of a cell's correctness limit on the card: the
program's relative logit error and the lower-precision control's, on
many seeds in one process (the benchmark's own runs do not run the
control).

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 3 ...

For each seed the weights and the prompt pool are drawn as a run draws
them, the pool's batches are prefilled through the timed path under
the cell's tile program (tuned once: it does not depend on the seed), and
both the program's logits and the control's (the reference with every
product's operands in float8 e4m3, ``reference.prefill_logits(...,
quant="fp8")``) are compared with the f32 reference, by the numbers a
run compares.  ``--look 1`` adds the f32 reference against itself with
its routing's near-ties moved (an MoE model's look at why its worst row
swings).  One JSON line a seed, and a summary line with each number's
range: the program's largest is the limit's lower end, the control's
smallest its upper end.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _near_ties_moved(cell, params, tokens, seed):
    """The f32 reference with each router logit moved by a relative
    2^-8 (bf16's rounding) of seeded noise: the routing choices that sit
    on a near-tie flip, as they may between the program and the
    reference, and nothing else changes."""
    import torch
    from perfbench import reference
    route = reference.route
    g = torch.Generator(device=tokens.device).manual_seed(seed)

    def moved(spec, logits):
        noise = torch.randn(logits.shape, generator=g, device=logits.device)
        return route(spec, logits * (1 + 2.0 ** -8 * noise))
    reference.route = moved
    try:
        return reference.prefill_logits(cell.spec, params, tokens)
    finally:
        reference.route = route


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="read the control on the first this many seeds")
    ap.add_argument("--look", type=int, default=0,
                    help="1: also read the f32 reference against itself "
                    "with its router logits moved by bf16's rounding")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import harness, reference
    from repro_torch.core.vectorizer import inject
    cell = harness.load_cell(harness.load_manifest(ROOT), args.workload,
                             ROOT)
    kind = harness.load_module(ROOT / "perfbench" / "kinds"
                               / f"{cell.traffic['kind']}.py")
    dev = torch.device("cuda")
    model = kind.build(cell)
    prog, _, _ = kind.tune(cell, model, "cuda")
    rows = {"program": {}, "control": {}, "look": {}}
    for seed in args.seeds:
        t = time.perf_counter()
        params, prompts = kind.draw(cell, model, seed, dev)
        prefill = kind.Prefill(cell, model, params, prompts, dev)
        idx = range(int(cell.traffic["pool"]))
        with torch.inference_mode(), inject(prog):
            outs = {i: [prefill(i)] for i in idx}
        prefill.free()
        line = {"workload": args.workload, "seed": seed,
                "program": kind.numbers(kind.errors(cell, params, prompts,
                                                    outs))}
        if seed in args.seeds[:args.control_seeds]:
            line["control"] = kind.numbers(kind.errors(
                cell, params, prompts,
                {i: [reference.prefill_logits(cell.spec, params, prompts[i],
                                              quant="fp8")] for i in idx}))
        if args.look:
            line["look"] = kind.numbers(kind.errors(
                cell, params, prompts, {i: [_near_ties_moved(
                    cell, params, prompts[i], seed)] for i in idx}))
        for k in rows:
            for name, v in line.get(k, {}).items():
                rows[k].setdefault(name, []).append(v)
        line["s"] = round(time.perf_counter() - t, 2)
        print(json.dumps(line), flush=True)
        del params, prompts, outs, prefill
    summary = {"workload": args.workload, "seeds": len(args.seeds),
               "device": torch.cuda.get_device_name(dev)}
    for k, by in rows.items():
        for name, vals in by.items():
            summary[f"{k}.{name}"] = [min(vals), max(vals)]
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
