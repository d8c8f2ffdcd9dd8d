#!/usr/bin/env python3
"""Time K3 (the SSD chunk scan) on one NVIDIA GPU, pass by pass.

  python3 tools/k3_probe.py [--src DIR] [--site S ...] [--variant V ...]
                            [--ring R ...] [--segments K ...] [--label NAME]

Shapes: the xlstm_1_3b ``mlstm.chunk_scan`` site as the measurement
runner builds it (G=1, S=8192, P=N=1024) at every chunk of the action
space (site ``xlstm``), and a Mamba-2 head of jamba_v0_1_52b's
``ssm.chunk_scan`` site (G=1, S=262144, P=64, N=16, Q=256; site
``mamba2``), inputs as ``chip_smoke.k3_inputs`` makes them.  For each,
one line: the device ms of each kernel of one call and their sum
(``torch.profiler``, ``chip_smoke.device_ms_by_kernel``), the ms of one
call over 20 back to back (CUDA events, ``chip_smoke.time_ms_over``), the
bound (``chip_smoke.k3_work``) and the share of it the summed device ms
reach, and the error against the plain version.

``--src`` imports ``repro_torch`` from another checkout's ``src/`` (the
parent commit's, unpacked with ``git archive``), so that two versions are
timed on one card in one call.  ``--variant`` (``three_pass``, ``walk``),
``--ring`` (the deepest ring of a pass) and ``--segments`` (the state
pass's segments a chain, a power of two up to 32; three_pass only) each
replace the plan's choice, one setting after another, by standing in for
``ops.chunk_launch_plan``.  Prints the card's name and power limit first,
and each line also as JSON.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--site", nargs="*", default=["xlstm", "mamba2"])
    ap.add_argument("--variant", nargs="*", default=[])
    ap.add_argument("--ring", type=int, nargs="*", default=[])
    ap.add_argument("--segments", type=int, nargs="*", default=[])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), args.src]
    import chip_smoke as cs
    from repro_torch.configs.neurovec import DEFAULT as NV
    from repro_torch.kernels import chunk_scan as kcs
    from repro_torch.kernels import ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; repro_torch from {Path(kcs.__file__).parents[2]}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    xl = cs.k3_inputs(1, 8192, 1024, 1024, gen)
    m = cs.MAMBA
    mamba = cs.k3_inputs(m["G"], m["S"], m["P"], m["N"], gen)
    cases = [("xlstm", xl, q) for q in NV.chunk_choices]
    cases.append(("mamba2", mamba, m["Q"]))
    cases = [c for c in cases if c[0] in args.site]
    settings = [(v, r, k) for v in args.variant or [None]
                for r in args.ring or [None] for k in args.segments or [None]]
    planner = getattr(ops, "chunk_launch_plan", None)

    def forced(variant, ring, segments):
        def plan(G, S, P, N, Q):
            p = ops._chunk_plan(G, S, P, N, Q, ring or ops.CHUNK_RING,
                                variant)
            if segments is None or p is None or p.variant != "three_pass":
                return p
            return p._replace(segments=segments, scan_grid=-(
                -G * p.P_pad * N // (ops.SCAN_THREADS // segments)))
        return plan

    for label, (x, Bm, Cm, la), Q in cases:
        G, S, P = x.shape
        N = Bm.shape[-1]
        yp = kcs.chunk_scan_plain(x, Bm, Cm, la, chunk=Q).float()
        for variant, ring, segments in settings:
            if (variant, ring, segments) != (None, None, None):
                ops.chunk_launch_plan = forced(variant, ring, segments)
            plan = ops.chunk_launch_plan(G, S, P, N, Q) if planner else None
            ring = ring or getattr(ops, "CHUNK_RING", None)

            def call():
                return ops.chunk_scan(x, Bm, Cm, la, chunk=Q)
            y = call().float()
            rel = float((y - yp).abs().max() / yp.abs().max())
            del y
            passes = cs.device_ms_by_kernel(call, reps=10)
            dev = sum(passes.values())
            ms = cs.time_ms_over(call, [()])
            b, by = cs.bound_s(*cs.k3_work(S, P, N, Q))
            rec = {"version": args.label, "site": label, "G": G, "S": S,
                   "P": P, "N": N, "Q": Q, "ring": ring,
                   "variant": plan.variant if plan else None,
                   "segments": plan.segments if plan else None,
                   "device_ms_by_pass": passes, "device_ms": round(dev, 4),
                   "ms": round(ms, 4), "bound_ms": round(b * 1e3, 4),
                   "bound_by": by,
                   "share_of_bound": round(b * 1e3 / dev, 4) if dev else None,
                   "rel_err": rel}
            print(f"[k3_probe{':' + args.label if args.label else ''}] "
                  f"{label} Q={Q} variant={rec['variant']} ring={ring} "
                  f"segments={rec['segments']} "
                  f"device_ms={dev:.4f} "
                  f"{passes} ms={ms:.4f} bound_ms={b * 1e3:.4f} ({by}) "
                  f"share={rec['share_of_bound']} rel_err={rel:.2e}",
                  flush=True)
            print(json.dumps(rec), flush=True)
        del yp
    return 0


if __name__ == "__main__":
    sys.exit(main())
