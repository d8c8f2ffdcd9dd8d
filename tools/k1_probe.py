#!/usr/bin/env python3
"""Time K1's tiles of 16 and 32 rows on one NVIDIA GPU, at each cluster
size of the w multicast, beside ``torch.matmul`` and the baseline tile.

  python3 tools/k1_probe.py [--shapes NAME ...] [--tiles BM,BN,BK ...]
      [--turns N] [--no-phase3] [--src DIR --label NAME]

Shapes: the qwen3_8b prefill projections (M = 2048): q/o 2048x4096x4096,
k/v 2048x1024x4096, gate/up 2048x12288x4096, down 2048x4096x12288; or
any given as ``MxNxK``.

1. Clusters.  Each tile below 64 CTA rows (default bm 8, 16, 32 by bn
   128, 256, 512, bk 1024; ``--tiles`` for others) at clusters of C = 1
   and 2 CTAs (1 alone where the plan splits K), C passed to the launch
   as an argument (``kernels/matmul.py:matmul_cuda(..., cluster=C)``),
   in turns (C = 1, 2, then 2, 1, ``--turns`` times; the mean is printed
   beside each reading): the device ms of one launch
   (``torch.profiler``, ``chip_smoke.device_ms_by_kernel``), the bytes
   TMA moves into the SMs (``chip_smoke.k1_operand_bytes``: a w slab once
   a cluster) and their rate, the share of the bound (``chip_smoke.
   bound_s``), and ``torch.matmul``'s and the baseline tile's device ms
   timed the same way.  The plan's choice of C
   (``kernels/ops.py:MM_CLUSTER_MIN_K``) comes from these lines.
2. Phase-3 lines.  ``chip_smoke.k1_check`` at PPO's tile (32, 128,
   1024), the 16-row tile (16, 256, 1024) and the baseline tile at each
   shape.

``--src DIR`` takes another checkout's root (an earlier commit unpacked with
``git archive`` under ``build/``, which git ignores) and runs part 2 alone
with that checkout's ``chip_smoke`` and ``repro_torch``, so that two
versions are timed on one card in one call.  Prints the card's name and
power limit first.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SHAPES = {"q/o": (2048, 4096, 4096), "k/v": (2048, 1024, 4096),
          "gate/up": (2048, 12288, 4096), "down": (2048, 4096, 12288)}
PHASE3_TILES = ((32, 128, 1024), (16, 256, 1024))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES))
    ap.add_argument("--src", default=None,
                    help="another checkout's root: phase-3 lines only")
    ap.add_argument("--label", default="")
    ap.add_argument("--tiles", nargs="*", default=None,
                    help="tiles below 64 rows to time, as BM,BN,BK")
    ap.add_argument("--turns", type=int, default=1,
                    help="rounds of C = 1, 2, 2, 1")
    ap.add_argument("--no-phase3", action="store_true",
                    help="skip the phase-3 lines")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.src).resolve() if args.src else ROOT
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    from repro_torch.core.costmodel import baseline_matmul_tiles
    from repro_torch.kernels import build
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    tile_list = ([tuple(int(v) for v in t.split(",")) for t in args.tiles]
                 if args.tiles else
                 [(bm, bn, 1024) for bm in (8, 16, 32)
                  for bn in (128, 256, 512)])
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; repro_torch from {Path(kmm.__file__).parents[2]}",
          flush=True)
    build.build_all(["matmul"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    label = f"{args.label} " if args.label else ""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in args.shapes:
        M, N, K = SHAPES.get(name) or map(int, name.split("x"))
        base = tuple(baseline_matmul_tiles(M, N, K))
        if args.src is None:
            x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
            w = torch.randn((K, N), generator=gen, device="cuda").bfloat16()
            want = x.float() @ w.float()
            bound, by = cs.bound_s(2.0 * M * N * K,
                                   2.0 * (M * K + K * N + M * N))

            def dev_ms(fn):
                return sum(cs.device_ms_by_kernel(fn).values())
            lib = dev_ms(lambda: torch.matmul(x, w))
            base_ms = dev_ms(lambda: kmm.matmul_cuda(x, w, *base))
            print(f"[k1probe:{label}{name}] M={M} N={N} K={K} bound_ms="
                  f"{bound * 1e3:.4f} ({by}) torch.matmul device_ms="
                  f"{lib:.4f} baseline {base} device_ms={base_ms:.4f}",
                  flush=True)
            for tiles in tile_list:
                own = ops.matmul_launch_plan(M, N, K, tiles, sms)
                # a split (a small grid) takes no cluster
                cls = ops.MM_CLUSTERS if own.variant == "tma_wgmma" \
                    else (1,)
                times = {c: [] for c in cls}
                for c in (cls + cls[::-1]) * args.turns:
                    y = kmm.matmul_cuda(x, w, *tiles, cluster=c)
                    rel = float((y.float() - want).abs().max()
                                / want.abs().max())
                    if rel >= cs.K1_TOL:
                        cs.fail(f"{name} {tiles} C={c}: rel err {rel}")
                    times[c].append(dev_ms(
                        lambda: kmm.matmul_cuda(x, w, *tiles,
                                                cluster=c)))
                for c in cls:
                    plan = ops.matmul_launch_plan(M, N, K, tiles, sms,
                                                  cluster=c)
                    nbytes = cs.k1_operand_bytes(plan, K)
                    ms = sum(times[c]) / len(times[c])
                    rec = {"shape": name, "tiles": tiles, "C": c,
                           "plan_C": own.cluster,
                           "CTAs/SM": plan.occupancy,
                           "device_ms": ms,
                           "turns": [round(t, 4) for t in times[c]],
                           "bytes_into_SMs": nbytes,
                           "TB_s": nbytes / (ms * 1e-3) / 1e12,
                           "share_of_bound": bound * 1e3 / ms,
                           "vs_torch.matmul": ms / lib,
                           "vs_baseline": ms / base_ms}
                    print(f"[k1probe:{label}{name}] tiles={tiles} "
                          f"C={c}{' (plan)' if c == rec['plan_C'] else ''}"
                          f" device_ms={ms:.4f} {rec['turns']} "
                          f"bytes_into_SMs={nbytes / 1e6:.1f} MB "
                          f"({rec['TB_s']:.2f} TB/s) share_of_bound="
                          f"{rec['share_of_bound']:.3f} "
                          f"vs_torch.matmul={rec['vs_torch.matmul']:.2f}x "
                          f"vs_baseline={rec['vs_baseline']:.2f}x",
                          flush=True)
                    print(json.dumps(rec), flush=True)
            del x, w, want
        for tiles in () if args.no_phase3 else PHASE3_TILES + (base,):
            cs.k1_check((M, N, K, False), tiles, f"{label}probe {name}",
                        gen)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
