#!/usr/bin/env python3
"""Time K1's f32 variant (the MoE router) on one NVIDIA GPU.

  python3 tools/k1f32_probe.py [--src DIR] [--label NAME] [--only NAME ...]

Shapes: the llama4_maverick_400b and jamba_v0_1_52b routers
(``moe.router``) at prefill (M = 2048) and decode (M = 4) under the
baseline tiles, PPO's router tile (32, 128, 1024) at 2048x128x5120, and
the corpus's f32 sites b.f32 (2048x2048x2048) and m.fft (4096x128x128)
under the baseline tiles.  Each shape prints the line
``chip_smoke.k1_f32_check`` prints (the plan, the error against the f32
product with TF32 off, ms over 20 calls back to back, the device ms of one
launch, the plain version's and ``torch.matmul``'s f32 ms, the bound at
the FP32 rate and its share), then the same as JSON.

``--src`` imports ``repro_torch`` from another checkout's ``src/`` (the
parent commit's, unpacked with ``git archive``), so that two versions are
timed on one card in one call.  Prints the card's name and power limit
first.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SHAPES = {          # name: ((M, N, K, transposed w), tiles or None)
    "llama4 prefill": ((2048, 128, 5120, False), None),
    "llama4 decode": ((4, 128, 5120, False), None),
    "jamba prefill": ((2048, 16, 4096, False), None),
    "jamba decode": ((4, 16, 4096, False), None),
    "ppo router tile": ((2048, 128, 5120, False), (32, 128, 1024)),
    "b.f32": ((2048, 2048, 2048, False), None),
    "m.fft": ((4096, 128, 128, False), None),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--only", nargs="*", default=list(SHAPES))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1f32_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), args.src]
    import chip_smoke as cs
    from repro_torch.core.costmodel import baseline_matmul_tiles
    from repro_torch.kernels import build
    from repro_torch.kernels import matmul as kmm
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; repro_torch from {Path(kmm.__file__).parents[2]}",
          flush=True)
    # the f32 variant's own source, or K1's whole one before it had one
    build.build_all(["matmul_f32" if "matmul_f32" in build.SOURCES
                     else "matmul"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in args.only:
        shape, tiles = SHAPES[name]
        tiles = tiles or baseline_matmul_tiles(*shape[:3])
        r = cs.k1_f32_check(shape, tiles, f"{args.label} {name}".strip(),
                            gen)
        print(json.dumps({"label": args.label, "shape": name,
                          "tiles": list(tiles), **cs.f32_summary(r)},
                         default=str), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
