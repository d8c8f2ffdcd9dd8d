#!/usr/bin/env python3
"""Time K2 (flash attention) on one NVIDIA GPU: each depth of its TMA
ring beside ``scaled_dot_product_attention`` on the same inputs, the cost
of a tile apart from its key stages, and the host's cost of one call.

  python3 tools/k2_probe.py

1. Ring depths.  Shapes: the Qwen3-8B prefill in the served layout (B=4,
   H=32, Hkv=8, S=512, D=128, v the transposed view of its projection),
   causal and not, and the measurement runner's (B=1, H=Hkv=128,
   contiguous).  For each legal (bq, bkv) of the action space, each ring
   depth is timed in turns (depths 1, 2, 3, then again in reverse): the ms
   of one call over 20 back to back (CUDA events,
   ``chip_smoke.time_ms_over``) and the device ms of one launch
   (``torch.profiler``, ``chip_smoke.device_ms_by_kernel``).
2. Stages against tiles.  Non-causal, 512 tiles each, S = 512, 1024,
   2048 (4, 8, 16 key stages a tile), at tiles (128, 128) (two consumer
   warpgroups) and (64, 128) (one).  The device ms is about (tiles / SMs)
   * (F + stages * P): a fit gives the cost of a tile apart from its
   stages (F) and of one 128-key stage (P).
3. Host.  The host's microseconds to issue one call (200 calls without a
   synchronisation, on the host clock), beside the device ms.

Prints the card's name and power limit first.  Imports nothing of JAX.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.configs.neurovec import DEFAULT as NV
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    S, D = 512, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    cases = [("qwen3 causal", True, randn(4, 32, S, D), randn(4, 8, S, D),
              randn(4, S, 8, D).transpose(1, 2)),
             ("qwen3 non-causal", False, randn(4, 32, S, D),
              randn(4, 8, S, D), randn(4, S, 8, D).transpose(1, 2)),
             ("runner causal", True, randn(1, 128, S, D),
              randn(1, 128, S, D), randn(1, 128, S, D))]
    tiles = sorted({(min(bq, S), min(bkv, S)) for bq in NV.bq_choices
                    for bkv in NV.bkv_choices
                    if ops.attention_tiles_legal(S, S, D, bq, bkv)})
    default_ring = ops.ATTN_RING
    for label, causal, q, k, v in cases:
        B, H, _, _ = q.shape
        Hkv = k.shape[1]
        flops, nbytes = cs.k2_work(B, H, Hkv, S, S, D, causal)
        bound, by = cs.bound_s(flops, nbytes)
        sdpa = cs.time_ms_over(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=D ** -0.5,
            enable_gqa=H != Hkv), [()])
        print(f"[{label}] B={B} H={H} Hkv={Hkv} S={S} bound_ms="
              f"{bound * 1e3:.4f} ({by}) sdpa_ms={sdpa:.4f}", flush=True)
        for t in tiles:
            res = {}
            for ring in (1, 2, 3, 3, 2, 1):
                ops.ATTN_RING = ring
                kfa._CALLS.clear()          # plans are kept per call

                def call():
                    return ops.flash_attention(q, k, v, causal=causal,
                                               scale=D ** -0.5, tiles=t)
                plan = ops.attention_launch_plan(S, S, D, *t)
                ms = cs.time_ms_over(call, [()])
                dev = sum(cs.device_ms_by_kernel(call).values())
                res.setdefault(plan.ring, []).append((ms, dev))
            for ring, runs in sorted(res.items()):
                print(f"[{label}] tiles={t} ring={ring} ms="
                      f"{[round(m, 4) for m, _ in runs]} device_ms="
                      f"{[round(d, 4) for _, d in runs]} share_of_bound="
                      f"{bound * 1e3 / min(d for _, d in runs):.3f} "
                      f"vs_sdpa={min(m for m, _ in runs) / sdpa:.2f}x",
                      flush=True)
        ops.ATTN_RING = default_ring
        kfa._CALLS.clear()

    # ---- 2. stages against tiles ----
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for t, shapes in (((128, 128), ((4, 32, 512), (2, 32, 1024),
                                    (1, 32, 2048))),
                      ((64, 128), ((2, 32, 512), (1, 32, 1024),
                                   (1, 16, 2048)))):
        pts = []
        for B, H, S2 in shapes:
            q, k = randn(B, H, S2, D), randn(B, H // 4, S2, D)
            v = randn(B, S2, H // 4, D).transpose(1, 2)

            def call():
                return ops.flash_attention(q, k, v, causal=False,
                                           scale=D ** -0.5, tiles=t)
            dev = min(sum(cs.device_ms_by_kernel(call).values())
                      for _ in range(3))
            flops, _ = cs.k2_work(B, H, H // 4, S2, S2, D, causal=False)
            pts.append((S2 // 128, dev))
            print(f"[stages] tiles={t} B={B} H={H} S={S2}: 512 tiles of "
                  f"{S2 // 128} stages, device_ms={dev:.4f} "
                  f"({flops / dev / 1e9:.0f} TFLOP/s)", flush=True)
        waves = 512 / sms
        (n0, t0), (n1, t1) = pts[0], pts[-1]
        per_stage = (t1 - t0) / (n1 - n0) / waves
        per_tile = t0 / waves - n0 * per_stage
        print(f"[stages] tiles={t} fit over {waves:.2f} tiles a SM: a "
              f"128-key stage {per_stage * 1e3:.2f} us, a tile apart from "
              f"its stages {per_tile * 1e3:.2f} us", flush=True)

    # ---- 3. host ----
    import time
    q, k = randn(4, 32, S, D), randn(4, 8, S, D)
    v = randn(4, S, 8, D).transpose(1, 2)

    def call():
        return ops.flash_attention(q, k, v, causal=True, scale=D ** -0.5,
                                   tiles=(128, 128))
    for _ in range(3):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            call()
        host = (time.perf_counter() - t0) / 200
        torch.cuda.synchronize()
        dev = sum(cs.device_ms_by_kernel(call).values())
        print(f"[host] qwen3 causal (128, 128): {host * 1e6:.1f} us on the "
              f"host to issue a call, device {dev * 1e3:.1f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
