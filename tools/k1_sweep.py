#!/usr/bin/env python3
"""Time variants of K1's bf16 kernels against each other on one NVIDIA GPU.

  python3 tools/k1_sweep.py VARIANTS.json [--tiles BM,BN,BK ...]
      [--clusters C ...] [--groups G ...] [--occupancy O ...]
      [--shapes NAME ...]

``VARIANTS.json`` maps a name to a list of ``[old, new]`` text
replacements applied to a copy of ``src/repro_torch/csrc/`` (each pair
names its file: ``["matmul.cu", old, new]``; ``{"base": []}`` is the
source as it is); each variant is built with ``kernels/build.py``'s
``nvcc`` flags under ``build/k1_sweep/``, all at once, and called through
its C entry point ``repro_matmul_tma_bf16`` with the plan of
``ops.matmul_launch_plan`` for each tile (default PPO's (32, 128, 1024))
and each cluster (default the plan's own), ``group_m`` (``--groups``)
and occupancy (``--occupancy``, CTAs an SM: a compiled one; default the
plan's own), at the shapes of
``tools/k1_probe.py`` (default all four) or given as ``MxNxK``; a
candidate whose tile and occupancy the source does not compile is
dropped.  For each shape and tile one
line: ``torch.matmul``'s device ms and each candidate's (the least of two
``torch.profiler`` readings taken in turns, ``chip_smoke.
device_ms_by_kernel``), marked where its bits differ from the first
candidate's, or where it fails K1_TOL against the f32 product (a variant
that computes less, to time the loads alone, does).  Prints the card's
name and power limit first, and for each variant its ptxas register and
spill lines for the swapped kernels.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants")
    ap.add_argument("--tiles", nargs="*", default=["32,128,1024"])
    ap.add_argument("--clusters", nargs="*", type=int, default=[])
    ap.add_argument("--groups", nargs="*", type=int, default=[],
                    help="group_m values standing in for the plan's")
    ap.add_argument("--occupancy", nargs="*", type=int, default=[],
                    help="CTAs an SM standing in for the plan's")
    ap.add_argument("--shapes", nargs="*", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]
    import chip_smoke as cs
    from k1_probe import SHAPES
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import matmul as kmm
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = ROOT / "build" / "k1_sweep"
    procs = {}
    for name, subs in json.loads(Path(args.variants).read_text()).items():
        src_dir = out / f"src_{name}"
        shutil.rmtree(src_dir, ignore_errors=True)
        shutil.copytree(build.CSRC, src_dir)
        for fname, old, new in subs:
            path = src_dir / fname
            src = path.read_text()
            if old not in src:
                raise SystemExit(f"{name}: {old!r} is not in {fname}")
            path.write_text(src.replace(old, new))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(src_dir), "-o",
               str(out / f"lib_{name}.so"), str(src_dir / "matmul.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        lines = log.splitlines()
        regs = sorted({ln.split("Used")[1].split(",")[0].strip()
                       for i, ln in enumerate(lines) if "Used" in ln
                       and any("swap_kernel" in p for p in lines[i - 2:i])})
        spills = [ln for ln in lines if "spill" in ln and
                  "0 bytes spill stores, 0 bytes spill loads" not in ln]
        print(f"{name}: built; swapped kernels use {regs}; spill lines "
              f"{spills}", flush=True)
        fn = ctypes.CDLL(str(out / f"lib_{name}.so")).repro_matmul_tma_bf16
        fn.argtypes, fn.restype = kmm._TMA_ARGTYPES, ctypes.c_int
        libs[name] = fn
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    counters = torch.zeros(4096, dtype=torch.int32, device="cuda")

    def run(fn, x, w, p):
        M, K = x.shape
        N = w.shape[1]
        y = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
        ws = (torch.empty((p.splits, M, N), device="cuda")
              if p.splits > 1 else None)
        rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if ws is None else counters.data_ptr(), M, N,
                K, x.stride(0), w.stride(0), 0, p.bm, p.bn, p.k_run, p.rows,
                p.cols, p.grid_m, p.grid_n, p.group_m, p.splits, p.cluster,
                p.occupancy, torch.cuda.current_stream().cuda_stream)
        build.check(rc, "matmul variant")
        return y

    gen = torch.Generator(device="cuda").manual_seed(0)
    for label in args.shapes or list(SHAPES):
        M, N, K = SHAPES.get(label) or map(int, label.split("x"))
        x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
        w = torch.randn((K, N), generator=gen, device="cuda").bfloat16()
        want = x.float() @ w.float()
        lib = sum(cs.device_ms_by_kernel(lambda: torch.matmul(x, w),
                                         reps=5).values())
        for tiles in args.tiles:
            t = tuple(int(v) for v in tiles.split(","))
            own = ops.matmul_launch_plan(M, N, K, t, sms)
            plans = [ops.matmul_launch_plan(M, N, K, t, sms, cluster=c)
                     for c in args.clusters] or [own]
            plans = [p._replace(group_m=g) for p in plans
                     for g in args.groups if g % p.cluster == 0] or plans
            plans = [p._replace(occupancy=o) for p in plans
                     for o in args.occupancy] or plans
            cands = [(f"{n} C={p.cluster} G={p.group_m} "
                      f"O={p.occupancy}", fn, p)
                     for n, fn in libs.items() for p in plans]
            ref, note, ms = None, {}, {}
            for name, fn, p in list(cands):
                try:
                    y = run(fn, x, w, p)
                except RuntimeError:        # a plan the source lacks
                    cands.remove((name, fn, p))
                    continue
                torch.cuda.synchronize()
                rel = float((y.float() - want).abs().max() / want.abs().max())
                ref = y if ref is None else ref
                note[name] = ("" if torch.equal(y, ref) else
                              " (other bits)" if rel < cs.K1_TOL else
                              f" (rel err {rel:.2e})")
            for order in (cands, cands[::-1]):
                for name, fn, p in order:
                    d = sum(cs.device_ms_by_kernel(
                        lambda: run(fn, x, w, p), reps=5).values())
                    ms[name] = min(d, ms.get(name, d))
            print(f"{label} {M}x{N}x{K} {t}: torch.matmul device "
                  f"{lib:.4f}; " + "; ".join(
                      f"{n} {ms[n]:.4f}{note[n]}" for n, _, _ in cands),
                  flush=True)
        del x, w, want, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
