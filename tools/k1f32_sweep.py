#!/usr/bin/env python3
"""Time variants of K1's f32 kernel against each other on one NVIDIA GPU.

  python3 tools/k1f32_sweep.py VARIANTS.json [--split MIN_RUN:MAX_RUNS ...]

``VARIANTS.json`` maps a name to a list of ``[old, new]`` text
replacements applied to a copy of ``src/repro_torch/csrc/matmul_f32.cu``
(``{"base": []}`` is the source as it is); each variant is built with
``kernels/build.py``'s ``nvcc`` flags under ``build/k1f32_sweep/``, all
at once, and called through its C entry point with the plan of
``ops.matmul_launch_plan``.  ``--split MIN_RUN:MAX_RUNS`` adds, for each
variant, the split ``ops.f32_split`` would give with ``F32_MIN_RUN`` and
``F32_MAX_RUNS`` so set (more than 8 runs needs a variant that raises the
source's ``F32_MAX_RUNS``).  For each shape of ``tools/k1f32_probe.py``
one line: ``torch.matmul``'s device ms and each candidate's (the least
of two ``torch.profiler`` readings taken in turns,
``chip_smoke.device_ms_by_kernel``), marked where its bits differ from
the first candidate's.  Prints the card's name and power limit first,
and for each variant the ptxas spill lines.  Imports nothing of JAX.
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
    ap.add_argument("--split", nargs="*", default=[])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1f32_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tools")]
    import chip_smoke as cs
    from k1f32_probe import SHAPES
    from repro_torch.core.costmodel import baseline_matmul_tiles
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import matmul as kmm
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = ROOT / "build" / "k1f32_sweep"
    procs = {}
    for name, subs in json.loads(Path(args.variants).read_text()).items():
        src_dir = out / f"src_{name}"
        shutil.rmtree(src_dir, ignore_errors=True)
        shutil.copytree(build.CSRC, src_dir)
        path = src_dir / "matmul_f32.cu"
        src = path.read_text()
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"{name}: {old!r} is not in matmul_f32.cu")
            src = src.replace(old, new)
        path.write_text(src)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(src_dir), "-o",
               str(out / f"lib_{name}.so"), str(path)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed:\n{log}")
        spills = [ln for ln in log.splitlines() if "spill" in ln and
                  "0 bytes spill stores, 0 bytes spill loads" not in ln]
        print(f"{name}: built, spill lines {spills}", flush=True)
        fn = ctypes.CDLL(str(out / f"lib_{name}.so")).repro_matmul_f32
        fn.argtypes, fn.restype = kmm._F32_ARGTYPES, ctypes.c_int
        libs[name] = fn
    counters = torch.zeros(4096, dtype=torch.int32, device="cuda")

    def run(fn, x, w, tiles, split):
        M, K = x.shape
        N = w.shape[1]
        p = ops.matmul_launch_plan(M, N, K, tiles, 132, dtype="float32")
        if split:
            least, most = (int(v) for v in split.split(":"))
            k_run = K if K <= least else max(
                least, -(-(-(-K // most)) // ops.F32_BK) * ops.F32_BK)
            p = p._replace(splits=-(-K // k_run), k_run=k_run)
        y = torch.empty((M, N), device="cuda")
        ws = (torch.empty((p.splits, M, N), device="cuda")
              if p.splits > 1 else None)
        rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                None if ws is None else ws.data_ptr(),
                None if ws is None else counters.data_ptr(), M, N, K,
                x.stride(0), w.stride(0), 0, p.bm, p.bn, p.height, p.width,
                p.k_run, p.splits, p.grid_m, p.grid_n, 1, 1,
                torch.cuda.current_stream().cuda_stream)
        build.check(rc, "matmul_f32 variant")
        return y

    gen = torch.Generator(device="cuda").manual_seed(0)
    cands = [(f"{n}" + (f"/split {r}" if r else ""), fn, r)
             for n, fn in libs.items() for r in ["", *args.split]]
    for label, (shape, tiles) in SHAPES.items():
        M, N, K, _ = shape
        tiles = tiles or baseline_matmul_tiles(M, N, K)
        x = torch.randn((M, K), generator=gen, device="cuda")
        w = torch.randn((K, N), generator=gen, device="cuda")
        ref, same, ms = None, {}, {}
        for name, fn, r in cands:
            y = run(fn, x, w, tiles, r)
            torch.cuda.synchronize()
            ref = y if ref is None else ref
            same[name] = bool(torch.equal(y, ref))
        for order in (cands, cands[::-1]):
            for name, fn, r in order:
                t = sum(cs.device_ms_by_kernel(
                    lambda: run(fn, x, w, tiles, r), reps=5).values())
                ms[name] = min(t, ms.get(name, t))
        lib = sum(cs.device_ms_by_kernel(lambda: torch.matmul(x, w),
                                         reps=5).values())
        print(f"{label} {M}x{N}x{K} {tuple(tiles)}: torch.matmul device "
              f"{lib:.4f}; " + "; ".join(
                  f"{n} {ms[n]:.4f}{'' if same[n] else ' (other bits)'}"
                  for n, _, _ in cands), flush=True)
        del x, w, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
