#!/usr/bin/env python3
"""Time K2 (flash attention) on one NVIDIA GPU.

  python3 tools/k2_probe.py [--src DIR] [--turns 2] [--alternatives]
                            [--shapes LABEL,...] [--d128]

0. Widths (``--src`` or ``--alternatives``).  The shapes of
   ``chip_smoke.K2_WIDTH_SHAPES`` (head dims other than 128: MLA's runner
   layout and ``mla.core``, Phi-3 at two tiles, SeamlessM4T's decoder and
   encoder, StableLM-3B), each in its layout, and the Qwen3-8B prefill at
   D = 128 as a control.  ``--src DIR`` builds the
   ``flash_attention.cu`` of another checkout's ``src/`` (a parent
   unpacked with ``git archive`` under ``build/``, which git ignores)
   beside this tree's and plans its calls with that checkout's
   ``kernels/ops.py``; both are called through their C entry points with
   the same arguments, in turns (parent, this, this, parent, ``--turns``
   times): the ms of one call over 20 back to back (CUDA events,
   ``chip_smoke.time_ms_over``), the device ms of one launch
   (``torch.profiler``, ``chip_smoke.device_ms_by_kernel``), each plan,
   the max abs difference between the two outputs (0 where the stage keys
   did not change: the narrower widths drop only zero columns), the bound
   at the true D and Dv and its share, and SDPA's ms and device ms.
   ``--alternatives`` times this tree's kernel at every compiled stage
   size and ring that fits each shape, standing in for the plan's choice,
   in turns (the device ms of each in order, then in reverse, ``--turns``
   times).
1-3 (``--d128``, or no flag).  Ring depths: the Qwen3-8B prefill in the
   served layout (B=4, H=32, Hkv=8, S=512, D=128, v the transposed view of
   its projection), causal and not, and the measurement runner's (B=1,
   H=Hkv=128, contiguous), each legal (bq, bkv) of the action space at
   ring depths 1, 2, 3, then again in reverse.  Stages against tiles:
   non-causal, 512 tiles each, S = 512, 1024, 2048, at tiles (128, 128)
   and (64, 128); the device ms is about (tiles / SMs) * (F + stages * P):
   a fit gives the cost of a tile apart from its stages (F) and of one
   128-key stage (P).  Host: the host's microseconds to issue one call
   (200 calls without a synchronisation), beside the device ms.

Prints the card's name and power limit first, and a JSON line for each
width shape.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# D = 128 beside the width shapes, where both versions run the same plan:
# the Qwen3-8B prefill, and a 96-token prompt at batch 64, which runs the
# two-warpgroup 64-key (128, 128) kernel
CONTROL = (("qwen3 d128", (4, 32, 8, 512, 128, 128), True, "served",
            (128, 512)),
           ("qwen3 d128 s96", (64, 32, 8, 96, 128, 128), True, "served",
            (128, 128)))


def parent_library(src: Path):
    """Start ``nvcc`` on ``src``'s ``flash_attention.cu`` into
    ``build/k2_parent/`` with this tree's flags (its ``ptxas`` report,
    registers and spills, goes to ``nvcc.log`` there); returns the process
    and the library's path."""
    from repro_torch.kernels import build
    csrc = src / "repro_torch" / "csrc"
    out = ROOT / "build" / "k2_parent" / "libflash_attention.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
           str(out), str(csrc / "flash_attention.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def load_module(name: str, path: Path):
    """``path`` as a module of its own (another checkout's ``ops.py``; its
    imports resolve to this tree's package)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tma_call(fn, plan_fn, q, k, v, causal, tiles, plan=None):
    """A closure calling a variant-A C entry point ``fn`` on (q, k, v)
    with ``plan_fn``'s plan (or ``plan``), the arguments the wrapper passes
    (the plan's widths after its ring where the plan has them: a checkout
    whose entry point takes no widths plans none); returns the closure and
    the plan."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    strides = tuple(kfa._tma_strides(t) for t in (q, k, v))
    if plan is None:
        plan = plan_fn(Sq, Skv, D, *tiles, strides, Dv=Dv)
    assert plan.variant == "tma_wgmma", plan
    args = (B, Hq, Hkv, Sq, Skv, D, Dv, *strides[0][:3], *strides[1][:3],
            *strides[2][:3], plan.bq, plan.warpgroups, plan.stage_keys,
            plan.n_stages, plan.ring,
            *((plan.d_pad, plan.dv_pad) if hasattr(plan, "d_pad") else ()),
            int(causal), float(D ** -0.5))

    def call():
        out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype,
                          device=q.device)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                *args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"K2 C entry point returned {rc} at {plan}")
        return out
    return call, plan


def plan_str(p) -> str:
    return (f"widths={getattr(p, 'd_pad', '-')}x{getattr(p, 'dv_pad', '-')}"
            f" wgs={p.warpgroups} keys={p.stage_keys} stages={p.n_stages} "
            f"ring={p.ring} smem={p.smem}")


def compiled_cases():
    src = (ROOT / "src" / "repro_torch" / "csrc" /
           "flash_attention.cu").read_text()
    return {tuple(int(v) for v in m) for m in re.findall(
        r"^\s*REPRO_FA_CASE\((\d+), (\d+), (\d+), (\d+)\)", src, re.M)}


def widths_section(args, cs, gen) -> None:
    """Section 0: the width shapes, against a parent's kernel in turns
    and/or at each compiled stage and ring."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    parent = None
    if args.src:
        src = Path(args.src).resolve()
        proc, lib = parent_library(src)
        build.build_all(["flash_attention"])
        log, _ = proc.communicate()
        (lib.parent / "nvcc.log").write_text(log)
        if proc.returncode:
            raise SystemExit(f"k2_probe: nvcc failed on {src}:\n{log}")
        pops = load_module("k2_parent_ops",
                           src / "repro_torch" / "kernels" / "ops.py")
        pfn = ctypes.CDLL(str(lib)).repro_flash_fwd_tma_bf16
        widths = "d_pad" in pops.AttentionLaunch._fields
        pfn.argtypes = [*kfa._TMA_ARGTYPES[:25],
                        *([ctypes.c_int] * (2 if widths else 0)),
                        *kfa._TMA_ARGTYPES[27:]]
        pfn.restype = ctypes.c_int
        parent = (pfn, pops.attention_launch_plan)
        print(f"[k2-widths] parent {src} built", flush=True)
    fn = kfa._fn("repro_flash_fwd_tma_bf16", kfa._TMA_ARGTYPES)
    compiled = compiled_cases()
    for label, shape, causal, layout, t in cs.K2_WIDTH_SHAPES + CONTROL:
        if args.shapes and label not in args.shapes.split(","):
            continue
        B, H, Hkv, S, D, Dv = shape
        q, k, v = cs.k2_width_inputs(shape, layout, gen)
        flops, nbytes = cs.k2_work(B, H, Hkv, S, S, D, causal, Dv)
        bound, by = cs.bound_s(flops, nbytes)

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=D ** -0.5,
                enable_gqa=H != Hkv)
        sdpa_ms = cs.time_ms_over(sdpa, [()])
        sdpa_dev = sum(cs.device_ms_by_kernel(sdpa).values())
        this, plan = tma_call(fn, ops.attention_launch_plan, q, k, v,
                              causal, t)
        rec = {"shape": label, "B": B, "H": H, "Hkv": Hkv, "S": S, "D": D,
               "Dv": Dv, "causal": causal, "layout": layout,
               "tiles": list(t), "bound_ms": bound * 1e3, "bound_by": by,
               "sdpa_ms": sdpa_ms, "sdpa_device_ms": sdpa_dev,
               "plan": plan._asdict()}
        head = (f"[k2-widths:{label}] B={B} H={H} Hkv={Hkv} S={S} D={D} "
                f"Dv={Dv} {'causal' if causal else 'non-causal'} {layout} "
                f"tiles={t}")
        print(f"{head} bound_ms={bound * 1e3:.4f} ({by}) sdpa_ms="
              f"{sdpa_ms:.4f} sdpa_device_ms={sdpa_dev:.4f}", flush=True)
        if parent is not None:
            pcall, pplan = tma_call(parent[0], parent[1], q, k, v, causal, t)
            diff = float((this().float() - pcall().float()).abs().max())
            torch.cuda.synchronize()
            runs = {"parent": [], "this": []}
            for _ in range(args.turns):
                for who in ("parent", "this", "this", "parent"):
                    f = pcall if who == "parent" else this
                    ms = cs.time_ms_over(f, [()])
                    dev = sum(cs.device_ms_by_kernel(f).values())
                    runs[who].append((round(ms, 4), round(dev, 4)))
            best = {w: min(d for _, d in r) for w, r in runs.items()}
            print(f"{head} parent: {plan_str(pplan)}; this: "
                  f"{plan_str(plan)}; |this-parent|={diff:.3e}", flush=True)
            for who, r in runs.items():
                print(f"{head} {who} ms={[m for m, _ in r]} device_ms="
                      f"{[d for _, d in r]} share_of_bound="
                      f"{bound * 1e3 / best[who]:.3f} vs_sdpa_device="
                      f"{best[who] / sdpa_dev:.2f}x", flush=True)
            print(f"{head} device parent/this={best['parent'] / best['this']:.3f}",
                  flush=True)
            rec.update(parent_plan=pplan._asdict(), max_abs_diff=diff,
                       turns=runs)
        if args.alternatives:
            cands = []
            for keys, ring in ((kk, r) for kk in (128, 64)
                               for r in range(1, ops.ATTN_MAX_RING + 1)):
                p = plan._replace(stage_keys=keys, n_stages=-(-S // keys),
                                  ring=ring)
                stage = 2 * keys * (p.d_pad + p.dv_pad)
                smem = (p.warpgroups * 64 * (
                    2 * p.d_pad + ops.attn_staging_pitch(p.dv_pad))
                    + ring * stage + 1024)
                if ((p.warpgroups, keys, p.d_pad, p.dv_pad) not in compiled
                        or smem > ops.ATTN_SMEM_DYN or ring > p.n_stages
                        or keys > S):
                    continue
                call, _ = tma_call(fn, None, q, k, v, causal, t,
                                   plan=p._replace(smem=smem))
                cands.append((keys, ring, call))
            devs = {(kk, r): [] for kk, r, _ in cands}
            for _ in range(args.turns):
                for order in (cands, cands[::-1]):
                    for kk, r, call in order:
                        devs[(kk, r)].append(round(sum(
                            cs.device_ms_by_kernel(call).values()), 4))
            alts = []
            for keys, ring, call in cands:
                ms = cs.time_ms_over(call, [()])
                dev = min(devs[(keys, ring)])
                mark = " (plan)" if (keys, ring) == (
                    plan.stage_keys, plan.ring) else ""
                print(f"{head} keys={keys} ring={ring}{mark}: ms={ms:.4f} "
                      f"device_ms={devs[(keys, ring)]} min={dev:.4f} "
                      f"share_of_bound={bound * 1e3 / dev:.3f}", flush=True)
                alts.append({"keys": keys, "ring": ring, "ms": ms,
                             "device_ms": devs[(keys, ring)]})
            rec["alternatives"] = alts
        print(json.dumps(rec, default=str), flush=True)
        del q, k, v
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=None,
                    help="another checkout's src/: time its K2 in turns "
                         "with this tree's at the width shapes")
    ap.add_argument("--turns", type=int, default=1,
                    help="rounds of parent, this, this, parent")
    ap.add_argument("--alternatives", action="store_true",
                    help="time every compiled stage and ring at the width "
                         "shapes")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated labels of the width and control "
                         "shapes to run (default: all)")
    ap.add_argument("--d128", action="store_true",
                    help="sections 1-3 (the default without --src or "
                         "--alternatives)")
    args = ap.parse_args()
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
    if args.src or args.alternatives:
        widths_section(args, cs, gen)
        if not args.d128:
            return 0
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
