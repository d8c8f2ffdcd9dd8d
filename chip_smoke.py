#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

  python3 chip_smoke.py                  # all phases (one card)

Phases, each printed before the last line:
  1. device: nvidia-smi's name and power limit; TF32 switched off;
  2. build: both CUDA sources compiled at once from csrc/ (seconds, ptxas);
  3. kernels vs their plain PyTorch versions on the card, in bf16:
     K1 (tiled matmul) at every distinct qwen3_8b serve-site shape under the
     baseline tiles, and a tile-invariance sweep over every legal tile of
     one site; K2 (flash attention) at (B=4, H=32, Hkv=8, S=512, D=128),
     causal, over every legal (bq, bkv).  Each shape prints the kernel's
     median ms, the plain version's, one PyTorch call's (a yardstick only,
     never called by the port) and the bound max(flops / 989e12,
     bytes / 3.35e12) s;
  4. the main path: repro_torch.launch.serve.main at full width (qwen3_8b,
     36 layers, bf16, batch 4, prompt 512, 16 tokens, PPO-tuned tiles,
     --inject) with the launch counters zeroed just before and read just
     after; serve times the median of several prefills and decode windows
     after one untimed pass; then the same prompts in eager mode, held
     against it; then K1 at every matmul site of the path under the tile
     that site ran with;
  5. one JSON line describing each kernel of the path;
  6. the last line: {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero.  Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no
result.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s (data sheet)
HBM_BPS = 3.35e12           # H100 SXM HBM3 bytes/s (data sheet)
K1_TOL = 3e-2               # rel. error vs f32 matmul_ref: bf16 output
                            # rounding (2^-8) with f32 accumulation, as in
                            # tests/test_kernels.py
K2_TOL = 2e-2               # abs. error vs the plain version: bf16 output
                            # and bf16-rounded P in both, |out| < ~1
LOGIT_TOL = 5e-2            # max |kernel - eager| prefill logit over
                            # max |eager logit|: bf16 activations through 36
                            # layers with two different f32 summation orders
ARCH, BATCH, PROMPT, GEN, STEPS = "qwen3_8b", 4, 512, 16, 2000


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_s(flops: float, nbytes: float):
    t_ops, t_mem = flops / PEAK_BF16, nbytes / HBM_BPS
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms (CUDA events, after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# phase 3: K1
# ---------------------------------------------------------------------------

def k1_shapes(sites):
    """Distinct (M, N, K, transposed-w) of the serve's matmul sites."""
    out = {}
    for s in sites:
        if s.kind == "matmul":
            out.setdefault((s.m, s.n, s.k, s.site == "lm_head"), s)
    return out


def k1_check(shape, tiles, label, gen):
    """K1 vs plain and torch.matmul at one shape; returns a record."""
    import torch
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops, ref
    M, N, K, transposed = shape
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    if transposed:      # lm_head: w = head.T, a strided view
        w = torch.randn((N, K), generator=gen, device="cuda").bfloat16().T
    else:
        w = torch.randn((K, N), generator=gen, device="cuda").bfloat16()
    before = kmm.launches
    y = ops.matmul(x, w, tiles=tiles)
    torch.cuda.synchronize()
    if kmm.launches != before + 1:
        fail(f"K1 did not launch at {shape}")
    yr = ref.matmul_ref(x, w).float()
    y_f32 = x.float() @ w.float()
    err = float((y.float() - y_f32).abs().max())
    rel = err / (float(y_f32.abs().max()) + 1e-9)
    if not torch.isfinite(y).all() or rel >= K1_TOL:
        fail(f"K1 {shape} tiles {tiles}: rel err {rel:.3e} >= {K1_TOL}")
    plain_err = float((y.float() - yr).abs().max())
    ms = time_ms(lambda: ops.matmul(x, w, tiles=tiles))
    plain_ms = time_ms(lambda: kmm.matmul_plain(x, w))
    lib_ms = time_ms(lambda: torch.matmul(x, w))
    b, by = bound_s(2.0 * M * N * K, 2.0 * (M * K + K * N + M * N))
    print(f"[k1:{label}] M={M} N={N} K={K}{' wT' if transposed else ''} "
          f"tiles={tuple(tiles)} rel_err={rel:.2e} |k-plain|={plain_err:.3e} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} torch.matmul_ms={lib_ms:.4f} "
          f"bound_ms={b * 1e3:.4f} ({by})", flush=True)
    return {"err": err, "rel": rel, "ms": ms, "plain_ms": plain_ms,
            "lib_ms": lib_ms, "bound_s": b, "flops": 2.0 * M * N * K,
            "bytes": 2.0 * (M * K + K * N + M * N)}


def k1_sweep(site, gen):
    """Every legal tile of the action grid at one site gives the same
    function: compare each against the baseline tile's output."""
    import itertools

    import torch
    from repro_torch.configs.neurovec import DEFAULT as NV
    from repro_torch.core.costmodel import baseline_tiles
    from repro_torch.kernels import ops
    x = torch.randn((site.m, site.k), generator=gen, device="cuda").bfloat16()
    w = torch.randn((site.k, site.n), generator=gen, device="cuda").bfloat16()
    y0 = ops.matmul(x, w, tiles=baseline_tiles(site)).float()
    scale = float(y0.abs().max())
    n_legal = n_illegal = 0
    worst = 0.0
    for t in itertools.product(NV.bm_choices, NV.bn_choices, NV.bk_choices):
        if not ops.tile_ok(site, t):
            n_illegal += 1
            try:
                ops.matmul(x, w, tiles=t)
            except ValueError:
                continue
            fail(f"K1 launched the illegal tile {t}")
        n_legal += 1
        d = float((ops.matmul(x, w, tiles=t).float() - y0).abs().max())
        worst = max(worst, d / scale)
    torch.cuda.synchronize()
    if worst >= K1_TOL:
        fail(f"K1 tile sweep: max rel difference {worst:.3e}")
    print(f"[k1:sweep] {site.key()}: {n_legal} legal tiles agree with the "
          f"baseline tile (max rel diff {worst:.3e}); {n_illegal} illegal "
          f"tiles raised", flush=True)
    return worst


# ---------------------------------------------------------------------------
# phase 3: K2
# ---------------------------------------------------------------------------

def k2_checks(gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.neurovec import DEFAULT as NV
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    B, H, Hkv, S, D = 4, 32, 8, 512, 128
    q = torch.randn((B, H, S, D), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
    scale = D ** -0.5
    rep = H // Hkv
    yr = ref.attention_ref(q.float(), k.float().repeat_interleave(rep, 1),
                           v.float().repeat_interleave(rep, 1), causal=True,
                           scale=scale)
    flops = 4.0 * B * H * D * S * (S + 1) / 2       # causal pairs only
    nbytes = 2.0 * (2 * B * H * S * D + 2 * B * Hkv * S * D)
    b, by = bound_s(flops, nbytes)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=scale, enable_gqa=True))
    recs = {}
    tiles = sorted({(min(bq, S), min(bkv, S))
                    for bq in NV.bq_choices for bkv in NV.bkv_choices})
    for t in tiles:
        site_ok = bool(ops.attention_tiles_legal(S, S, D, *t))
        if not site_ok:
            try:
                ops.flash_attention(q, k, v, causal=True, scale=scale,
                                    tiles=t)
            except ValueError:
                print(f"[k2] tiles={t}: illegal, raised as it must",
                      flush=True)
                continue
            fail(f"K2 launched the illegal tile {t}")
        before = kfa.launches
        y = ops.flash_attention(q, k, v, causal=True, scale=scale, tiles=t)
        torch.cuda.synchronize()
        if kfa.launches != before + 1:
            fail(f"K2 did not launch at tiles {t}")
        yp = kfa.flash_attention_plain(q, k, v, causal=True, scale=scale,
                                       bq=t[0], bkv=t[1])
        err = float((y.float() - yp.float()).abs().max())
        err_ref = float((y.float() - yr).abs().max())
        if not torch.isfinite(y).all() or err >= K2_TOL:
            fail(f"K2 tiles {t}: abs err {err:.3e} >= {K2_TOL}")
        ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                 scale=scale, tiles=t))
        plain_ms = time_ms(lambda: kfa.flash_attention_plain(
            q, k, v, causal=True, scale=scale, bq=t[0], bkv=t[1]), reps=5)
        print(f"[k2] B={B} H={H} Hkv={Hkv} S={S} D={D} causal tiles={t} "
              f"|k-plain|={err:.3e} |k-ref_f32|={err_ref:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
              f"bound_ms={b * 1e3:.4f} ({by})", flush=True)
        recs[t] = {"err": err, "ms": ms, "plain_ms": plain_ms,
                   "lib_ms": lib_ms, "bound_s": b, "flops": flops,
                   "bytes": nbytes}
    return recs


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def main_path():
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--full", "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN), "--autotune", "ppo",
            "--autotune-steps", str(STEPS), "--inject"]
    print(f"[main] serve.main({argv}) (full depth: 36 layers)", flush=True)
    kmm.launches = 0
    kfa.launches = 0
    t0 = time.perf_counter()
    res = serve.main(argv)
    wall = time.perf_counter() - t0
    counts = {"matmul": kmm.launches, "flash_attention": kfa.launches}
    print(f"[main] launches in the run: {counts}; by phase: {res.launches}; "
          f"wall {wall:.1f} s (tuning included)", flush=True)
    cfg = res.model.cfg
    per_pass = cfg.n_layers * 7 + 1
    want = {"prefill": {"matmul": per_pass, "flash_attention": cfg.n_layers},
            "decode": {"matmul": per_pass * (GEN - 1),
                       "flash_attention": 0}}
    if res.launches != want:
        fail(f"launch counts {res.launches} != {want}")
    # one untimed pass, then the timed prefills and decode windows
    n_pre = 1 + len(res.prefill_ms_runs)
    n_dec = 1 + len(res.decode_tok_s_runs)
    if counts != {k: want["prefill"][k] * n_pre + want["decode"][k] * n_dec
                  for k in counts}:
        fail(f"total launch counts {counts} over {n_pre} prefills and "
             f"{n_dec} decode windows")
    bad = [s.key() for s in res.sites if not ops.tile_ok(s, res.prog.tiles[
        s.key()])]
    if bad:
        fail(f"the tuned program names tiles that cannot launch: {bad}")
    if any(c == 0 for c in counts.values()):
        fail("a kernel of the path was never launched")
    logits = res.prefill_logits
    if logits.shape != (BATCH, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        fail(f"prefill logits {tuple(logits.shape)} not finite")
    if res.seq.shape != (BATCH, GEN):
        fail(f"tokens {tuple(res.seq.shape)}")
    eager_argv = argv[:argv.index("--autotune")]
    eager = serve.run(serve.parse_args(eager_argv), params=res.params,
                      prompts=res.prompts)
    diff = float((logits - eager.prefill_logits).abs().max())
    rel = diff / float(eager.prefill_logits.abs().max())
    agree = float((res.seq == eager.seq).float().mean())
    first = float((res.seq[:, 0] == eager.seq[:, 0]).float().mean())
    print(f"[main] kernel vs eager prefill logits: max|d|={diff:.4e}, "
          f"relative {rel:.4e} (tol {LOGIT_TOL}); greedy tokens agree "
          f"{agree * 100:.1f}% (first token {first * 100:.1f}%)", flush=True)
    if rel >= LOGIT_TOL:
        fail(f"prefill logits differ from eager: {rel:.3e}")
    n_tiles = len(res.prog.tiles)
    def spread(r):
        return (f"prefill ms median {r.prefill_ms:.2f} of "
                f"{[round(t, 2) for t in r.prefill_ms_runs]}, decode tok/s "
                f"median {r.decode_tok_s:.2f} of "
                f"{[round(t, 2) for t in r.decode_tok_s_runs]}")
    print(f"[main] kernels: {spread(res)}; eager: {spread(eager)}; "
          f"{len(res.sites)} sites, {n_tiles} tiles, all launched as tuned; "
          f"TPU-v5e-modelled speedup {res.modelled_speedup:.3f}x "
          f"(cost model, not measured)", flush=True)
    print(f"[main] tuned tiles: " + ", ".join(
        f"{s.site}@M={s.m}:{tuple(res.prog.tiles[s.key()])}"
        for s in res.sites), flush=True)
    return res, counts


def _device_info():
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    return smi, torch.cuda.get_device_name(0), torch.cuda.device_count()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              f"(src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import baseline_tiles
    from repro_torch.core.extractor import extract_serve_sites
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    from repro_torch.models.lm import build_model

    # ---- phase 1: device ----
    smi, kind, count = _device_info()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] nvidia-smi: {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{kind} x{count}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] {', '.join(build.SOURCES)} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build:{name}] {line.strip()}")

    # ---- phase 3: kernels vs plain ----
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_model(get_config(ARCH))
    sites = extract_serve_sites(model, BATCH, PROMPT, GEN)
    shapes = k1_shapes(sites)
    for shape, s in shapes.items():
        k1_check(shape, baseline_tiles(s), "baseline", gen)
    sweep_site = next(s for s in sites if s.kind == "matmul" and s.m > 1
                      and s.site == "attn.q")
    k1_sweep(sweep_site, gen)
    k2 = k2_checks(gen)
    torch.cuda.empty_cache()

    # ---- phase 4: main path ----
    res, counts = main_path()
    prog = res.prog.tiles
    k1_tuned, per_site_launches = {}, {}
    for s in res.sites:          # each matmul site at its own tuned tile
        if s.kind == "matmul":
            shape = (s.m, s.n, s.k, s.site == "lm_head")
            k1_tuned[s.key()] = k1_check(shape, prog[s.key()],
                                         f"tuned:{s.site}", gen)
            # lm_head runs once in the prefill and once in the decode step
            per_site_launches[s.key()] = (2 if s.site == "lm_head"
                                          else model.cfg.n_layers)
    att = next(s for s in res.sites if s.kind == "attention" and s.m > 1)
    t_att = tuple(min(a, b) for a, b in zip(prog[att.key()][:2],
                                             (PROMPT, PROMPT)))
    if t_att not in k2:
        fail(f"tuned attention tile {t_att} was not checked")

    # ---- phase 5: kernels line (one prefill + one decode step, tuned) ----
    def agg(recs, weights):
        """Launch-weighted sums; the bound is the sum of each launch's own
        bound, and ``bound_by`` the limit that holds for most of it."""
        tot = {k: sum(recs[s][k] * w for s, w in weights.items())
               for k in ("ms", "plain_ms", "lib_ms")}
        by_time = {"operations": 0.0, "bytes": 0.0}
        for s, w in weights.items():
            b, by = bound_s(recs[s]["flops"], recs[s]["bytes"])
            by_time[by] += b * w
        return tot, sum(by_time.values()), max(by_time, key=by_time.get)
    k1_tot, k1_b, k1_by = agg(k1_tuned, per_site_launches)
    k2_tot, k2_b, k2_by = agg(k2, {t_att: model.cfg.n_layers})
    line = {"kernels": [
        {"name": "tiled_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:32",
         "launches": counts["matmul"],
         "max_abs_err": max(r["err"] for r in k1_tuned.values()),
         "max_rel_err": max(r["rel"] for r in k1_tuned.values()),
         "tolerance": f"rel {K1_TOL} vs f32 matmul",
         "ms": k1_tot["ms"], "plain_ms": k1_tot["plain_ms"],
         "bound_ms": k1_b * 1e3, "bound_by": k1_by,
         "library_ms": k1_tot["lib_ms"],
         "work": "one prefill + one decode step of the main path, tuned "
                 "tiles"},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:64",
         "launches": counts["flash_attention"],
         "max_abs_err": max(r["err"] for r in k2.values()),
         "tolerance": f"abs {K2_TOL} vs plain version",
         "ms": k2_tot["ms"], "plain_ms": k2_tot["plain_ms"],
         "bound_ms": k2_b * 1e3, "bound_by": k2_by,
         "library_ms": k2_tot["lib_ms"],
         "work": f"one prefill of the main path ({model.cfg.n_layers} "
                 f"launches at tiles {t_att})"}]}
    print(json.dumps(line))
    print(f"[device] {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
