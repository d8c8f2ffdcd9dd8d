#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

  python3 chip_smoke.py                  # all phases (one card)

Phases, each printed before the last line:
  1. device: nvidia-smi's name and power limit; TF32 switched off;
  2. build: the three CUDA sources compiled at once from csrc/ (seconds,
     ptxas); K1's, K2's and K3's libraries must hold HGMMA and UTMALDG
     instructions (cuobjdump -sass), K2's and K3's builds no spill, and
     K3's static shared memory (ptxas) must be its plan's;
  3. kernels vs their plain PyTorch versions on the card, in bf16:
     K1 (tiled matmul) at every distinct qwen3_8b serve-site shape under the
     baseline tiles, and a tile-invariance sweep over every legal tile of
     one site, each tile timed beside the rate at which its operands reach
     the SMs; K2 (flash attention) at (B=4, H=32, Hkv=8, S=512, D=128),
     causal, v in the served layout (the transposed view of its
     projection), over every legal (bq, bkv), each line with the variant,
     device ms, share of the bound and ratio to SDPA (stream and device
     ms), and once at the
     runner's shape (B=1, H=Hkv=128, contiguous); K2 at the StableLM-3B
     prefill (B=4, H=Hkv=32, S=512, D=80, causal, v the transposed view)
     over every legal tile, its bound at the true D beside SDPA's time,
     once with q, k and v all transposed views and once through the
     unaligned variant, and at D = 64 and 96 at a small shape through both
     variants; K3 (SSD chunk scan) at the
     xlstm_1_3b serve site as the measurement runner builds it (G=1,
     S=8192, P=N=1024) for every chunk of the action space (the ones the
     predicate refuses must raise TileError), and at a Mamba-2 head of
     jamba_v0_1_52b's ssm.chunk_scan site (S=262144, P=64, N=16, Q=256),
     each K3 line with its variant (ops.chunk_launch_plan), the device ms
     of each pass and their sum, and the share of the bound that sum
     reaches.  Each shape prints the kernel's ms (the median over repeats
     of 20 calls back to back), the plain version's, one PyTorch call's where
     there is one (a yardstick only, never called by the port, timed the
     same way) and the bound max(flops / 989e12, bytes / 3.35e12) s; each
     K1 line also its device ms (profiler), share of the bound (of the
     device ms at M = 4, where the stream runs at the host's issue rate),
     ratio to torch.matmul and the variant that ran, and at M = 4 times
     over copies of w that exceed 100 MB together (a decode step never
     finds its weights in L2), with the warm-L2 time beside them;
  4. the modelled main path: repro_torch.launch.serve.main at full width
     (qwen3_8b, 36 layers, bf16, batch 4, prompt 512, 16 tokens, PPO-tuned
     tiles against the cost model, --inject) with the launch counters zeroed
     just before and read just after; serve times the median of several
     prefills and decode windows after one untimed pass; then the same
     prompts in eager mode, held against it; then K1 at every matmul site
     of the path under the tile that site ran with; a model path that
     launched K1's or K2's unaligned variant fails;
  5. the measured main paths: serve --measured --inject at full width for
     qwen3_8b (36 layers) and xlstm_1_3b (48 layers), batch 4, prompt 512,
     16 tokens: PPO is rewarded with the timed kernels (paper eq. 2).  Each
     is driven with the counters zeroed just before and read just after; it
     fails on a failed timing, an open breaker, health other than "ok", a
     tuned tile that does not launch as tuned, K3 never launched during the
     xLSTM fit, K1's or K2's unaligned variant, or logits that disagree with
     eager mode; the xLSTM fit's K3 times by chunk, as the runner timed
     them, and the chunk it picked are printed.  xlstm_1_3b's bf16 logits
     must also differ across the batch rows and lie near an f32 eager
     prefill, no farther than 1.5x the bf16 eager path's logits lie from
     it, and that f32 prefill must match the f32 decode recurrence fed the
     prompt token by token; then
     K1 at each of its shapes under the baseline and the tuned tile (every
     K1 check prints how many outputs differ from torch.matmul at all);
  6. the paper's main-path loop (tests/test_system.py:22-55) on
     stablelm_3b at full width (32 layers, head dim 80, bf16, batch 4,
     prompt 512, 16 tokens): PPO fit on dataset.generate(400, seed=0,
     base=sites) under CostModelEnv(legality="h100") with the reference
     test's PPO settings, its tiles tuned (the TPU-v5e-modelled speedup
     printed), serve --tiles --inject with them against eager mode, K1 at
     every StableLM shape under the baseline and the tuned tile, then
     serve --autotune brute --measured --inject (its pick must be the
     fastest tile it timed at every site) and PPO's program priced from
     the same timings: the two measured speedups side by side;
  7. one JSON line describing each kernel of the paths (K1 and K2 with
     their launches by variant and their StableLM-3B numbers, K3 with its
     device ms by pass and chunk and the Mamba-2 head), printed last so
     that phase 8's launches count in it;
  8. the facade (run between phases 6 and 7): the full-width StableLM-3B
     through repro_torch.api only.  A brute-force NeuroVectorizer against
     the measured oracle, with a fresh timing DB and program store under
     build/, fitted and tuned (timed and failed pairs, wall s, measured
     speedup, health "ok"); one prefill under nv.inject(prog), whose K1
     and K2 launches must be a prefill's and whose logits must lie within
     LOGIT_TOL of eager mode's; save, a second tune answered by the store
     with no inference, load with the same DB and store (the same
     program), and a load refitted against the warm DB that times 0
     pairs; the seven methods of make_agent, each fitted on the corpus
     under CostModelEnv(legality="h100") (PPO at the loop's budget),
     tuned to tiles ops.tile_ok admits and priced by the facade's
     measured oracle (one line each: modelled and measured speedup, pairs
     timed anew); then examples/torch_quickstart.py's main on the card;
  9. the transports on the card (run after phase 8, before phase 7):
     phase 6's in-process brute-force DB is the reference.  serve
     --transport pool --workers 2 (the same StableLM-3B run, a new DB)
     must time the same keys, all finite, none failed or quarantined,
     health ok, under the in-process backend key, with no launch in this
     process during the fit (the workers' counters, written under
     REPRO_TORCH_LAUNCH_DIR, show K1 and K2), and its injected prefill's
     launches and logits as phase 6's; then --workers 1; each prints the
     per-pair ratio of pool to in-process time (median, p10, p90), the
     fit's wall and the spawn seconds.  K3 at xLSTM's chunk-scan site at
     every legal chunk in a pool of 2, beside phase 5's in-process times.
     A factory runner defined here triggers a device-side assert in a
     worker at one marked pair: the pool must replace the worker and time
     the pair finite on the retry; a ChaosRunner (crash, hang, torn frame,
     noise) over the card's runner times StableLM pairs that draw each
     fault once, and two that draw none: all finite, each key written
     once, health ok.  The fleet: serve-worker (a pool of
     2) and serve-artifacts daemons on ports the OS picks, serve
     --transport socket with fleet:// DB and store meeting the pool run's
     checks, a warm rerun that times 0 pairs and takes its program from
     the store, then SIGTERM and exit code 0 for both daemons;
 10. the last line: {"ok": true, "device": {...}}.

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
K3_TOL = 3e-2               # max error vs the plain version over its largest
                            # |output|: scores, state and x*decay enter the
                            # tensor cores in bf16 (2^-9 each), bf16 output
LOGIT_TOL = 5e-2            # max |kernel - eager| prefill logit over
                            # max |eager logit|: bf16 activations through 36
                            # layers with two different f32 summation orders
XL_F32_TOL = 0.5            # max |bf16 kernel - f32 eager| xlstm_1_3b prefill
                            # logit over max |f32 logit|: at random weights
                            # the 48 recurrent layers amplify bf16 rounding
                            # (0.134 on an H100 at these seeds)
XL_EAGER_FACTOR = 1.5      # xlstm_1_3b kernel-path logits may lie at most
                            # this many times as far from the f32 prefill
                            # as the bf16 eager path's logits do
RECUR_TOL = 1e-3            # f32 chunkwise prefill vs f32 token-by-token
                            # decode of the same prompt, over max |logit|:
                            # summation order only (4.2e-5 on an H100)
ARCH, BATCH, PROMPT, GEN, STEPS = "qwen3_8b", 4, 512, 16, 2000
XLSTM = "xlstm_1_3b"
STABLELM = "stablelm_3b"
# tests/test_system.py's PPO for the main-path loop: its NeuroVecConfig,
# learning rate and budget, on dataset.generate(400, seed=0, base=sites)
LOOP_NV = dict(train_batch=256, sgd_minibatch=64, ppo_epochs=4)
LOOP_LR, LOOP_STEPS, LOOP_CORPUS = 5e-4, 2500, 400
# jamba_v0_1_52b's ssm.chunk_scan site at batch 4, prompt 512 (d_model 4096,
# expand 2, head dim 64 -> 128 heads; chunk 256): batch 4*128*2 = 1024
# instances of 256 positions, P = 64, N = 16, as the runner builds it
MAMBA = dict(G=1, S=1024 * 256, P=64, N=16, Q=256)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_s(flops: float, nbytes: float):
    t_ops, t_mem = flops / PEAK_BF16, nbytes / HBM_BPS
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


COLD_BYTES = 100e6          # M = 4 shapes are timed over copies of w that
                            # together exceed this: a decode step reads 253
                            # distinct weights, never from the 50 MB L2


def time_ms_over(fn, args, reps: int = 10, warmup: int = 1,
                 calls: int = 20) -> float:
    """Median ms of one call of ``fn(*a)`` on the stream, timed with CUDA
    events over at least ``calls`` calls back to back, passing through the
    argument list ``args`` in turn, as the layers of a model call them.
    Where the host takes longer to issue a call than the card to run it,
    this is the host's time."""
    import torch
    passes = max(1, -(-calls // len(args)))
    for _ in range(warmup):
        for a in args:
            fn(*a)
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(passes):
            for a in args:
                fn(*a)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / (passes * len(args)))
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
    """K1 vs plain and torch.matmul at one shape; returns a record.  At
    M = 4 (bound by reading w) the times are over copies of w that exceed
    COLD_BYTES together, the warm-L2 time (one w) printed beside them."""
    import torch
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops, ref
    M, N, K, transposed = shape

    def weight():
        if transposed:      # lm_head: w = head.T, a strided view
            return torch.randn((N, K), generator=gen,
                               device="cuda").bfloat16().T
        return torch.randn((K, N), generator=gen, device="cuda").bfloat16()
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    w = weight()
    before = dict(kmm.launches_by_variant)
    y = ops.matmul(x, w, tiles=tiles)
    torch.cuda.synchronize()
    ran = [v for v in kmm.VARIANTS
           if kmm.launches_by_variant[v] != before[v]]
    if len(ran) != 1 or sum(kmm.launches_by_variant.values()) != \
            sum(before.values()) + 1:
        fail(f"K1 did not launch once at {shape}: {ran}")
    variant = ran[0]
    yr = ref.matmul_ref(x, w).float()
    y_f32 = x.float() @ w.float()
    err = float((y.float() - y_f32).abs().max())
    rel = err / (float(y_f32.abs().max()) + 1e-9)
    if not torch.isfinite(y).all() or rel >= K1_TOL:
        fail(f"K1 {shape} tiles {tiles}: rel err {rel:.3e} >= {K1_TOL}")
    plain_err = float((y.float() - yr).abs().max())
    # bf16 outputs that differ from cuBLAS's at all (0 only where both
    # happen to sum K in an order that rounds alike)
    n_ne_lib = int((y != torch.matmul(x, w)).sum())
    del y_f32, yr
    ws = [(x, w)]
    if M <= 8:
        nbytes_w = 2.0 * K * N
        ws += [(x, weight()) for _ in range(int(COLD_BYTES // nbytes_w))]
    ms = time_ms_over(lambda a, b: ops.matmul(a, b, tiles=tiles), ws)
    lib_ms = time_ms_over(torch.matmul, ws)
    plain_ms = time_ms_over(kmm.matmul_plain, ws, reps=5, calls=1)
    dev_ms = sum(device_ms_by_kernel(
        lambda: [ops.matmul(a, b, tiles=tiles) for a, b in ws],
        reps=max(5, 20 // len(ws))).values()) or None
    cold = ""
    if M <= 8 and len(ws) == 1:
        cold = f" (w alone is {2.0 * K * N / 1e6:.0f} MB: never in L2)"
    if len(ws) > 1:
        warm_ms = time_ms_over(lambda a, b: ops.matmul(a, b, tiles=tiles),
                               ws[:1])
        warm_lib = time_ms_over(torch.matmul, ws[:1])
        cold = (f" (over {len(ws)} copies of w); warm L2 (one w): ms="
                f"{warm_ms:.4f} torch.matmul_ms={warm_lib:.4f}")
    del ws
    b, by = bound_s(2.0 * M * N * K, 2.0 * (M * K + K * N + M * N))
    # at M = 4 the stream time is the host's issue rate, not the kernel's
    share_ms, share_of = ms, "stream"
    if M <= 8 and dev_ms is not None:
        share_ms, share_of = dev_ms, "device"
    print(f"[k1:{label}] M={M} N={N} K={K}{' wT' if transposed else ''} "
          f"tiles={tuple(tiles)} variant={variant} rel_err={rel:.2e} "
          f"|k-plain|={plain_err:.3e} !=torch.matmul: {n_ne_lib} of {M * N} "
          f"ms={ms:.4f} device_ms="
          f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'} "
          f"plain_ms={plain_ms:.4f} "
          f"torch.matmul_ms={lib_ms:.4f} bound_ms={b * 1e3:.4f} ({by}) "
          f"share_of_bound={b * 1e3 / share_ms:.3f} ({share_of} ms) "
          f"vs_torch.matmul={ms / lib_ms:.2f}x{cold}", flush=True)
    return {"err": err, "rel": rel, "ms": ms, "plain_ms": plain_ms,
            "n_ne_lib": n_ne_lib, "device_ms": dev_ms, "variant": variant,
            "lib_ms": lib_ms, "bound_s": b, "flops": 2.0 * M * N * K,
            "bytes": 2.0 * (M * K + K * N + M * N)}


def k1_operand_bytes(plan, K: int) -> float:
    """Bytes TMA moves into the SMs for one call under ``plan``: each CTA
    loads a (rows x 64) box of x and a (64 x cols) box of w per 64-deep
    step of its run of K."""
    steps = sum(-(-(min(K, (z + 1) * plan.k_run) - z * plan.k_run) // 64)
                for z in range(plan.splits))
    return plan.grid_m * plan.grid_n * steps * (plan.rows + plan.cols) * 128


def k1_sweep(site, gen):
    """Every legal tile of the action grid at one site gives the same
    function: compare each against the baseline tile's output.  Each
    legal tile is also timed, beside the rate at which its operands
    reach the SMs (``k1_operand_bytes`` over its ms): the padded wgmma
    at rows < 64 is set by that rate if the rate is the same at rows
    below and above 64."""
    import itertools

    import torch
    from repro_torch.configs.neurovec import DEFAULT as NV
    from repro_torch.core.costmodel import baseline_tiles
    from repro_torch.kernels import ops
    M, N, K = site.m, site.n, site.k
    x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
    w = torch.randn((K, N), generator=gen, device="cuda").bfloat16()
    y0 = ops.matmul(x, w, tiles=baseline_tiles(site)).float()
    scale = float(y0.abs().max())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_legal = n_illegal = 0
    worst = 0.0
    by_rows = {}
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
        plan = ops.matmul_launch_plan(M, N, K, t, sms)
        ms = time_ms_over(lambda a, b: ops.matmul(a, b, tiles=t), [(x, w)],
                          reps=5)
        rate = k1_operand_bytes(plan, K) / (ms * 1e-3) / 1e12
        by_rows.setdefault(max(64, plan.rows), []).append((ms, rate, t))
        print(f"[k1:sweep] tiles={t} variant={plan.variant} CTA "
              f"{max(64, plan.rows)}x{plan.cols} ({plan.rows} rows loaded) "
              f"ms={ms:.4f} operands_into_SMs={rate:.2f} TB/s", flush=True)
    torch.cuda.synchronize()
    if worst >= K1_TOL:
        fail(f"K1 tile sweep: max rel difference {worst:.3e}")
    for rows_p, recs in sorted(by_rows.items()):
        recs.sort()
        rates = [r for _, r, _ in recs]
        print(f"[k1:sweep] CTA rows {rows_p} ({len(recs)} tiles): ms "
              f"{recs[0][0]:.4f}-{recs[-1][0]:.4f} (fastest {recs[0][2]}), "
              f"operands into the SMs {min(rates):.2f}-{max(rates):.2f} "
              f"TB/s", flush=True)
    print(f"[k1:sweep] {site.key()}: {n_legal} legal tiles agree with the "
          f"baseline tile (max rel diff {worst:.3e}); {n_illegal} illegal "
          f"tiles raised", flush=True)
    return worst


# ---------------------------------------------------------------------------
# phase 3: K2
# ---------------------------------------------------------------------------

def k2_call(q, k, v, tiles):
    """One causal K2 call through ops.flash_attention; returns the output
    and the variant that ran."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    before = dict(kfa.launches_by_variant)
    y = ops.flash_attention(q, k, v, causal=True,
                            scale=q.shape[-1] ** -0.5, tiles=tiles)
    torch.cuda.synchronize()
    ran = [x for x in kfa.VARIANTS
           if kfa.launches_by_variant[x] != before[x]]
    if len(ran) != 1 or sum(kfa.launches_by_variant.values()) != \
            sum(before.values()) + 1:
        fail(f"K2 did not launch once at tiles {tiles}: {ran}")
    return y, ran[0]


def k2_work(B, H, Hkv, Sq, Skv, D, causal=True):
    """Operations and bytes of one call: the causal half of the two
    products (Sq = Skv), q, k, v read once and out written once.  The
    bound is bytes at the Qwen3-8B prefill: 42 MB at 3.35 TB/s (0.0125 ms)
    against 8.6 GFLOP at 989 TFLOP/s (0.0087 ms)."""
    pairs = Sq * (Sq + 1) / 2 if causal else Sq * Skv
    return 4.0 * B * H * D * pairs, 2.0 * (2 * B * H * Sq * D
                                           + 2 * B * Hkv * Skv * D)


def k2_line(label, q, k, v, t, ref_out=None):
    """K2 at tiles ``t`` against its plain version, with its ms (events,
    20 calls back to back), device ms (profiler), share of the bound and
    ratio to scaled_dot_product_attention on the same inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    scale = D ** -0.5
    y, variant = k2_call(q, k, v, t)
    yp = kfa.flash_attention_plain(q, k, v, causal=True, scale=scale,
                                   bq=t[0], bkv=t[1])
    err = float((y.float() - yp.float()).abs().max())
    if not torch.isfinite(y).all() or err >= K2_TOL:
        fail(f"K2 {label} tiles {t}: abs err {err:.3e} >= {K2_TOL}")
    err_ref = ""
    if ref_out is not None:
        err_ref = f"|k-ref_f32|={float((y.float() - ref_out).abs().max()):.3e} "
    del y, yp
    ms = time_ms_over(lambda: ops.flash_attention(
        q, k, v, causal=True, scale=scale, tiles=t), [()])
    dev = sum(device_ms_by_kernel(lambda: ops.flash_attention(
        q, k, v, causal=True, scale=scale, tiles=t)).values()) or None
    plain_ms = time_ms_over(lambda: kfa.flash_attention_plain(
        q, k, v, causal=True, scale=scale, bq=t[0], bkv=t[1]), [()],
        reps=5, calls=1)
    def sdpa():
        return F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=H != Hkv)
    lib_ms = time_ms_over(sdpa, [()])
    lib_dev = sum(device_ms_by_kernel(sdpa).values()) or None
    flops, nbytes = k2_work(B, H, Hkv, S, k.shape[2], D)
    b, by = bound_s(flops, nbytes)
    share_ms = dev if dev is not None else ms
    dev_ratio = (f"{dev / lib_dev:.2f}x" if dev and lib_dev
                 else "not measured")
    print(f"[k2:{label}] B={B} H={H} Hkv={Hkv} S={S} D={D} causal "
          f"tiles={t} variant={variant} |k-plain|={err:.3e} {err_ref}"
          f"ms={ms:.4f} device_ms="
          f"{'not measured' if dev is None else f'{dev:.4f}'} "
          f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} sdpa_device_ms="
          f"{'not measured' if lib_dev is None else f'{lib_dev:.4f}'} "
          f"bound_ms={b * 1e3:.4f} ({by}) share_of_bound="
          f"{b * 1e3 / share_ms:.3f} "
          f"({'device' if dev is not None else 'stream'} ms) "
          f"vs_sdpa={ms / lib_ms:.2f}x (device {dev_ratio})", flush=True)
    return {"err": err, "ms": ms, "device_ms": dev, "plain_ms": plain_ms,
            "lib_ms": lib_ms, "lib_device_ms": lib_dev, "bound_s": b,
            "flops": flops, "bytes": nbytes, "variant": variant}


def k2_checks(gen):
    """K2 at the Qwen3-8B prefill in the served layout (q and k contiguous,
    v the transposed view of its projection) over every (bq, bkv) of the
    action space (the illegal ones must raise), then once at the
    measurement runner's shape (B=1, H=Hkv=128, contiguous)."""
    import torch
    from repro_torch.configs.neurovec import DEFAULT as NV
    from repro_torch.kernels import ops, ref
    B, H, Hkv, S, D = 4, 32, 8, 512, 128
    q = torch.randn((B, H, S, D), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, S, Hkv, D), generator=gen,
                    device="cuda").bfloat16().transpose(1, 2)
    rep = H // Hkv
    yr = ref.attention_ref(q.float(), k.float().repeat_interleave(rep, 1),
                           v.float().repeat_interleave(rep, 1), causal=True,
                           scale=D ** -0.5)
    recs = {}
    tiles = sorted({(min(bq, S), min(bkv, S))
                    for bq in NV.bq_choices for bkv in NV.bkv_choices})
    for t in tiles:
        if not ops.attention_tiles_legal(S, S, D, *t):
            try:
                ops.flash_attention(q, k, v, causal=True, scale=D ** -0.5,
                                    tiles=t)
            except ValueError:
                print(f"[k2] tiles={t}: illegal, raised as it must",
                      flush=True)
                continue
            fail(f"K2 launched the illegal tile {t}")
        recs[t] = k2_line("qwen3 prefill", q, k, v, t, ref_out=yr)
    del q, k, v, yr
    H = 128
    q, k, v = (torch.randn((1, H, S, D), generator=gen,
                           device="cuda").bfloat16() for _ in range(3))
    k2_line("runner", q, k, v, (128, 512))
    return recs


def k2_head_dim_checks(gen):
    """K2 at head dims below 128.  At the StableLM-3B prefill (B=4,
    H=Hkv=32, S=512, D=80, causal; q and k contiguous, v the transposed
    view of its projection, as the model passes them) over every (bq, bkv)
    of the action space (the illegal ones must raise), each line with its
    bound at the true D and SDPA's time; once with q, k and v all the
    transposed views of their projections (strides (S*H*D, D, H*D, 1)),
    and once through the unaligned variant (q 2 bytes into its storage).
    Then D = 64 and 96 at a small shape, both variants.  Returns the D =
    80 records by tile and the largest error of the other checks."""
    import torch
    from repro_torch.configs.neurovec import DEFAULT as NV
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops, ref
    B, H, S, D = 4, 32, 512, 80

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()
    q, k = rnd(B, H, S, D), rnd(B, H, S, D)
    v = rnd(B, S, H, D).transpose(1, 2)
    yr = ref.attention_ref(q.float(), k.float(), v.float(), causal=True,
                           scale=D ** -0.5)
    recs = {}
    tiles = sorted({(min(bq, S), min(bkv, S))
                    for bq in NV.bq_choices for bkv in NV.bkv_choices})
    for t in tiles:
        if not ops.attention_tiles_legal(S, S, D, *t):
            try:
                ops.flash_attention(q, k, v, causal=True, scale=D ** -0.5,
                                    tiles=t)
            except ValueError:
                print(f"[k2:d80] tiles={t}: illegal, raised as it must",
                      flush=True)
                continue
            fail(f"K2 launched the illegal tile {t} at D = {D}")
        recs[t] = k2_line("stablelm prefill", q, k, v, t, ref_out=yr)
    del yr
    qt, kt = (rnd(B, S, H, D).transpose(1, 2) for _ in range(2))
    k2_line("stablelm all-views", qt, kt, v, (128, 512))
    del qt, kt
    checks = [("d80 unaligned", D, rnd(B, H, S, D + 1)[..., 1:], k, v,
               "unaligned")]
    for d in (64, 96):
        b, h, hkv, s_ = 2, 8, 2, 256
        qd, kd, vd = rnd(b, h, s_, d), rnd(b, hkv, s_, d), rnd(b, hkv, s_, d)
        checks += [(f"d{d}", d, qd, kd, vd, "tma_wgmma"),
                   (f"d{d} unaligned", d, rnd(b, h, s_, d + 1)[..., 1:], kd,
                    vd, "unaligned")]
    small = 0.0
    for label, d, qc, kc, vc, want in checks:
        y, variant = k2_call(qc, kc, vc, (128, 128))
        yp = kfa.flash_attention_plain(qc, kc, vc, causal=True,
                                       scale=d ** -0.5, bq=128, bkv=128)
        err = float((y.float() - yp.float()).abs().max())
        print(f"[k2:{label}] shape={tuple(qc.shape)} variant={variant} "
              f"|k-plain|={err:.3e} (tol {K2_TOL})", flush=True)
        if variant != want or not torch.isfinite(y).all() or err >= K2_TOL:
            fail(f"K2 {label}: variant {variant} (want {want}), abs err "
                 f"{err:.3e}")
        small = max(small, err)
    return recs, small


# ---------------------------------------------------------------------------
# phase 3: K3
# ---------------------------------------------------------------------------

def k3_inputs(G, S, P, N, gen):
    """As the measurement runner builds them."""
    import torch
    import torch.nn.functional as F
    x = torch.randn((G, S, P), generator=gen, device="cuda").bfloat16()
    Bm = (torch.randn((G, S, N), generator=gen, device="cuda") * 0.3
          ).bfloat16()
    Cm = (torch.randn((G, S, N), generator=gen, device="cuda") * 0.3
          ).bfloat16()
    la = (-F.softplus(torch.randn((G, S), generator=gen,
                                  device="cuda"))).bfloat16()
    return x, Bm, Cm, la


def k3_work(S, P, N, Q):
    """Operations and bytes (x, B, C and la read once, y written once) of
    one call.  Per chunk the scan needs the causal half of the two Q x Q
    products, C.B^T (Q(Q+1)/2 dot products of length N) and its product
    with x (of length P), plus the two (Q, P, N) state products."""
    flops = (Q * (Q + 1.0) * (N + P) + 4.0 * Q * P * N) * (S // Q)
    return flops, 2.0 * (S * P + 2 * S * N + S + S * P)


def k3_check(inputs, Q, label):
    import torch
    from repro_torch.kernels import chunk_scan as kcs
    from repro_torch.kernels import ops
    x, Bm, Cm, la = inputs
    G, S, P = x.shape
    N = Bm.shape[-1]
    if not ops.chunk_tiles_legal(S, P, N, Q):
        try:
            ops.chunk_scan(x, Bm, Cm, la, chunk=Q)
        except kcs.TileError:
            print(f"[k3:{label}] Q={Q}: refused, raised TileError as it "
                  f"must", flush=True)
            return None
        fail(f"K3 launched the refused chunk {Q}")
    before = kcs.launches
    y = ops.chunk_scan(x, Bm, Cm, la, chunk=Q)
    torch.cuda.synchronize()
    if kcs.launches != before + 1:
        fail(f"K3 did not launch at Q={Q}")
    yp = kcs.chunk_scan_plain(x, Bm, Cm, la, chunk=Q).float()
    err = float((y.float() - yp).abs().max())
    rel = err / float(yp.abs().max())
    if not torch.isfinite(y).all() or rel >= K3_TOL:
        fail(f"K3 {label} Q={Q}: rel err {rel:.3e} >= {K3_TOL}")
    ms = time_ms_over(lambda: ops.chunk_scan(x, Bm, Cm, la, chunk=Q), [()])
    plain_ms = time_ms_over(lambda: kcs.chunk_scan_plain(x, Bm, Cm, la,
                                                         chunk=Q), [()],
                            reps=3, calls=1)
    flops, nbytes = k3_work(S, P, N, Q)
    b, by = bound_s(flops, nbytes)
    passes = device_ms_by_kernel(lambda: ops.chunk_scan(x, Bm, Cm, la,
                                                        chunk=Q))
    dev = sum(passes.values()) or None
    variant = ops.chunk_launch_plan(G, S, P, N, Q).variant
    share = (f"{b * 1e3 / dev:.3f} (device ms)" if dev
             else "not measured")
    print(f"[k3:{label}] G={G} S={S} P={P} N={N} Q={Q} variant={variant} "
          f"rel_err={rel:.2e} |k-plain|={err:.3e} ms={ms:.4f} device_ms="
          f"{'not measured' if dev is None else f'{dev:.4f}'} "
          f"plain_ms={plain_ms:.4f} library_ms=none (no single PyTorch "
          f"call) bound_ms={b * 1e3:.4f} ({by}) share_of_bound={share}; "
          f"device ms by pass (profiler): {passes}", flush=True)
    return {"err": err, "rel": rel, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev, "passes": passes, "variant": variant,
            "bound_s": b, "bound_by": by, "flops": flops, "bytes": nbytes}


def device_ms_by_kernel(fn, reps: int = 5) -> dict:
    """Device ms of one launch of each kernel ``fn`` runs, from a
    ``torch.profiler`` trace of ``reps`` calls: each kernel's total over
    the number of its launches the trace recorded (the trace may drop the
    first launches of a window, so a total over ``reps`` would
    undercount; a trace that recorded no device time at all is taken
    again, up to three times).  Each kernel here launches once per call of
    its wrapper."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    tot, cnt = {}, {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_time_total > 0:
                name = e.key.replace("(anonymous namespace)::", "")
                name = name.split("<")[0].split("(")[0].split("::")[-1]
                tot[name] = tot.get(name, 0.0) + e.device_time_total / 1e3
                cnt[name] = cnt.get(name, 0) + e.count
        if tot:
            break
    out = {k: tot[k] / cnt[k] for k in tot}
    return {k: round(v, 4) for k, v in out.items()}


def k3_checks(site, gen):
    """Every chunk of the action space at the xLSTM site, two chunks past
    it, and a Mamba-2 head; returns the xLSTM records by Q and the Mamba-2
    head's record."""
    import torch
    from repro_torch.configs.neurovec import DEFAULT as NV
    inputs = k3_inputs(1, site.batch * site.m, site.n, site.k, gen)
    recs = {}
    for q in NV.chunk_choices + (2048, 4096):
        r = k3_check(inputs, q, "xlstm")
        if r is not None:
            recs[q] = r
    del inputs
    m = MAMBA
    mamba = k3_check(k3_inputs(m["G"], m["S"], m["P"], m["N"], gen),
                     m["Q"], "mamba2")
    torch.cuda.empty_cache()
    return recs, mamba


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def zero_counts():
    from repro_torch.kernels import chunk_scan as kcs
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    kmm.reset_counts()
    kfa.reset_counts()
    kcs.launches = 0


def path_variants(path: str, counts: dict) -> None:
    """K1's and K2's launches by variant since zero_counts(), into
    ``counts``; a model path must never take an unaligned variant."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    for name, mod in (("matmul", kmm), ("flash_attention", kfa)):
        by = dict(mod.launches_by_variant)
        if by["unaligned"]:
            fail(f"{path}: {by['unaligned']} {name} launches took the "
                 f"unaligned variant")
        print(f"[{path}] {name} launches by variant: {by}", flush=True)
        counts[f"{name}_by_variant"] = by


def read_counts():
    from repro_torch.kernels import chunk_scan as kcs
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    return {"matmul": kmm.launches, "flash_attention": kfa.launches,
            "chunk_scan": kcs.launches}


def per_pass_launches(cfg):
    """Kernel launches of one prefill and of one decode step under
    --inject: K1 at every matmul of a block and the head, K2 at prefill
    attention; the mLSTM scan and the einsums stay plain PyTorch."""
    per = {"attn": (7, 1), "mlstm": (2, 0), "slstm": (3, 0)}
    mm = 1 + cfg.n_periods * sum(per[b.kind][0] for b in cfg.period)
    att = cfg.n_periods * sum(per[b.kind][1] for b in cfg.period)
    return ({"matmul": mm, "flash_attention": att, "chunk_scan": 0},
            {"matmul": mm * (GEN - 1), "flash_attention": 0,
             "chunk_scan": 0})


def measured_path(arch, params=None, prompts=None, agent="ppo", extra=(),
                  worker_dir=None):
    """serve --autotune ``agent`` --measured --inject at full width,
    counters zeroed just before and read just after; checked against eager
    mode on the same prompts.  With ``worker_dir`` the timings ran in
    worker processes, which wrote their launch counters there: this
    process must have launched nothing during the fit, and the workers
    every kernel of the path's sites."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--full", "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN), "--autotune", agent,
            "--autotune-steps", str(STEPS), "--measured", *extra, "--inject"]
    print(f"[measured] serve.run({argv})", flush=True)
    zero_counts()
    t0 = time.perf_counter()
    res = serve.run(serve.parse_args(argv), params=params, prompts=prompts)
    wall = time.perf_counter() - t0
    counts = read_counts()
    tun = res.tuning
    st = tun["stats"]
    cfg = res.model.cfg
    n_timed = st["transport_timed_pairs_total"]
    print(f"[measured:{arch}] launches in the run: {counts}; tuning "
          f"{tun['launches']}; by pass {res.launches}; wall {wall:.1f} s; "
          f"fit {tun['fit_s']:.1f} s for {n_timed} timed pairs "
          f"({tun['fit_s'] / max(n_timed, 1) * 1e3:.1f} ms a pair, the "
          f"{agent} fit and tune included); "
          f"{st['transport_failed_pairs_total']} failed, "
          f"{st['transport_hits_total']} DB hits, "
          f"{st['transport_coalesced_total']} coalesced; health "
          f"{tun['health']}; {tun['backend_key']}", flush=True)
    if st["transport_failed_pairs_total"] or tun["failures"]:
        fail(f"{arch}: failed timings {tun['failures']}")
    if tun["breaker_open"] or tun["health"] != "ok":
        fail(f"{arch}: breaker open or health {tun['health']}")
    if n_timed == 0:
        fail(f"{arch}: the measured oracle timed nothing")
    want_pre, want_dec = per_pass_launches(cfg)
    if res.launches != {"prefill": want_pre, "decode": want_dec}:
        fail(f"{arch}: launch counts by pass {res.launches}")
    n_pre = 1 + len(res.prefill_ms_runs)
    n_dec = 1 + len(res.decode_tok_s_runs)
    total = {k: tun["launches"][k] + want_pre[k] * n_pre + want_dec[k] * n_dec
             for k in counts}
    if counts != total:
        fail(f"{arch}: total launch counts {counts} != {total}")
    path_variants(f"measured:{arch}:{agent}", counts)
    kinds = {s.kind for s in res.sites}
    need = {"matmul": "matmul", "attention": "flash_attention",
            "chunk_scan": "chunk_scan"}
    fit_launches = tun["launches"]
    if worker_dir is not None:
        if any(tun["launches"].values()):
            fail(f"{arch}: {tun['launches']} launches in this process "
                 f"during a fit timed in workers")
        fit_launches = worker_counts(worker_dir)
        print(f"[measured:{arch}] launches in the workers during the fit: "
              f"{fit_launches}", flush=True)
    for kind in kinds:
        if fit_launches[need[kind]] == 0:
            fail(f"{arch}: the {need[kind]} kernel never launched during "
                 f"the measured fit")
    if counts["matmul"] == 0 or ("attention" in kinds
                                 and counts["flash_attention"] == 0):
        fail(f"{arch}: a kernel of the path was never launched")
    bad = [s.key() for s in res.sites
           if not ops.tile_ok(s, res.prog.tiles[s.key()])]
    if bad:
        fail(f"{arch}: tuned tiles that cannot launch: {bad}")
    logits = res.prefill_logits
    if logits.shape != (BATCH, cfg.vocab_size) or \
            not torch.isfinite(logits).all() or res.seq.shape != (BATCH, GEN):
        fail(f"{arch}: logits {tuple(logits.shape)} / tokens "
             f"{tuple(res.seq.shape)}")
    eager = serve.run(serve.parse_args(argv[:argv.index("--autotune")]),
                      params=res.params, prompts=res.prompts)
    rel = float((logits - eager.prefill_logits).abs().max()
                / eager.prefill_logits.abs().max())
    agree = float((res.seq == eager.seq).float().mean())
    print(f"[measured:{arch}] kernel vs eager prefill logits: relative "
          f"{rel:.4e} (tol {LOGIT_TOL}); greedy tokens agree "
          f"{agree * 100:.1f}%; kernels: prefill ms {res.prefill_ms:.2f} of "
          f"{[round(t, 2) for t in res.prefill_ms_runs]}, decode tok/s "
          f"{res.decode_tok_s:.2f} of "
          f"{[round(t, 2) for t in res.decode_tok_s_runs]}; eager: prefill "
          f"ms {eager.prefill_ms:.2f} of "
          f"{[round(t, 2) for t in eager.prefill_ms_runs]}, decode tok/s "
          f"{eager.decode_tok_s:.2f} of "
          f"{[round(t, 2) for t in eager.decode_tok_s_runs]}; measured "
          f"H100 speedup of the tuned program {res.modelled_speedup:.3f}x",
          flush=True)
    if rel >= LOGIT_TOL:
        fail(f"{arch}: prefill logits differ from eager: {rel:.3e}")
    print(f"[measured:{arch}] tuned tiles: " + ", ".join(
        f"{s.site}@M={s.m}:{tuple(res.prog.tiles[s.key()])}"
        for s in res.sites), flush=True)
    return res, counts, eager.prefill_logits


def worker_counts(worker_dir) -> dict:
    """The kernel launches that measurement workers reported: the sum of
    the ``worker-<pid>.json`` files they wrote under ``worker_dir``
    (``REPRO_TORCH_LAUNCH_DIR``), K1's and K2's by variant too."""
    total = {"matmul": 0, "flash_attention": 0, "chunk_scan": 0,
             "matmul_by_variant": {}, "flash_attention_by_variant": {}}
    for f in sorted(Path(worker_dir).glob("worker-*.json")):
        c = json.loads(f.read_text())
        for k, v in c.items():
            if isinstance(v, dict):
                for var, n in v.items():
                    total[k][var] = total[k].get(var, 0) + n
            else:
                total[k] += v
    return total


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_f32(v) for v in tree)
    return tree.float()


def xlstm_model_checks(res, eager_logits):
    """The full-width xlstm_1_3b model, beyond kernel-vs-eager (which K1
    passes bitwise at M = 2048, so it cannot see a model fault).  Its
    kernel-path bf16 prefill logits differ across the batch rows and lie
    within XL_F32_TOL of an f32 eager prefill of the same weights, and
    within XL_EAGER_FACTOR times the bf16 eager path's own distance to it
    (the 48 recurrent layers amplify bf16 rounding, so a kernel that
    rounds at other places than cuBLAS is held against the f32 prefill);
    that f32 prefill (the chunkwise mLSTM) matches feeding the prompt one
    token at a time through the f32 decode recurrence within RECUR_TOL."""
    import torch
    model, prompts, logits = res.model, res.prompts, res.prefill_logits
    spread = [float((logits[i] - logits[0]).abs().max())
              for i in range(1, BATCH)]
    if min(spread) == 0.0:
        fail(f"{XLSTM}: prefill logits equal across batch rows {spread}")
    p32 = _f32(res.params)
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref, _ = model.prefill(p32, {"tokens": prompts},
                               model.make_cache(BATCH, PROMPT, device="cuda"))
        cache = model.make_cache(BATCH, PROMPT, device="cuda")
        for t in range(PROMPT):
            rec, cache = model.decode_step(p32, prompts[:, t:t + 1], t, cache)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del p32, cache
    top = float(ref.abs().max())
    rel_f32 = float((logits - ref).abs().max()) / top
    eager_f32 = float((eager_logits - ref).abs().max()) / top
    l2_f32 = float((logits - ref).norm() / ref.norm())
    rel_rec = float((rec - ref).abs().max()) / top
    print(f"[measured:{XLSTM}] bf16 prefill logits: rows differ from row 0 "
          f"by max {[round(v, 3) for v in spread]}; argmax by row "
          f"{logits.argmax(-1).tolist()} (f32 {ref.argmax(-1).tolist()}; "
          f"last prompt tokens {prompts[:, -1].tolist()}); vs f32 eager, "
          f"max of the largest logit: kernels {rel_f32:.4e}, bf16 eager "
          f"{eager_f32:.4e} (tol {XL_EAGER_FACTOR} x eager and "
          f"{XL_F32_TOL}), kernels l2 {l2_f32:.4e}; f32 chunkwise prefill "
          f"vs f32 token-by-token decode over {PROMPT} tokens: "
          f"{rel_rec:.4e} (tol {RECUR_TOL}); {wall:.1f} s", flush=True)
    if not torch.isfinite(ref).all() or rel_f32 >= XL_F32_TOL:
        fail(f"{XLSTM}: bf16 prefill logits {rel_f32:.3e} off f32")
    if rel_f32 > XL_EAGER_FACTOR * eager_f32:
        fail(f"{XLSTM}: kernel-path logits {rel_f32:.3e} off f32, more than "
             f"{XL_EAGER_FACTOR} x the bf16 eager path's {eager_f32:.3e}")
    if not torch.isfinite(rec).all() or rel_rec >= RECUR_TOL:
        fail(f"{XLSTM}: chunkwise prefill {rel_rec:.3e} off the recurrence")


def main_path():
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--full", "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN), "--autotune", "ppo",
            "--autotune-steps", str(STEPS), "--inject"]
    print(f"[main] serve.main({argv}) (full depth: 36 layers)", flush=True)
    zero_counts()
    t0 = time.perf_counter()
    res = serve.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"[main] launches in the run: {counts}; by phase: {res.launches}; "
          f"wall {wall:.1f} s (tuning included)", flush=True)
    cfg = res.model.cfg
    per_pass = cfg.n_layers * 7 + 1
    want = {"prefill": {"matmul": per_pass, "flash_attention": cfg.n_layers,
                        "chunk_scan": 0},
            "decode": {"matmul": per_pass * (GEN - 1),
                       "flash_attention": 0, "chunk_scan": 0}}
    if res.launches != want:
        fail(f"launch counts {res.launches} != {want}")
    # one untimed pass, then the timed prefills and decode windows
    n_pre = 1 + len(res.prefill_ms_runs)
    n_dec = 1 + len(res.decode_tok_s_runs)
    if any(counts[k] != want["prefill"][k] * n_pre + want["decode"][k] * n_dec
           for k in want["prefill"]):
        fail(f"total launch counts {counts} over {n_pre} prefills and "
             f"{n_dec} decode windows")
    path_variants("main", counts)
    bad = [s.key() for s in res.sites if not ops.tile_ok(s, res.prog.tiles[
        s.key()])]
    if bad:
        fail(f"the tuned program names tiles that cannot launch: {bad}")
    if counts["matmul"] == 0 or counts["flash_attention"] == 0:
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


def prefill_breakdown(model, params, prompts, prog, label):
    """One prefill under ``prog`` (eager mode for ``None``): the wall ms
    (median of 3, after a warm pass), and from a ``torch.profiler`` trace
    of one more the device's busy ms, its idle share of that prefill's
    wall time, and the kernels that took the most device time."""
    import contextlib
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.vectorizer import inject
    cache = model.make_cache(BATCH, PROMPT + GEN, device="cuda")
    ctx = inject(prog) if prog is not None else contextlib.nullcontext()
    with torch.inference_mode(), ctx:
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(params, {"tokens": prompts}, cache)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.prefill(params, {"tokens": prompts}, cache)
            torch.cuda.synchronize()
    wall = statistics.median(walls[1:])
    by = {}
    for e in prof.key_averages():       # kernels only: an operator's
        # device time is its kernels', which would count twice
        if str(getattr(e, "device_type", "")).endswith("CUDA") and \
                e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0].split("::")[-1][:40]
            by[name] = by.get(name, 0.0) + e.self_device_time_total / 1e3
    busy = sum(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
    print(f"[stablelm:breakdown] {label}: prefill wall {wall:.2f} ms (median "
          f"of 3), device busy {busy:.2f} ms, idle "
          f"{max(0.0, 1 - busy / wall) * 100:.1f}% of the wall; top device "
          f"ms: " + ", ".join(f"{k} {v:.2f}" for k, v in top), flush=True)
    return {"wall_ms": wall, "busy_ms": busy, "top": top}


def stablelm_path(gen):
    """The paper's main-path loop (``tests/test_system.py:22-55``) on the
    full-width StableLM-3B (32 layers, head dim 80, bf16, random weights
    from seed 0): its serve sites extracted; PPO fit on
    ``dataset.generate(400, seed=0, base=sites)`` under
    ``CostModelEnv(legality="h100")``; the sites tuned over their legal
    tiles (modelled speedup: the TPU v5e formula); ``serve --tiles
    --inject`` with that program (counters zeroed just before, read just
    after) against eager mode; then ``serve --autotune brute --measured
    --inject``, whose pick at every site must be the fastest tile it
    timed, and PPO's program priced from the same timings.  Returns the
    records the kernels line needs."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.neurovec import DEFAULT, NeuroVecConfig
    from repro_torch.core import dataset
    from repro_torch.core.agents import PPOAgent
    from repro_torch.core.costmodel import baseline_tiles
    from repro_torch.core.costmodel_vec import action_tiles_grid
    from repro_torch.core.env import ActionSpace, CostModelEnv
    from repro_torch.core.extractor import extract_serve_sites
    from repro_torch.core.vectorizer import program_speedup, tune
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.measure import make_measured_env
    from repro_torch.models.lm import build_model
    cfg = get_config(STABLELM)
    sites = extract_serve_sites(build_model(cfg), BATCH, PROMPT, GEN)
    corpus = dataset.generate(LOOP_CORPUS, seed=0, base=sites)
    nv = NeuroVecConfig(**LOOP_NV)
    env = CostModelEnv(nv, legality="h100")
    refused = int((~np.isfinite(env.cost_grid(corpus)).any(1)).sum())
    agent = PPOAgent(nv, lr=LOOP_LR, seed=0, device="cuda")
    t0 = time.perf_counter()
    agent.fit(corpus, env, total_steps=LOOP_STEPS)
    fit_s = time.perf_counter() - t0
    prog = tune(sites, agent, env.space, env)
    sp = program_speedup(prog, sites, env)
    print(f"[stablelm] {len(sites)} serve sites; corpus of {len(corpus)} "
          f"sites ({refused} with no tile the kernels launch: f32, or a "
          f"head dim the rule refuses); PPO fit {LOOP_STEPS} steps in "
          f"{fit_s:.1f} s (last mean reward "
          f"{agent.history[-1]['reward_mean']:.3f}); TPU-v5e-modelled "
          f"speedup of the tuned program {sp:.3f}x (cost model, not an "
          f"H100 number)", flush=True)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    tiles_path = build_dir / "stablelm_ppo_tiles.json"
    prog.save(str(tiles_path))
    argv = ["--arch", STABLELM, "--full", "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen", str(GEN), "--tiles",
            str(tiles_path), "--inject"]
    print(f"[stablelm] serve.run({argv}) (full depth: {cfg.n_layers} "
          f"layers)", flush=True)
    zero_counts()
    res = serve.run(serve.parse_args(argv))
    counts = read_counts()
    want_pre, want_dec = per_pass_launches(cfg)
    n_pre = 1 + len(res.prefill_ms_runs)
    n_dec = 1 + len(res.decode_tok_s_runs)
    total = {k: want_pre[k] * n_pre + want_dec[k] * n_dec for k in counts}
    print(f"[stablelm] launches in the run: {counts}; by pass "
          f"{res.launches}", flush=True)
    if res.launches != {"prefill": want_pre, "decode": want_dec} or \
            counts != total:
        fail(f"stablelm: launch counts {res.launches} / {counts} != "
             f"{want_pre} {want_dec} / {total}")
    path_variants("stablelm:ppo", counts)
    bad = [s.key() for s in sites if not ops.tile_ok(s, prog.tiles[s.key()])]
    if bad or counts["matmul"] == 0 or counts["flash_attention"] == 0:
        fail(f"stablelm: tiles that cannot launch {bad}, or a kernel never "
             f"launched {counts}")
    logits = res.prefill_logits
    if logits.shape != (BATCH, cfg.vocab_size) or \
            not torch.isfinite(logits).all() or res.seq.shape != (BATCH, GEN):
        fail(f"stablelm: logits {tuple(logits.shape)} / tokens "
             f"{tuple(res.seq.shape)}")
    eager = serve.run(serve.parse_args(argv[:argv.index("--tiles")]),
                      params=res.params, prompts=res.prompts)
    rel = float((logits - eager.prefill_logits).abs().max()
                / eager.prefill_logits.abs().max())
    agree = float((res.seq == eager.seq).float().mean())

    def spread(r):
        return (f"prefill ms {r.prefill_ms:.2f} of "
                f"{[round(t, 2) for t in r.prefill_ms_runs]}, decode tok/s "
                f"{r.decode_tok_s:.2f} of "
                f"{[round(t, 2) for t in r.decode_tok_s_runs]}")
    print(f"[stablelm] kernel vs eager prefill logits: relative {rel:.4e} "
          f"(tol {LOGIT_TOL}); greedy tokens agree {agree * 100:.1f}%; "
          f"kernels (PPO tiles): {spread(res)}; eager: {spread(eager)}",
          flush=True)
    if rel >= LOGIT_TOL:
        fail(f"stablelm: prefill logits differ from eager: {rel:.3e}")
    print(f"[stablelm] PPO tiles: " + ", ".join(
        f"{s.site}@M={s.m}:{tuple(prog.tiles[s.key()])}" for s in sites),
        flush=True)
    params, prompts = res.params, res.prompts
    del res, eager
    # K1 at each StableLM shape under the baseline and the PPO tile (q, k,
    # v and o share a shape: each shape and tile is checked once)
    k1_tuned, k1_launches, seen = {}, {}, {}
    for s in sites:
        if s.kind != "matmul":
            continue
        shape = (s.m, s.n, s.k, s.site == "lm_head")
        for tiles, how in ((baseline_tiles(s), "baseline"),
                           (prog.tiles[s.key()], "tuned")):
            key = (shape, tuple(tiles))
            if key not in seen:
                seen[key] = k1_check(shape, tiles, f"stablelm {how}:{s.site}",
                                     gen)
        k1_tuned[s.key()] = seen[(shape, tuple(prog.tiles[s.key()]))]
        k1_launches[s.key()] = 2 if s.site == "lm_head" else cfg.n_layers
    att = next(s for s in sites if s.kind == "attention" and s.m > 1)
    t_att = tuple(min(a, PROMPT) for a in prog.tiles[att.key()][:2])
    # brute force under the measured oracle, from a fresh timing DB
    db = build_dir / "stablelm_measure.jsonl"
    if db.exists():
        db.unlink()
    b_res, b_counts, _ = measured_path(STABLELM, params, prompts,
                                       agent="brute",
                                       extra=("--measure-db", str(db)))
    # brute force takes the fastest tile of the action space it timed (the
    # runner also timed each site's baseline tile, which may lie outside
    # the action space: bq = 8 at decode attention)
    picks = b_res.tuning["picks"]
    slow = []
    for s in sites:
        p = picks[s.key()]
        grid = {tuple(int(x) for x in t)
                for t in action_tiles_grid(ActionSpace(DEFAULT), s.kind)}
        best = min(v for t, v in p["timed"].items() if tuple(t) in grid)
        if p["pick_s"] > best:
            slow.append((s.key(), p["pick"], p["pick_s"], best))
    if slow:
        fail(f"stablelm: brute force did not take the fastest tile of the "
             f"action space it timed: {slow}")
    menv = make_measured_env(DEFAULT, db_path=str(db), device="cuda",
                             legality="h100")
    ppo_measured = program_speedup(prog, sites, menv)
    base_s = menv.baseline_costs(sites)
    for s, t_base in zip(sites, base_s):
        t_ppo = float(menv.tiles_costs([s], [prog.tiles[s.key()][:3]])[0])
        p = picks[s.key()]
        print(f"[stablelm] {s.site}@M={s.m}: the runner's ms: baseline "
              f"{tuple(baseline_tiles(s))} {t_base * 1e3:.4f}, PPO "
              f"{tuple(prog.tiles[s.key()])} {t_ppo * 1e3:.4f}, brute "
              f"{tuple(p['pick'])} {p['pick_s'] * 1e3:.4f}", flush=True)
    st = menv.measure_fn.transport.stats()
    menv.measure_fn.transport.close()
    print(f"[stablelm] measured H100 speedup over the baseline tiles at "
          f"the {len(sites)} serve sites: brute force "
          f"{b_res.modelled_speedup:.3f}x, PPO on the corpus "
          f"{ppo_measured:.3f}x (PPO's tiles priced from brute force's "
          f"timings: {st['transport_hits_total']} DB hits, "
          f"{st['transport_timed_pairs_total']} timed anew)", flush=True)
    brute_tiles, brute_sp = dict(b_res.prog.tiles), b_res.modelled_speedup
    # where a prefill's time goes, each program in turn, then eager
    breakdown = {}
    for label, p_ in (("PPO tiles", prog), ("brute tiles", b_res.prog),
                      ("eager", None), ("PPO tiles again", prog),
                      ("brute tiles again", b_res.prog)):
        breakdown[label] = prefill_breakdown(b_res.model, params, prompts,
                                             p_, label)
    del b_res, params, prompts
    torch.cuda.empty_cache()
    return {"ppo": counts, "brute": b_counts, "k1_tuned": k1_tuned,
            "k1_launches": k1_launches, "t_att": t_att,
            "n_layers": cfg.n_layers, "modelled_speedup": sp,
            "ppo_measured_speedup": ppo_measured,
            "brute_measured_speedup": brute_sp, "brute_tiles": brute_tiles,
            "breakdown": breakdown, "db": db}


# ---------------------------------------------------------------------------
# phase 8: the facade
# ---------------------------------------------------------------------------

def take_counts(acc: dict) -> dict:
    """Add the launches since the last zero_counts() (and K1's and K2's by
    variant) into ``acc``, zero the counters, and return the segment's."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    seg = read_counts()
    for k, v in seg.items():
        acc[k] = acc.get(k, 0) + v
    for name, mod in (("matmul", kmm), ("flash_attention", kfa)):
        by = acc.setdefault(f"{name}_by_variant", {})
        for var, n in mod.launches_by_variant.items():
            by[var] = by.get(var, 0) + n
    zero_counts()
    return seg


def facade_path():
    """Phase 8: the full-width StableLM-3B through ``repro_torch.api`` only.
    (1) A brute-force facade against the measured oracle, with a fresh
    timing DB and program store under ``build/``: fit, tune, its measured
    speedup and health.  (2) One prefill under ``nv.inject(prog)``: K1's
    and K2's launches must be a prefill's, the logits eager's within
    LOGIT_TOL.  (3) save, a store hit with no inference, load with the same
    DB and store, and a refit of a load without the store that times
    nothing.  (4) The seven methods of ``make_agent``, each fitted on the
    corpus under ``CostModelEnv(legality="h100")``, tuned, checked by
    ``ops.tile_ok`` and priced by the facade's measured oracle.  (5) The
    port's quickstart at its own sizes.  Counters are zeroed at the start
    and read at the end of each step; the sum is the path's."""
    import importlib.util
    import shutil
    import statistics

    import numpy as np
    import torch
    from repro_torch.api import (AGENT_NAMES, CostModelEnv, NeuroVecConfig,
                                 NeuroVectorizer, make_agent)
    from repro_torch.configs import get_config
    from repro_torch.core import dataset
    from repro_torch.core.extractor import extract_serve_sites
    from repro_torch.kernels import ops
    from repro_torch.models.lm import build_model
    from repro_torch.train.steps import make_prefill_step
    cfg = get_config(STABLELM)
    model = build_model(cfg)
    sites = extract_serve_sites(model, BATCH, PROMPT, GEN)
    nvc = NeuroVecConfig(**LOOP_NV)
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    db, store = (build_dir / "facade_measure.jsonl",
                 build_dir / "facade_programs.jsonl")
    ckpt = build_dir / "facade_ckpt"
    for f in (db, store):
        f.unlink(missing_ok=True)
    shutil.rmtree(ckpt, ignore_errors=True)
    acc, out = {}, {}
    zero_counts()

    # (1) build and tune
    t0 = time.perf_counter()
    nv = NeuroVectorizer(nvc, agent="brute", oracle="measured",
                         db_path=str(db), program_store=str(store),
                         device="cuda")
    prog = nv.fit(sites).tune_sites(sites)
    fit_s = time.perf_counter() - t0
    transport = nv.oracle.measure_fn.transport
    st = transport.stats()
    sp, health = nv.speedup(prog, sites), nv.health()
    fit_seg = take_counts(acc)
    print(f"[facade] brute, measured: {st['transport_timed_pairs_total']} "
          f"pairs timed, {st['transport_failed_pairs_total']} failed, in "
          f"{fit_s:.1f} s (facade built, fitted and tuned); measured H100 "
          f"speedup over the baseline tiles {sp:.3f}x; health {health}; "
          f"launches {fit_seg}", flush=True)
    if health != "ok" or st["transport_failed_pairs_total"] or \
            st["transport_timed_pairs_total"] == 0:
        fail(f"facade: health {health}, stats {st}")
    bad = [s.key() for s in sites if not ops.tile_ok(s, prog.tiles[s.key()])]
    if bad:
        fail(f"facade: brute tiles that cannot launch: {bad}")
    out.update(timed=st["transport_timed_pairs_total"], fit_s=fit_s,
               measured_speedup=sp)

    # (2) inject: one prefill against eager mode
    params = model.init(seed=0, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(1)
                            ).cuda()
    cache = model.make_cache(BATCH, PROMPT + GEN, device="cuda")
    prefill = make_prefill_step(model)
    with torch.inference_mode():
        eager, _ = prefill(params, {"tokens": prompts}, cache)
        take_counts(acc)
        with nv.inject(prog):
            logits, _ = prefill(params, {"tokens": prompts}, cache)
            torch.cuda.synchronize()
            seg = take_counts(acc)
            walls = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prefill(params, {"tokens": prompts}, cache)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        take_counts(acc)
    want = per_pass_launches(cfg)[0]
    rel = float((logits.float() - eager.float()).abs().max()
                / eager.float().abs().max())
    prefill_ms = statistics.median(walls[1:])
    print(f"[facade] prefill under nv.inject(prog): launches {seg} (a "
          f"prefill's: {want}); logits vs eager: relative {rel:.4e} (tol "
          f"{LOGIT_TOL}); prefill ms {prefill_ms:.2f} (median of 5 after a "
          f"warm pass, of {[round(w, 2) for w in walls[1:]]})", flush=True)
    if seg != want:
        fail(f"facade: prefill launches {seg} != {want}")
    if not torch.isfinite(logits).all() or \
            logits.shape != (BATCH, cfg.vocab_size) or rel >= LOGIT_TOL:
        fail(f"facade: injected prefill logits {tuple(logits.shape)} "
             f"differ from eager: {rel:.3e}")
    out.update(prefill_launches=seg, logits_rel=rel, prefill_ms=prefill_ms,
               prefill_ms_runs=walls[1:])
    del params, cache, eager, logits
    torch.cuda.empty_cache()

    # (3) persist and warm-start
    fp = nv.save(str(ckpt))
    inferences = nv.agent_inferences
    again = nv.tune_sites(sites)
    if again.tiles != prog.tiles or nv.store_hits != 1 or \
            nv.agent_inferences != inferences:
        fail(f"facade: second tune_sites: store hits {nv.store_hits}, "
             f"inferences {inferences} -> {nv.agent_inferences}")
    nv2 = NeuroVectorizer.load(str(ckpt), db_path=str(db),
                               program_store=str(store), device="cuda")
    p2 = nv2.tune_sites(sites)
    nv3 = NeuroVectorizer.load(str(ckpt), db_path=str(db), device="cuda")
    p3 = nv3.fit(sites).tune_sites(sites)
    st3 = nv3.oracle.measure_fn.transport.stats()
    print(f"[facade] saved (agent fingerprint {fp[:16]}); a second "
          f"tune_sites: store hits {nv.store_hits}, agent inferences "
          f"{nv.agent_inferences} (unchanged); loaded with the DB and the "
          f"store: same program {p2.tiles == prog.tiles} (store hits "
          f"{nv2.store_hits}, inferences {nv2.agent_inferences}); loaded "
          f"and refitted against the warm DB without the store: same "
          f"program {p3.tiles == prog.tiles}, "
          f"{st3['transport_timed_pairs_total']} pairs timed, "
          f"{st3['transport_hits_total']} DB hits", flush=True)
    for name, p_ in (("loaded", p2), ("refitted", p3)):
        diff = [k for k in prog.tiles if p_.tiles.get(k) != prog.tiles[k]]
        if diff or set(p_.tiles) != set(prog.tiles):
            fail(f"facade: the {name} facade's program differs at {diff}")
    if nv2.store_hits != 1 or nv2.agent_inferences:
        fail(f"facade: the loaded facade's store hits {nv2.store_hits}, "
             f"inferences {nv2.agent_inferences}")
    if st3["transport_timed_pairs_total"] != 0:
        fail(f"facade: the warm refit timed {st3}")
    nv2.close()
    nv3.close()
    take_counts(acc)

    # (4) the seven methods, priced by the facade's measured oracle
    corpus = dataset.generate(LOOP_CORPUS, seed=0, base=sites)
    env = CostModelEnv(nvc, legality="h100")
    methods = {}
    for name in AGENT_NAMES:
        agent = make_agent(name, nvc, seed=0, device="cuda",
                           **({"lr": LOOP_LR} if name == "ppo" else {}))
        nv_m = NeuroVectorizer(nvc, agent=agent, oracle=env, metrics=False,
                               device="cuda")
        t0 = time.perf_counter()
        nv_m.fit(corpus, **({"total_steps": LOOP_STEPS} if name == "ppo"
                            else {}))
        p_m = nv_m.tune_sites(sites)
        fit_m = time.perf_counter() - t0
        bad = [s.key() for s in sites
               if not ops.tile_ok(s, p_m.tiles[s.key()])]
        if bad:
            fail(f"facade: {name} tuned tiles that cannot launch: {bad}")
        modelled = nv_m.speedup(p_m, sites)
        before = transport.stats()["transport_timed_pairs_total"]
        measured = nv.speedup(p_m, sites)
        extra = transport.stats()["transport_timed_pairs_total"] - before
        nv_m.close()
        methods[name] = {"fit_s": fit_m, "modelled_speedup": modelled,
                         "measured_speedup": measured, "timed_anew": extra}
        print(f"[facade:{name}] fit on {len(corpus)} corpus sites and tune "
              f"in {fit_m:.1f} s; speedup over the baseline tiles: "
              f"TPU-v5e-modelled {modelled:.3f}x, measured on the H100 "
              f"{measured:.3f}x ({extra} pairs timed beyond step 1)",
              flush=True)
        if not np.isfinite(measured) or measured <= 0:
            fail(f"facade: {name}'s measured speedup {measured}")
    nv.close()
    take_counts(acc)
    out["methods"] = methods

    # (5) the quickstart on the card at its own sizes
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    t0 = time.perf_counter()
    q = qs.main(["--device", "cuda"])
    q_seg = take_counts(acc)
    if q_seg["matmul"] != 1:
        fail(f"facade: the quickstart's injected matmul launched {q_seg}")
    q["wall_s"] = time.perf_counter() - t0
    print(f"[facade:quickstart] {q['sites']} qwen3_8b train sites; reward "
          f"{q['reward_first']:+.3f} -> {q['reward_last']:+.3f}; modelled "
          f"speedup {q['speedup']:.3f}x; bf16 demo matmul at "
          f"{q['tiles']}: relative error {q['rel_err']:.2e} (tol "
          f"{qs.DEMO_TOL}); {q['wall_s']:.1f} s", flush=True)
    out["quickstart"] = q
    for name in ("matmul", "flash_attention"):
        if acc[f"{name}_by_variant"].get("unaligned"):
            fail(f"facade: {acc[f'{name}_by_variant']['unaligned']} {name} "
                 f"launches took the unaligned variant")
    print(f"[facade] launches in the path: {acc}", flush=True)
    del model
    torch.cuda.empty_cache()
    return acc, out


# ---------------------------------------------------------------------------
# phase 9: the transports on the card
# ---------------------------------------------------------------------------

LAUNCH_ENV = "REPRO_TORCH_LAUNCH_DIR"       # repro_torch.measure.worker's
POOL_SPAWN_S, POOL_JOB_S = 300.0, 60.0      # the pools' timeouts here
CHAOS_JOB_S = 10.0                          # a hang is killed after this


class CardFaultRunner:
    """The port's runner on the card that, the first time any worker sees
    the pair ``$CHIP_SMOKE_MARK`` (``site key|tiles``), triggers a
    device-side assert (an index out of range on a CUDA tensor), which
    poisons its context; the sentinel file ``$CHIP_SMOKE_FIRED`` makes it
    fire once across the pool.  Built in a worker by the pool's
    ``factory`` seam."""

    def __init__(self):
        from repro_torch.measure.runner import MeasureRunner
        self.base = MeasureRunner(reps=3, warmup=1, device="cuda")

    backend_key = property(lambda self: self.base.backend_key)
    device = property(lambda self: self.base.device)

    def __call__(self, sites, tiles):
        import torch
        for site, t in zip(sites, tiles):
            mark = f"{site.key()}|{tuple(int(x) for x in t)}"
            if mark == os.environ["CHIP_SMOKE_MARK"] and _fire_once():
                idx = torch.tensor([1 << 20], device="cuda")
                torch.zeros(4, device="cuda")[idx].sum().item()
        return self.base(sites, tiles)


def _fire_once() -> bool:
    try:
        os.close(os.open(os.environ["CHIP_SMOKE_FIRED"],
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        return False
    return True


def card_assert_once():
    return CardFaultRunner()


def card_chaos():
    """A ChaosRunner (crash, hang, torn frame, noise; seed 0) over the
    port's runner on the card; one-shot sentinels in
    ``$CHIP_SMOKE_CHAOS_STATE``."""
    from repro_torch.measure.faults import ChaosRunner, FaultSchedule
    from repro_torch.measure.runner import MeasureRunner
    return ChaosRunner(MeasureRunner(reps=3, warmup=1, device="cuda"),
                       FaultSchedule(0), os.environ["CHIP_SMOKE_CHAOS_STATE"],
                       hang_s=3600.0)


def fresh_dir(name: str) -> Path:
    import shutil
    d = ROOT / "build" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def read_db(path) -> tuple:
    """``({key: seconds}, n_quarantined)`` of a timing DB file."""
    from repro_torch.measure.db import MeasureDB
    db = MeasureDB(str(path))
    return {r.key: r.value for r in db.iter_records()}, db.n_quarantined


def pair_keys(values: dict) -> set:
    return {k.rsplit("|", 1)[0] for k in values}


def check_like_inproc(label: str, values: dict, n_quar: int, ref: dict,
                      res) -> None:
    """Phase 9's check of a run whose timings left this process: the
    in-process run's DB keys, every value finite, nothing failed or
    quarantined, health ok, and the in-process runner's backend key."""
    import numpy as np
    st = res.tuning["stats"]
    ref_backend = {k.rsplit("|", 1)[1] for k in ref}
    backends = {k.rsplit("|", 1)[1] for k in values}
    if pair_keys(values) != pair_keys(ref):
        fail(f"{label}: DB keys differ from the in-process run's: "
             f"{len(pair_keys(values) ^ pair_keys(ref))} pairs")
    if not all(np.isfinite(v) for v in values.values()) or n_quar or \
            st["transport_failed_pairs_total"]:
        fail(f"{label}: failed or quarantined pairs ({n_quar} "
             f"quarantined, stats {st})")
    if res.tuning["health"] != "ok" or backends != ref_backend or \
            res.tuning["backend_key"] not in ref_backend:
        fail(f"{label}: health {res.tuning['health']}, backend "
             f"{res.tuning['backend_key']} vs the in-process {ref_backend}")


def ratio_line(label: str, values: dict, ref: dict) -> dict:
    """Per-pair ratio of a run's times to the in-process run's."""
    import numpy as np
    r = np.array([values[k] / ref[k] for k in ref if k in values])
    q = {"median": float(np.median(r)), "p10": float(np.quantile(r, 0.1)),
         "p90": float(np.quantile(r, 0.9)), "pairs": int(r.size)}
    print(f"[transports] {label}: time over in-process time, per pair: "
          f"median {q['median']:.4f}, p10 {q['p10']:.4f}, p90 "
          f"{q['p90']:.4f} over {q['pairs']} pairs", flush=True)
    return q


def start_daemon(args: list, env: dict) -> tuple:
    """``python -m repro_torch.fleet <args>``, its output (and its
    workers') to a log under build/; returns (process, log, address) once
    the log holds the flushed ready line."""
    log = ROOT / "build" / f"fleet_{args[0]}.log"
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.fleet",
                                 *args], stdout=f, stderr=subprocess.STDOUT,
                                env=env)
    deadline = time.monotonic() + POOL_SPAWN_S
    while time.monotonic() < deadline and proc.poll() is None:
        for line in log.read_text().splitlines():
            if "ready on" in line:
                print(f"[fleet:{args[0]}] {line}", flush=True)
                return proc, log, line.rsplit("ready on", 1)[1].strip()
        time.sleep(0.2)
    proc.kill()
    proc.wait(timeout=30)
    fail(f"{args[0]} printed no ready line: {log.read_text()[-2000:]}")


def stop_daemon(proc, log, name: str) -> int:
    """SIGTERM, then the exit code, which must be 0."""
    import signal
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=120)
    tail = [ln for ln in log.read_text().splitlines() if "[fleet]" in ln]
    print(f"[fleet:{name}] exit {rc}; " + " | ".join(tail), flush=True)
    if rc != 0:
        fail(f"{name} exited {rc} after SIGTERM: "
             f"{log.read_text()[-2000:]}")
    return rc


def transports_path(ref_db, xl_scan, k3_inproc: dict):
    """Phase 9: the measured oracle's transports on the card, each checked
    against phase 6's in-process run (its timing DB ``ref_db``).  (1) serve
    --transport pool --workers 2 on StableLM-3B: the in-process keys, all
    finite, health ok, the same backend, no launch in this process during
    the fit, the injected prefill's launches and logits as phase 6's;
    (2) --workers 1, and the per-pair ratios to the in-process times with
    the fits' wall and spawn seconds; (3) K3 at xLSTM's chunk-scan site,
    every chunk, in a pool of 2; (4) a worker's device-side assert, and a
    ChaosRunner over the card; (5) the fleet: serve-worker and
    serve-artifacts daemons, serve --transport socket against them, and a
    warm rerun that times nothing.  Returns the launch counts by path
    (the workers' own) and the numbers."""
    import numpy as np
    import torch
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.core.env import ActionSpace
    from repro_torch.core.costmodel_vec import action_tiles_grid
    from repro_torch.core.extractor import extract_serve_sites
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.measure import WorkerPoolTransport, make_key
    from repro_torch.models.lm import build_model
    from repro_torch.configs import get_config
    ref, ref_quar = read_db(ref_db)
    if ref_quar or not ref:
        fail(f"transports: the in-process DB {ref_db}: {len(ref)} pairs, "
             f"{ref_quar} quarantined")
    ref_backend = next(iter(ref)).rsplit("|", 1)[1]
    print(f"[transports] in-process reference: phase 6's DB, {len(ref)} "
          f"pairs ({ref_backend})", flush=True)
    by_path, out = {}, {"ref_pairs": len(ref)}
    build_dir = ROOT / "build"
    env0 = dict(os.environ)

    # (1, 2) serve through a pool of 2, then of 1
    for workers in (2, 1):
        wdir = fresh_dir(f"launches_pool{workers}")
        db = build_dir / f"pool{workers}_measure.jsonl"
        db.unlink(missing_ok=True)
        extra = ("--transport", "pool", "--workers", str(workers),
                 "--measure-db", str(db))
        os.environ[LAUNCH_ENV] = str(wdir)
        try:
            if workers == 2:
                res, counts, _ = measured_path(STABLELM, agent="brute",
                                               extra=extra, worker_dir=wdir)
            else:
                argv = ["--arch", STABLELM, "--full", "--batch", str(BATCH),
                        "--prompt-len", str(PROMPT), "--gen", str(GEN),
                        "--autotune", "brute", "--measured", *extra]
                zero_counts()
                res = serve.run(serve.parse_args(argv))
                if any(res.tuning["launches"].values()):
                    fail(f"pool1: this process launched "
                         f"{res.tuning['launches']} during the fit")
        finally:
            os.environ.pop(LAUNCH_ENV, None)
        values, n_quar = read_db(db)
        label = f"pool workers={workers}"
        check_like_inproc(label, values, n_quar, ref, res)
        wc = worker_counts(wdir)
        st = res.tuning["stats"]
        q = ratio_line(label, values, ref)
        out[label] = {
            "ratio": q, "fit_s": res.tuning["fit_s"],
            "setup_s": res.tuning["oracle_setup_s"],
            "spawn_s": st["pool_spawn_seconds_total"],
            "timed": st["transport_timed_pairs_total"],
            "restarts": st["pool_worker_restarts_total"],
            "worker_launches": {k: wc[k] for k in
                                ("matmul", "flash_attention", "chunk_scan")},
            "measured_speedup": res.modelled_speedup}
        print(f"[transports] {label}: {st['transport_timed_pairs_total']} "
              f"pairs timed in the workers, fit and tune "
              f"{res.tuning['fit_s']:.2f} s wall after the pool's start "
              f"({res.tuning['oracle_setup_s']:.2f} s wall, "
              f"{st['pool_spawn_seconds_total']:.2f} s of handshakes summed "
              f"over the workers); {st['pool_worker_restarts_total']} "
              f"restarts; worker launches {out[label]['worker_launches']}; "
              f"measured speedup {res.modelled_speedup:.3f}x", flush=True)
        by_path[f"stablelm_3b pool workers={workers}: workers"] = wc
        if workers == 2:
            by_path["stablelm_3b pool workers=2: serving process"] = counts
        del res
        torch.cuda.empty_cache()

    # (3) K3 in workers: xLSTM's chunk-scan site at every chunk
    chunks = sorted({int(t[0]) for t in
                     action_tiles_grid(ActionSpace(DEFAULT), "chunk_scan")})
    legal = [q for q in chunks if ops.tile_ok(xl_scan, (q, 1, 1))]
    wdir = fresh_dir("launches_k3")
    os.environ[LAUNCH_ENV] = str(wdir)
    try:
        with WorkerPoolTransport(workers=2,
                                 runner_kwargs={"reps": 3, "device": "cuda"},
                                 spawn_timeout=POOL_SPAWN_S,
                                 job_timeout=POOL_JOB_S) as t:
            zero_counts()
            vals = [f.result() for f in t.submit(
                [xl_scan] * len(legal), np.array([[q, 1, 1] for q in legal]))]
            parent = read_counts()
    finally:
        os.environ.pop(LAUNCH_ENV, None)
    wc = worker_counts(wdir)
    if not all(np.isfinite(v) for v in vals) or wc["chunk_scan"] < len(legal) \
            or any(parent.values()):
        fail(f"K3 in workers: times {vals}, worker launches {wc}, this "
             f"process's {parent}")
    print("[transports] K3 at the xlstm_1_3b site in a pool of 2, ms by "
          "chunk (pool / phase 5's in-process runner): " + ", ".join(
              f"Q={q}: {v * 1e3:.4f} / "
              + (f"{k3_inproc[q] * 1e3:.4f}" if q in k3_inproc else "-")
              for q, v in zip(legal, vals)) + f"; worker launches {wc}",
          flush=True)
    by_path["xlstm_1_3b K3 pool workers=2: workers"] = wc
    out["k3_pool_ms_by_chunk"] = {q: v * 1e3 for q, v in zip(legal, vals)}

    # (4) isolation: a device-side assert in a worker, then chaos
    sl_sites = extract_serve_sites(build_model(get_config(STABLELM)), BATCH,
                                   PROMPT, GEN)
    grid = {k: action_tiles_grid(ActionSpace(DEFAULT), k)
            for k in ("matmul", "attention")}
    legal = [(s, tuple(int(x) for x in t)) for s in sl_sites
             if s.kind in grid and s.m > 1
             and s.site in ("attn.q", "mlp.down", "attn.core")
             for t in grid[s.kind] if ops.tile_ok(s, t)]
    pairs = [p for i, p in enumerate(legal) if i % 16 == 0]
    mark_site, mark_tiles = pairs[0]
    os.environ.update(
        CHIP_SMOKE_MARK=f"{mark_site.key()}|{mark_tiles}",
        CHIP_SMOKE_FIRED=str(fresh_dir("card_fault") / "fired"),
        CHIP_SMOKE_CHAOS_STATE=str(fresh_dir("card_chaos")))
    t0 = time.perf_counter()
    with WorkerPoolTransport(workers=2, factory="chip_smoke:card_assert_once",
                             spawn_timeout=POOL_SPAWN_S,
                             job_timeout=POOL_JOB_S) as t:
        vals = [f.result() for f in t.submit([p[0] for p in pairs],
                                             np.array([p[1] for p in pairs]))]
        st = t.stats()
        health = t.health()
    fired = (build_dir / "card_fault" / "fired").exists()
    print(f"[transports] device-side assert at {mark_site.site} "
          f"{mark_tiles} in a worker (fired: {fired}): "
          f"{st['pool_worker_restarts_total']} worker restarts, "
          f"{st['transport_retries_total']} retries, the pair retried "
          f"{vals[0] * 1e3:.4f} ms, {len(vals)} pairs all finite: "
          f"{all(np.isfinite(v) for v in vals)}; health {health}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not fired or st["pool_worker_restarts_total"] < 1 or \
            not all(np.isfinite(v) for v in vals) or health != "ok":
        fail(f"transports: the poisoned worker was not replaced cleanly: "
             f"{st}, {vals}")
    out["assert"] = {"restarts": st["pool_worker_restarts_total"],
                     "retries": st["transport_retries_total"],
                     "retried_ms": vals[0] * 1e3,
                     "wall_s": time.perf_counter() - t0}
    # chaos: the first legal pairs that draw each fault of the schedule
    # (seed 0) and two that draw none
    from repro_torch.measure.faults import FaultSchedule
    chaos_pairs, want = [], {"crash": 1, "torn": 1, "hang": 1, "noise": 1,
                             None: 2}
    for s_, t_ in legal:
        f = FaultSchedule(0).draw(f"{s_.key()}|{t_}")
        if want.get(f):
            want[f] -= 1
            chaos_pairs.append((s_, t_))
    db = build_dir / "chaos_measure.jsonl"
    db.unlink(missing_ok=True)
    t0 = time.perf_counter()
    with WorkerPoolTransport(workers=2, factory="chip_smoke:card_chaos",
                             db=str(db), spawn_timeout=POOL_SPAWN_S,
                             job_timeout=CHAOS_JOB_S) as t:
        vals = [f.result() for f in t.submit(
            [p[0] for p in chaos_pairs], np.array([p[1] for p in chaos_pairs]))]
        st = t.stats()
        health = t.health()
        backend = t.backend_key
    keys = [json.loads(x)["k"] for x in db.read_text().splitlines()]
    faults = {}
    for s_, t_ in chaos_pairs:
        f = FaultSchedule(0).draw(f"{s_.key()}|{t_}")
        faults[f] = faults.get(f, 0) + 1
    print(f"[transports] chaos over the card ({faults}): "
          f"{st['pool_worker_restarts_total']} restarts, "
          f"{st['transport_retries_total']} retries, {len(vals)} pairs all "
          f"finite: {all(np.isfinite(v) for v in vals)}, {len(keys)} DB "
          f"lines for {len(set(keys))} keys; health {health}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    want_keys = {make_key(s_.key(), t_, backend) for s_, t_ in chaos_pairs}
    if not all(np.isfinite(v) for v in vals) or health != "ok" or \
            sorted(keys) != sorted(want_keys):
        fail(f"transports: chaos: {vals}, health {health}, keys {keys}")
    out["chaos"] = {"faults": faults,
                    "restarts": st["pool_worker_restarts_total"],
                    "retries": st["transport_retries_total"],
                    "wall_s": time.perf_counter() - t0}
    for k in ("CHIP_SMOKE_MARK", "CHIP_SMOKE_FIRED", "CHIP_SMOKE_CHAOS_STATE"):
        os.environ.pop(k, None)

    # (5) the fleet on one host
    wdir = fresh_dir("launches_fleet")
    f_db, f_store = build_dir / "fleet_measure.jsonl", \
        build_dir / "fleet_programs.jsonl"
    for f in (f_db, f_store):
        f.unlink(missing_ok=True)
    env = dict(env0, PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    worker, w_log, w_addr = start_daemon(
        ["serve-worker", "--host", "127.0.0.1", "--port", "0", "--transport",
         "pool", "--workers", "2", "--reps", "3"],
        dict(env, **{LAUNCH_ENV: str(wdir)}))
    arts = None
    try:
        arts, a_log, a_addr = start_daemon(
            ["serve-artifacts", "--host", "127.0.0.1", "--port", "0",
             "--measure-db", str(f_db), "--program-store", str(f_store)],
            env)
        fleet_extra = ("--transport", "socket", "--hosts", w_addr,
                       "--measure-db", f"fleet://{a_addr}",
                       "--program-store", f"fleet://{a_addr}")
        res, counts, _ = measured_path(STABLELM, agent="brute",
                                       extra=fleet_extra, worker_dir=wdir)
        values, n_quar = read_db(f_db)
        check_like_inproc("fleet", values, n_quar, ref, res)
        q = ratio_line("fleet (pool of 2 behind serve-worker)", values, ref)
        st = res.tuning["stats"]
        cold = {"timed": st["transport_timed_pairs_total"],
                "fit_s": res.tuning["fit_s"],
                "setup_s": res.tuning["oracle_setup_s"],
                "store": res.tuning["store"], "ratio": q}
        wc = worker_counts(wdir)
        del res
        argv = ["--arch", STABLELM, "--full", "--batch", str(BATCH),
                "--prompt-len", str(PROMPT), "--gen", str(GEN),
                "--autotune", "brute", "--measured", *fleet_extra]
        zero_counts()
        warm = serve.run(serve.parse_args(argv))
        wst, store = warm.tuning["stats"], warm.tuning["store"]
        print(f"[transports] fleet: cold run {cold['timed']} pairs timed on "
              f"the serve-worker in {cold['fit_s']:.2f} s (setup "
              f"{cold['setup_s']:.2f} s), worker launches {wc}; warm rerun "
              f"{wst['transport_timed_pairs_total']} pairs timed, "
              f"{wst['transport_hits_total']} DB hits, program store "
              f"{store['hits']} hits / {store['misses']} misses, "
              f"{warm.tuning['agent_inferences']} agent inferences, fit and "
              f"tune {warm.tuning['fit_s']:.2f} s", flush=True)
        if wst["transport_timed_pairs_total"] or store["hits"] != 1 or \
                warm.tuning["agent_inferences"] or \
                any(warm.tuning["launches"].values()):
            fail(f"fleet: the warm rerun timed {wst}, store {store}")
        out["fleet"] = {"cold": cold, "warm": {
            "timed": wst["transport_timed_pairs_total"],
            "hits": wst["transport_hits_total"], "store": store,
            "fit_s": warm.tuning["fit_s"]}}
        del warm
    finally:
        rcs = [stop_daemon(worker, w_log, "serve-worker")]
        if arts is not None:
            rcs.append(stop_daemon(arts, a_log, "serve-artifacts"))
    wc = worker_counts(wdir)
    print(f"[transports] fleet daemons exited {rcs} after SIGTERM; "
          f"serve-worker's workers launched {wc}", flush=True)
    by_path["stablelm_3b fleet: serve-worker's workers"] = wc
    by_path["stablelm_3b fleet: serving process"] = counts
    torch.cuda.empty_cache()
    return by_path, out


def sass_check() -> None:
    """K1's, K2's and K3's libraries must hold Hopper's wgmma (HGMMA) and
    TMA load (UTMALDG) instructions, and K2's and K3's builds no spilled
    register; K3's static shared memory must be what its plan counts."""
    import shutil
    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" /
        "cuobjdump")
    for name in ("matmul", "flash_attention", "chunk_scan"):
        sass = subprocess.run([tool, "-sass", str(build._lib_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        n_hgmma, n_tma = sass.count("HGMMA"), sass.count("UTMALDG")
        print(f"[build:{name}] SASS: {n_hgmma} HGMMA, {n_tma} UTMALDG "
              f"instructions", flush=True)
        if n_hgmma == 0 or n_tma == 0:
            fail(f"lib{name} holds no HGMMA or no UTMALDG instruction")
    for name in ("flash_attention", "chunk_scan"):
        spills = [ln for ln in build.build_log(name).splitlines()
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill "
                  "loads" not in ln]
        if spills:
            fail(f"ptxas spilled registers in {name}.cu: {spills}")
    from repro_torch.kernels import ops
    smem = build.static_smem("chunk_scan")
    for kernel, want in (("chunk_state_kernel", ops.CHUNK_STATE_STATIC),
                         ("chunk_out_kernel", ops.CHUNK_OUT_STATIC)):
        got = {v for k, v in smem.items() if kernel in k}
        if got != {want}:
            fail(f"{kernel}'s static shared memory {sorted(got)} B is not "
                 f"the plan's {want} B (kernels/ops.py)")


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
    sass_check()

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
    k2_d80, k2_small_err = k2_head_dim_checks(gen)
    torch.cuda.empty_cache()
    xl_sites = extract_serve_sites(build_model(get_config(XLSTM)), BATCH,
                                   PROMPT, GEN)
    xl_scan = next(s for s in xl_sites if s.kind == "chunk_scan")
    k3, k3_mamba = k3_checks(xl_scan, gen)

    # ---- phase 4: the modelled main path ----
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
    n_layers = model.cfg.n_layers
    params, prompts = res.params, res.prompts
    del res, model
    torch.cuda.empty_cache()

    # ---- phase 5: the measured main paths ----
    by_path = {"qwen3_8b modelled": counts}
    q_res, by_path["qwen3_8b measured"], _ = measured_path(ARCH, params,
                                                           prompts)
    del q_res, params, prompts
    torch.cuda.empty_cache()
    x_res, by_path["xlstm_1_3b measured"], x_eager = measured_path(XLSTM)
    xlstm_model_checks(x_res, x_eager)
    del x_eager
    # K1 at each xLSTM shape it runs (the mLSTM q/k/v einsums never reach
    # it), under the baseline and the tuned tile
    seen = set()
    for s in x_res.sites:
        if s.kind != "matmul" or s.site in ("mlstm.q", "mlstm.k", "mlstm.v"):
            continue
        shape = (s.m, s.n, s.k, s.site == "lm_head")
        for tiles, how in ((baseline_tiles(s), "baseline"),
                           (x_res.prog.tiles[s.key()], "tuned")):
            if (shape, tuple(tiles)) not in seen:
                seen.add((shape, tuple(tiles)))
                k1_check(shape, tiles, f"xlstm {how}:{s.site}", gen)
    q_tuned = x_res.prog.tiles[xl_scan.key()][0]
    q_base = baseline_tiles(xl_scan)[0]
    if q_tuned not in k3 or q_base not in k3:
        fail(f"K3 at the tuned chunk {q_tuned} or the baseline "
             f"{q_base} was not checked")
    pick = x_res.tuning["picks"][xl_scan.key()]
    by_q = {}
    for tiles, sec in pick["timed"].items():
        by_q[tiles[0]] = min(sec, by_q.get(tiles[0], sec))
    print(f"[measured:{XLSTM}] K3 site: tuned chunk {q_tuned} (timed "
          f"{pick['pick_s'] * 1e3:.4f} ms by the runner), fastest timed "
          f"{pick['best']} ({(pick['best_s'] or 0) * 1e3:.4f} ms), baseline "
          f"{q_base}; the runner's K3 ms by chunk: "
          f"{ {q: round(v * 1e3, 4) for q, v in sorted(by_q.items())} }",
          flush=True)
    del x_res
    torch.cuda.empty_cache()

    # ---- phase 6: the main-path loop on StableLM-3B ----
    sl = stablelm_path(gen)
    by_path["stablelm_3b ppo (corpus)"] = sl["ppo"]
    by_path["stablelm_3b brute measured"] = sl["brute"]
    if sl["t_att"] not in k2_d80:
        fail(f"StableLM's tuned attention tile {sl['t_att']} was not "
             f"checked at D = 80")

    # ---- phase 8: the facade (before the kernels line: its launches
    # count into the line's) ----
    by_path["stablelm_3b facade"], facade = facade_path()
    print("[facade] summary " + json.dumps(facade, default=str), flush=True)

    # ---- phase 9: the transports on the card (before the kernels line:
    # the launches its workers reported count into the line's) ----
    t0 = time.perf_counter()
    t_paths, transports = transports_path(sl["db"], xl_scan, by_q)
    by_path.update(t_paths)
    transports["wall_s"] = time.perf_counter() - t0
    print("[transports] summary " + json.dumps(transports, default=str),
          flush=True)
    total = {k: sum(c[k] for c in by_path.values())
             for k in ("matmul", "flash_attention", "chunk_scan")}

    def path_counts(k):
        return {p: c[k] for p, c in by_path.items()}

    # ---- phase 7: kernels line ----
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
    k1_dev = None       # the profiler's device ms, where it saw every site
    if all(k1_tuned[s]["device_ms"] for s in per_site_launches):
        k1_dev = sum(k1_tuned[s]["device_ms"] * w
                     for s, w in per_site_launches.items())
    def by_variant(name):
        return {v: sum(c[f"{name}_by_variant"].get(v, 0)
                       for c in by_path.values())
                for v in by_path["qwen3_8b modelled"][f"{name}_by_variant"]}
    k2_tot, k2_b, k2_by = agg(k2, {t_att: n_layers})
    k2_dev, k2_lib_dev = ((k2[t_att][f] * n_layers if k2[t_att][f] else None)
                          for f in ("device_ms", "lib_device_ms"))
    r3 = k3[q_tuned]
    sl_k1, sl_k1_b, sl_k1_by = agg(sl["k1_tuned"], sl["k1_launches"])
    sl_k2, sl_k2_b, sl_k2_by = agg(k2_d80, {sl["t_att"]: sl["n_layers"]})
    r80 = k2_d80[sl["t_att"]]
    line = {"kernels": [
        {"name": "tiled_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:32",
         "launches": total["matmul"],
         "launches_by_path": path_counts("matmul"),
         "launches_by_variant": by_variant("matmul"),
         "launches_by_variant_by_path": path_counts("matmul_by_variant"),
         "max_abs_err": max(r["err"] for r in k1_tuned.values()),
         "max_rel_err": max(r["rel"] for r in k1_tuned.values()),
         "tolerance": f"rel {K1_TOL} vs f32 matmul",
         "ms": k1_tot["ms"], "plain_ms": k1_tot["plain_ms"],
         "bound_ms": k1_b * 1e3, "bound_by": k1_by,
         "library_ms": k1_tot["lib_ms"],
         "device_ms": k1_dev,
         "work": "one prefill + one decode step of the qwen3_8b modelled "
                 "path, tuned tiles; M = 4 shapes timed over copies of w "
                 f"exceeding {COLD_BYTES / 1e6:.0f} MB",
         "stablelm_3b": {
             "ms": sl_k1["ms"], "plain_ms": sl_k1["plain_ms"],
             "bound_ms": sl_k1_b * 1e3, "bound_by": sl_k1_by,
             "library_ms": sl_k1["lib_ms"],
             "max_abs_err": max(r["err"] for r in sl["k1_tuned"].values()),
             "work": "one prefill + one decode step of stablelm_3b at the "
                     "PPO (corpus) tiles"}},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:64",
         "launches": total["flash_attention"],
         "launches_by_path": path_counts("flash_attention"),
         "launches_by_variant": by_variant("flash_attention"),
         "launches_by_variant_by_path": path_counts(
             "flash_attention_by_variant"),
         "max_abs_err": max([r["err"] for r in k2.values()]
                            + [r["err"] for r in k2_d80.values()]
                            + [k2_small_err]),
         "tolerance": f"abs {K2_TOL} vs plain version",
         "ms": k2_tot["ms"], "plain_ms": k2_tot["plain_ms"],
         "bound_ms": k2_b * 1e3, "bound_by": k2_by,
         "library_ms": k2_tot["lib_ms"],
         "device_ms": k2_dev, "library_device_ms": k2_lib_dev,
         "work": f"one prefill of the qwen3_8b modelled path ({n_layers} "
                 f"launches at tiles {t_att}, v in the served layout)",
         "stablelm_3b": {
             "ms": sl_k2["ms"], "plain_ms": sl_k2["plain_ms"],
             "bound_ms": sl_k2_b * 1e3, "bound_by": sl_k2_by,
             "library_ms": sl_k2["lib_ms"],
             "device_ms": (r80["device_ms"] * sl["n_layers"]
                           if r80["device_ms"] else None),
             "max_abs_err": max([r["err"] for r in k2_d80.values()]
                                + [k2_small_err]),
             "work": f"one prefill of stablelm_3b ({sl['n_layers']} launches "
                     f"at head dim 80, tiles {sl['t_att']})"}},
        {"name": "ssd_chunk_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/chunk_scan.cu",
         "replaces": "src/repro/kernels/chunk_scan.py:56",
         "launches": total["chunk_scan"],
         "launches_by_path": path_counts("chunk_scan"),
         "max_abs_err": max([r["err"] for r in k3.values()]
                            + [k3_mamba["err"]]),
         "max_rel_err": max([r["rel"] for r in k3.values()]
                            + [k3_mamba["rel"]]),
         "tolerance": f"{K3_TOL} of the largest |output| vs plain version",
         "ms": r3["ms"], "plain_ms": r3["plain_ms"],
         "bound_ms": r3["bound_s"] * 1e3, "bound_by": r3["bound_by"],
         "library_ms": None,
         "device_ms": r3["device_ms"],
         "variant": r3["variant"],
         "ms_by_chunk": {q: r["ms"] for q, r in k3.items()},
         "device_ms_by_chunk": {q: r["device_ms"] for q, r in k3.items()},
         "device_ms_by_pass_by_chunk": {q: r["passes"]
                                        for q, r in k3.items()},
         "variant_by_chunk": {q: r["variant"] for q, r in k3.items()},
         "runner_ms_by_chunk": {q: v * 1e3 for q, v in sorted(by_q.items())},
         "mamba2_head": {
             "shape": MAMBA, "variant": k3_mamba["variant"],
             "ms": k3_mamba["ms"], "device_ms": k3_mamba["device_ms"],
             "device_ms_by_pass": k3_mamba["passes"],
             "plain_ms": k3_mamba["plain_ms"],
             "bound_ms": k3_mamba["bound_s"] * 1e3,
             "bound_by": k3_mamba["bound_by"],
             "max_abs_err": k3_mamba["err"]},
         "work": f"one call at the xlstm_1_3b mlstm.chunk_scan site as the "
                 f"runner builds it (G=1, S={xl_scan.batch * xl_scan.m}, "
                 f"P=N={xl_scan.n}) at the tuned chunk Q={q_tuned}; no single "
                 f"PyTorch call computes the scan"}]}
    print(json.dumps(line))
    print(f"[device] {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
