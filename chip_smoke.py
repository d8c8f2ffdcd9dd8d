#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

  python3 chip_smoke.py                  # all phases (one card)

Phases, each printed before the last line:
  1. device: nvidia-smi's name and power limit; TF32 switched off;
  2. build: the four CUDA sources (K1's bf16 variants and its f32
     variant apart) compiled at once from csrc/ (seconds, ptxas); K1's,
     K2's and K3's libraries must hold HGMMA and UTMALDG instructions
     (cuobjdump -sass), K1's also the TMA load multicast over a
     thread-block cluster (a UTMALDG SASS marks MULTICAST, or in the PTX
     nvcc makes of csrc/matmul.cu), K1's f32 library FFMA and no HMMA or
     HGMMA (no TF32), the f32, K2 and K3 builds no spill, and K3's static
     shared memory (ptxas) must be its plan's;
  3. kernels vs their plain PyTorch versions on the card, in bf16:
     K1 (tiled matmul) at every distinct qwen3_8b serve-site shape under the
     baseline tiles and, at the four prefill shapes, under a 16-row tile
     (16, 256, 1024), and a tile-invariance sweep over every legal tile of
     one site, each tile timed beside its layout (CTA tiles below 64 rows
     swap the operands), its cluster, its CTAs an SM and the rate at which
     its operands reach the SMs, summed by the rows a CTA loads; every K1
     line prints the layout that ran, the cluster, the CTAs an SM and the
     bytes TMA moves into the SMs, and fails where a tile below 64 rows
     did not run swapped; K2 (flash attention) at (B=4, H=32, Hkv=8,
     S=512, D=128), causal, v in the served layout (the transposed view of its
     projection), over every legal (bq, bkv), each line with the variant,
     the widths, stage keys and ring its launch ran at (read back from the
     kernel's entry point; it fails where they are not the plan's),
     device ms, share of the bound and ratio to SDPA (stream and device
     ms), and once at the
     runner's shape (B=1, H=Hkv=128, contiguous); K2 at the StableLM-3B
     prefill (B=4, H=Hkv=32, S=512, D=80, causal, v the transposed view)
     over every legal tile, its bound at the true D beside SDPA's time,
     once with q, k and v all transposed views and once through the
     unaligned variant, and at D = 64, 96, 136 and 192 at a small shape
     through both variants; K3 (SSD chunk scan) at the
     xlstm_1_3b serve site as the measurement runner builds it (G=1,
     S=8192, P=N=1024) for every chunk of the action space (the ones the
     predicate refuses must raise TileError), and at a Mamba-2 head of
     jamba_v0_1_52b's ssm.chunk_scan site (S=262144, P=64, N=16, Q=256),
     each K3 line with its variant (ops.chunk_launch_plan), the device ms
     of each pass and their sum, and the share of the bound that sum
     reaches; then K1 under the baseline tile at every matmul shape of the
     starcoder2_7b, chatglm3_6b, phi3_vision_4_2b, seamless_m4t_medium,
     llama4_maverick_400b and jamba_v0_1_52b serves (seamless's lm_head
     4x256206x1024 and llama4's 4x202048x5120 through head.T, jamba's
     ssm.in_proj 2048x16544x4096 among them), K1's f32 variant at the
     four MoE router shapes (2048x128x5120, 4x128x5120, 2048x16x4096,
     4x16x4096) against the f32 product at 1e-5 of its largest |output|
     (TF32 off), timed beside torch.matmul in f32 and its bound at the
     FP32 rate (66.9 TFLOP/s), each [k1f32:...] line with its plan (the
     runs R of K and k_run, the grid, the height x width layout and the
     CTA tile), and K2 at each of their prefill attentions (GQA groups of
     9, 16, 5 and 4, D = 96 at S = 768, D = 64 causal and not,
     deepseek_v2_236b's mla.core at D = 192 with a value dim Dv = 128),
     each in the served layout, after holding how often a pass
     calls each site against per_pass_launches; then K1's f32 variant at
     PPO's router tile (32, 128, 1024) at 2048x128x5120 and at the
     corpus's f32 sites b.f32 (2048x2048x2048) and m.fft (4096x128x128)
     under the baseline tiles, the same way, and the same bits at four
     tiles and at M = 4 against M = 2048 for the three routers' (N, K)
     (DeepSeek-V2's N = 160 among them); K2 at mla.core beyond the
     baseline tile: at a tile PPO can pick (64, 128) in the served layout
     and in the measurement runner's layout (B=1, H=512, D=Dv=192,
     contiguous), each with its plan (64-key stages, a ring of 2), a
     small-width DeepSeek-V2 at MLA's full head dims injected against
     eager (logits within LOGIT_TOL, 3 absorbed decode steps), and the
     plan at the Qwen3-8B prefill (D = 128) held to the one it had
     before K2 took D > 128.  Each
     shape prints the kernel's ms (the median over repeats
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
     K1 check prints how many outputs differ from torch.matmul at all).
     Both fits keep their timings in build/phase5_measure.jsonl, phase
     10's training corpus; Qwen3-8B's is held against phase 4's eager run
     of the same weights and prompts;
  6. the paper's main-path loop (tests/test_system.py:22-55) on
     stablelm_3b at full width (32 layers, head dim 80, bf16, batch 4,
     prompt 512, 16 tokens): PPO fit on dataset.generate(400, seed=0,
     base=sites) under CostModelEnv(legality="h100") with the reference
     test's PPO settings, its tiles tuned (the TPU-v5e-modelled speedup
     printed), serve --tiles --inject with them against eager mode, K1 at
     every StableLM shape under the baseline and the tuned tile, then
     serve --autotune brute --measured --inject (its pick must be the
     fastest tile it timed at every site) and PPO's program priced from
     the same timings: the two measured speedups side by side.  The
     --tiles run's eager pass (the same weights, from seed 0, and
     prompts) is what every injected StableLM-3B serve of phases 6, 9
     and 10 is held against;
  7. one JSON line describing each kernel of the paths (K1 and K2 with
     their launches by variant, K1's by layout too, and their StableLM-3B
     numbers, K1 also at the 16-row tile's prefill lines and
     the train lm_head, K1 and K2 at each phase-12 arch's baseline tiles,
     K1's f32 variant at each MoE arch's router shapes and at phase 3's
     other f32 shapes,
     K3 with its device ms by pass and chunk and the Mamba-2 head),
     printed last so that the launches of phases 8-15 count in it;
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
  9. the transports on the card (run after phase 8, before phase 7),
     every timing under the card's lock (repro_torch.measure.lock: one
     timed call per card at a time across processes):
     phase 6's in-process brute-force DB is the reference.  serve
     --transport pool --workers 2 (the same StableLM-3B run, a new DB)
     must time the same keys, all finite, none failed or quarantined,
     health ok, under the in-process backend key, with no launch in this
     process during the fit (the workers' counters, written under
     REPRO_TORCH_LAUNCH_DIR, show K1 and K2), and its injected prefill's
     launches and logits as phase 6's; then --workers 1; each prints the
     per-pair ratio of pool to in-process time (median, p10, p90), the
     fit's wall, the spawn seconds, the workers' lock wait and the brute
     pick's measured speedup beside phase 6's; then the pool of 2 against
     the pool of 1 (median ratio) and in process (speedup).  K3 at xLSTM's
     chunk-scan site at every legal chunk in a pool of 2, beside phase 5's
     in-process times.
     A factory runner defined here triggers a device-side assert in a
     worker at one marked pair: the pool must replace the worker and time
     the pair finite on the retry; a ChaosRunner (crash, hang, torn frame,
     noise) over the card's runner times StableLM pairs that draw each
     fault once, and two that draw none: all finite, each key written
     once, health ok.  One worker against this process on 14 StableLM
     pairs: the runner's host-clock ms beside the device ms of one call
     from torch.profiler, per pair and as ratios.  The fleet:
     serve-worker (a pool of
     2) and serve-artifacts daemons on ports the OS picks, serve
     --transport socket with fleet:// DB and store meeting the pool run's
     checks, a warm rerun that times 0 pairs and takes its program from
     the store, then SIGTERM and exit code 0 for both daemons;
 10. the learned cost model (after phase 9, before phase 7): the
     surrogate trained on the card from phase 5's DB (corpus pairs,
     backend, ensemble, wall); per StableLM-3B site the Spearman rho of
     its prices and of the analytic model's against phase 6's measured
     grid, with their means; serve --autotune brute --measured
     --prune-topk 4 --surrogate DIR --inject at full width (fewer pairs
     timed than phase 6, at most 5 a site, the injected prefill's
     launches and logits as phase 6's), its best tiles against full brute
     force's, and both picks re-timed interleaved in this process; PPO
     fitted against oracle="surrogate" with phase 6's settings, its
     program priced by phase 6's timings beside PPO on the cost model;
 11. the train path (after phase 10, before phase 7) on the full-width
     StableLM-3B: its train sites at batch 4, seq 512 tuned by brute force
     against phase 6's timing DB; the program injected into train_loss
     under no_grad (K1's and K2's launches by variant, the loss within
     5e-3 of eager mode's, K1 at the train lm_head 2048x50304x2560 against
     its bound and torch.matmul); kernel mode under autograd must raise;
     python -m repro_torch.launch.train --full --batch 4 --seq 512 for 5
     steps (ms a step from CUDA events, forward + backward and optimizer
     apart, tokens/s, losses, finite grad norms, peak memory, one more
     step's device busy and idle share under torch.profiler); at full
     width and depth 2, 6 steps with a checkpoint every 2, the steps above
     4 dropped and a resume whose losses match within 1e-4 (one save's
     bytes and seconds; the directory deleted), and accum 2 against
     accum 1;
 12. seven more archs served (after phase 11, before phase 7): the
     seed-0 init of every ported arch at full width on the card, timed, at
     the depth it is served at (llama4_maverick_400b at 2 of its 48
     layers, jamba_v0_1_52b at 8 of 32: one period each, deepseek_v2_236b
     at 4 of 60, four periods of one MoE block; as much as one card holds
     beside the serve; the others at full depth); then
     starcoder2_7b (GELU MLP, GQA 36/4), chatglm3_6b (2-D RoPE, GQA
     32/2), phi3_vision_4_2b (a 256-row frontend.proj prefix, head dim
     96), seamless_m4t_medium (encoder-decoder, cross-attention, head dim
     64, vocab 256206), llama4_maverick_400b (a dense and a 128-expert
     top-1 MoE layer with a shared expert, GQA 40/8) and jamba_v0_1_52b
     (7 Mamba/SSD mixers and one attention, 4 MoE layers of 16 experts
     top-2) and deepseek_v2_236b (MLA: K2 at D = 192, Dv = 128 in the
     prefill, the absorbed decode in plain PyTorch; 160 experts top-6 and
     two shared), one after another at full width, batch 4, prompt 512, 16
     tokens: serve eager, then --autotune ppo --inject against the cost
     model (legality h100) with the counters zeroed just before and read
     just after, each pass's launches as per_pass_launches says, K1's f32
     variant once a MoE layer a pass, no unaligned variant, the injected
     prefill logits within LOGIT_TOL of eager's (for the MoE archs on the
     batch rows whose tokens kept every routing choice, with the share of
     (token, slot) choices that agree printed by MoE layer), both runs'
     greedy tokens, and K1 (f32 at 1e-5) and K2 at each tuned tile that
     phase 3 did not check; phase 3 already held K1 at each of their
     matmul shapes and K2 at each of their prefill attentions (non-causal
     at D = 64 among them) under the baseline tiles;
 13. the tuning service and the latency-SLO serving layer (after phase
     12, before the kernels line): serve --autotune brute --serving
     --inject on the full-width qwen3_8b (36 layers, batch 4, prompt 512,
     16 tokens) with the counters zeroed just before and read just after:
     one fused dispatch and one CUDA graph capture, the program equal to
     the host's brute force over CostModelEnv(legality="h100"), every
     tile launchable, each pass's launches as per_pass_launches says with
     no unaligned variant, the injected prefill logits within LOGIT_TOL of
     phase 4's eager run (the same seeded weights and prompts), prefill
     ms and decode tok/s, and K1 and K2 at each tuned tile no earlier
     phase checked; the fused tuner on the card against the host's brute
     force over the ten-arch corpus (dataset.arch_sites()) under h100 and
     tpu_v5e (and its CPU route under tpu_v5e), one replay's device ms
     beside the host argmin's ms; the fused surrogate route (phase 10's
     model) against SurrogateOracle's brute labels; 8 brute/model and 2
     PPO sessions (discrete and cont2, 300 steps on Qwen3-8B's sites) on
     one TuningService(serving=True), each submitting 3 requests over its
     slice of the corpus from its own thread, every program its solo tune
     and FIFO within a session, with the serving p50/p99, batches and
     health; cont1, cont2 and two_agents fitted 300 steps and tuned
     through the server, every tile launchable; MetricsServer scraped on
     127.0.0.1; a measured brute session through AsyncOracle over phase
     6's timing DB, 0 pairs timed and phase 6's program;
 14. several ranks and the dry-run (after phase 13, before the kernels
     line): phase 11's depth-2 StableLM-3B (batch 4, seq 512, 5 steps)
     through the train driver twice, in subprocesses: on its mesh path
     over a one-rank NCCL group (torchrun's environment set by hand,
     --model-parallel 1: DTensor state, the step under the sharding
     hints) and on the plain one-card path; every loss equal within 1e-5
     relative, finite grad norms, ms a step of each from CUDA events with
     the DTensor path's host overhead as their difference, and each
     peak (torch.cuda.max_memory_allocated); the dry-run's run_cell at
     that config on a one-rank fake mesh, its argument bytes equal to the
     state's bytes on the card plus the int32 batch, its peak beside the
     card's; run_cell for qwen3_8b train_4k (cut to 12 of its 36
     layers) and deepseek_v2_236b decode_32k on the fake 16x16 mesh
     (traced on the CPU in two
     subprocesses while the card runs phases 14 and 15, read after phase
     15), each with its per-device peak against an H100's 80 GB, flops,
     collective MiB by kind and trace seconds (counts on fake tensors);
     compressed_psum on a one-rank NCCL mesh equal to its input's int8
     round trip;
 15. the last four examples and the seed's reference paths (after
     phase 14, before the kernels line), each example with its wall
     seconds and its invariant: examples/torch_measured_autotune.py
     twice on one timing DB, in process and then through a pool of 1
     (the first run launches K1, K2 and K3 and times pairs, the second
     times none); torch_warmstart_autotune.py --phase fit, then --phase
     warm in a fresh process (a store lookup, 0 agent inferences, the
     fit's program bitwise); torch_fleet_autotune.py twice against a
     serve-worker and a serve-artifacts daemon on ports the OS picks
     (run 1 times pairs on the worker and a second subscriber receives
     the program by push; run 2 times none and is a store lookup; both
     daemons exit 0 on SIGTERM); torch_fault_tolerant_serving.py --full
     in this process, with the counters zeroed just before and read
     just after: jamba_v0_1_52b at its published widths, 8 of 32 layers,
     batch 4, prompt 16, 12 tokens, its brute-force plan injected (K1 in
     bf16 and in f32 at the routers, and K2 must launch), prefill ms,
     mean decode step ms, straggler events, the injected prefill logits
     against eager's within LOGIT_TOL on the batch rows whose tokens kept
     every routing choice, the re-plans; then one PPO fit of the seed's
     path (fused=False against CostModelEnv(vectorized=False)) and one of
     today's (fused=True against the vectorized env), 8000 steps each
     under legality h100, each fit's seconds printed (a record, not a
     benchmark) and the seed path's minibatches an update held to
     ppo_epochs * (n // mb);
 16. each phase's wall seconds, then the last line:
     {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero.  Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no
result.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16 = 989e12          # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_F32 = 66.9e12          # H100 SXM FP32 FLOP/s outside the tensor
                            # cores (data sheet)
HBM_BPS = 3.35e12           # H100 SXM HBM3 bytes/s (data sheet)
K1_TOL = 3e-2               # rel. error vs f32 matmul_ref: bf16 output
                            # rounding (2^-8) with f32 accumulation, as in
                            # tests/test_kernels.py
K1_ROWS16_TILE = (16, 256, 1024)  # a 16-row K1 tile, swapped, held at
                            # the qwen3_8b prefill shapes in phase 3
K1_F32_TOL = 1e-5           # K1's f32 variant vs the f32 product (TF32
                            # off), over its largest |output|: two f32
                            # summation orders; TF32 would show as 1e-3
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
PHASE12_ARCHS = ("starcoder2_7b", "chatglm3_6b", "phi3_vision_4_2b",
                 "seamless_m4t_medium", "llama4_maverick_400b",
                 "jamba_v0_1_52b", "deepseek_v2_236b")  # served in phase 12
# the depth each arch is served at on one card, at its published widths:
# whole periods, as many as the 80 GB hold beside the serve (PERF.md §4)
SERVE_LAYERS = {"llama4_maverick_400b": 2,     # one period, 37.4 GB bf16
                "jamba_v0_1_52b": 8,           # one period, 26.5 GB bf16
                "deepseek_v2_236b": 4}         # 4 periods of 1, 34 GB bf16
# K2 at MLA (deepseek_v2_236b's mla.core, D = 128 + 64, Dv = 128) beyond
# phase 12's baseline tile: a tile PPO can pick, in the served layout, and
# the measurement runner's layout (B = 1, H = B * heads uncapped on the
# card, D = Dv = 192, contiguous)
MLA_PPO_TILE = (64, 128)
MLA_RUNNER = dict(B=1, H=4 * 128, S=512, D=192, Dv=192)
# K2 at the head dims other than 128 that the served archs and the runner
# give it, each at its own padded widths: label, (B, H, Hkv, S, D, Dv),
# causal, the layout ("contig": q, k, v contiguous; "served": q and k
# contiguous after RoPE, v the transposed view of its projection; "views":
# all three the views, no RoPE) and the tiles (Phi-3's baseline, which the
# baseline's 512 keys do not divide, and PPO's)
K2_WIDTH_SHAPES = (
    ("mla runner", (1, 4 * 128, 4 * 128, 512, 192, 192), True, "contig",
     (128, 512)),
    ("mla.core", (4, 128, 128, 512, 192, 128), True, "served", (128, 512)),
    ("phi3 baseline", (4, 32, 32, 768, 96, 96), True, "served", (128, 256)),
    ("phi3 ppo", (4, 32, 32, 768, 96, 96), True, "served", (64, 128)),
    ("seamless decoder", (4, 16, 16, 512, 64, 64), True, "views",
     (128, 512)),
    ("seamless encoder", (4, 16, 16, 512, 64, 64), False, "views",
     (128, 512)),
    ("stablelm", (4, 32, 32, 512, 80, 80), True, "served", (128, 512)),
)
STEPS_12 = STEPS                        # PPO steps of a phase-12 fit
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


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16):
    t_ops, t_mem = flops / peak, nbytes / HBM_BPS
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def served_cfg(arch):
    """``arch`` at its published widths and the depth phase 12 serves it
    at (``SERVE_LAYERS``; full depth where it is not listed)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if arch in SERVE_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS[arch])
    return cfg


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


def k1_agree(shape, tiles, gen):
    """K1 launched once at ``shape`` under ``tiles`` on random bf16
    operands, held against the f32 product (fails at K1_TOL of its
    largest) and its plain version: ``(x, w, weight, record)``,
    ``weight()`` drawing another w of the same layout."""
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
    before_layout = dict(kmm.launches_by_layout)
    y = ops.matmul(x, w, tiles=tiles)
    torch.cuda.synchronize()
    ran = [v for v in kmm.VARIANTS
           if kmm.launches_by_variant[v] != before[v]]
    if len(ran) != 1 or sum(kmm.launches_by_variant.values()) != \
            sum(before.values()) + 1:
        fail(f"K1 did not launch once at {shape}: {ran}")
    layout = [v for v in kmm.LAYOUTS
              if kmm.launches_by_layout[v] != before_layout[v]]
    plan = ops.matmul_launch_plan(M, N, K, tiles, kmm._sm_count(x.device),
                                  w_kmajor=transposed)
    if layout != [plan.layout]:
        fail(f"K1 at {shape} tiles {tiles} ran the {layout} layout, its "
             f"plan says {plan.layout}")
    if plan.rows < ops.MM_SWAP_ROWS and ran[0] in ("tma_wgmma", "split_k") \
            and layout != ["swapped"]:
        fail(f"K1 at {shape} tiles {tiles}: {plan.rows} CTA rows did not "
             f"run the swapped layout")
    yr = ref.matmul_ref(x, w).float()
    y_f32 = x.float() @ w.float()
    err = float((y.float() - y_f32).abs().max())
    rel = err / (float(y_f32.abs().max()) + 1e-9)
    if not torch.isfinite(y).all() or rel >= K1_TOL:
        fail(f"K1 {shape} tiles {tiles}: rel err {rel:.3e} >= {K1_TOL}")
    # bf16 outputs that differ from cuBLAS's at all (0 only where both
    # happen to sum K in an order that rounds alike)
    rec = {"err": err, "rel": rel, "variant": ran[0],
           "plain_err": float((y.float() - yr).abs().max()),
           "n_ne_lib": int((y != torch.matmul(x, w)).sum()),
           "layout": plan.layout, "cluster": plan.cluster,
           "occupancy": plan.occupancy,
           "operand_bytes": k1_operand_bytes(plan, K)}
    return x, w, weight, rec


def k1_check(shape, tiles, label, gen):
    """K1 vs plain and torch.matmul at one shape; returns a record.  At
    M = 4 (bound by reading w) the times are over copies of w that exceed
    COLD_BYTES together, the warm-L2 time (one w) printed beside them."""
    import torch
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    M, N, K, transposed = shape
    x, w, weight, rec = k1_agree(shape, tiles, gen)
    err, rel, variant = rec["err"], rec["rel"], rec["variant"]
    plain_err, n_ne_lib = rec["plain_err"], rec["n_ne_lib"]
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
    into = rec["operand_bytes"] / ((dev_ms or ms) * 1e-3) / 1e12
    print(f"[k1:{label}] M={M} N={N} K={K}{' wT' if transposed else ''} "
          f"tiles={tuple(tiles)} variant={variant} layout={rec['layout']} "
          f"C={rec['cluster']} CTAs/SM={rec['occupancy']} bytes_into_SMs="
          f"{rec['operand_bytes'] / 1e6:.1f} MB ({into:.2f} TB/s) "
          f"rel_err={rel:.2e} "
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
            "bytes": 2.0 * (M * K + K * N + M * N),
            "layout": rec["layout"]}


def k1_f32_agree(shape, tiles, gen):
    """K1's f32 variant launched once at ``shape`` under ``tiles`` on
    random f32 operands, held against the f32 product with TF32 off
    (fails at K1_F32_TOL of its largest |output|): ``(x, w, record)``."""
    import torch
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    M, N, K, transposed = shape
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the f32 product is not f32")
    x = torch.randn((M, K), generator=gen, device="cuda")
    w = (torch.randn((N, K), generator=gen, device="cuda").T if transposed
         else torch.randn((K, N), generator=gen, device="cuda"))
    before = dict(kmm.launches_by_variant)
    y = ops.matmul(x, w, tiles=tiles)
    torch.cuda.synchronize()
    ran = {v: kmm.launches_by_variant[v] - before[v] for v in kmm.VARIANTS}
    if ran != {v: int(v == "f32") for v in kmm.VARIANTS}:
        fail(f"K1 in f32 at {shape} tiles {tiles} ran {ran}")
    want = x @ w
    err = float((y - want).abs().max())
    rel = err / (float(want.abs().max()) + 1e-30)
    if y.dtype != torch.float32 or not torch.isfinite(y).all() or \
            rel >= K1_F32_TOL:
        fail(f"K1 f32 {shape} tiles {tiles}: rel err {rel:.3e} >= "
             f"{K1_F32_TOL}")
    plain = kmm.matmul_plain(x, w)
    return x, w, {"err": err, "rel": rel, "variant": "f32",
                  "plain_err": float((y - plain).abs().max()),
                  "n_ne_lib": int((y != want).sum())}


def k1_f32_plan(shape, tiles) -> dict:
    """K1's f32 plan at ``shape`` under ``tiles``: the runs of K, the
    grid, the rows and columns a CTA computes and the CTA tile of the
    launch rule."""
    import torch
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    M, N, K, _ = shape
    p = ops.matmul_launch_plan(M, N, K, tiles,
                               kmm._sm_count(torch.device("cuda")),
                               dtype="float32")
    return {"R": p.splits, "k_run": p.k_run,
            "grid": (p.grid_n, p.grid_m, p.splits),
            "layout": f"{getattr(p, 'height', p.rows)}x"
                      f"{getattr(p, 'width', p.cols)}",
            "cta_tile": f"{p.rows}x{p.cols}"}


def k1_f32_check(shape, tiles, label, gen):
    """K1's f32 variant (the MoE router) against the f32 product, timed
    beside its plain version and torch.matmul in f32 (TF32 off), its
    bound at the FP32 rate outside the tensor cores (PEAK_F32)."""
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    import torch
    M, N, K, transposed = shape
    x, w, rec = k1_f32_agree(shape, tiles, gen)
    plan = k1_f32_plan(shape, tiles)
    ms = time_ms_over(lambda a, b: ops.matmul(a, b, tiles=tiles), [(x, w)])
    lib_ms = time_ms_over(torch.matmul, [(x, w)])
    plain_ms = time_ms_over(kmm.matmul_plain, [(x, w)], reps=5, calls=1)
    dev_ms = sum(device_ms_by_kernel(
        lambda: ops.matmul(x, w, tiles=tiles)).values()) or None
    flops, nbytes = 2.0 * M * N * K, 4.0 * (M * K + K * N + M * N)
    b, by = bound_s(flops, nbytes, PEAK_F32)
    share_ms = dev_ms if dev_ms is not None else ms
    print(f"[k1f32:{label}] M={M} N={N} K={K}{' wT' if transposed else ''} "
          f"tiles={tuple(tiles)} variant=f32 R={plan['R']} "
          f"k_run={plan['k_run']} grid={plan['grid']} "
          f"layout={plan['layout']} (CTA tile {plan['cta_tile']}) "
          f"rel_err={rec['rel']:.2e} "
          f"(tol {K1_F32_TOL}) |k-plain|={rec['plain_err']:.3e} "
          f"!=torch.matmul: {rec['n_ne_lib']} of {M * N} ms={ms:.4f} "
          f"device_ms="
          f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'} "
          f"plain_ms={plain_ms:.4f} torch.matmul_f32_ms={lib_ms:.4f} "
          f"bound_ms={b * 1e3:.4f} ({by}, FP32 {PEAK_F32 / 1e12:.1f} "
          f"TFLOP/s) share_of_bound={b * 1e3 / share_ms:.3f} "
          f"vs_torch.matmul={ms / lib_ms:.2f}x", flush=True)
    return dict(rec, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                device_ms=dev_ms, bound_s=b, flops=flops, bytes=nbytes,
                peak=PEAK_F32, plan=plan)


def f32_summary(r) -> dict:
    """A record of K1's f32 variant as the kernels line shows it."""
    return {"shape": r.get("shape"), "tiles": r.get("tiles"),
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "library_ms": r["lib_ms"],
            "bound_ms": r["bound_s"] * 1e3,
            "bound_by": bound_s(r["flops"], r["bytes"], PEAK_F32)[1],
            "max_abs_err": r["err"], "plan": r["plan"]}


F32_PHASE3 = (      # K1's f32 variant beyond the routers' baseline tiles
    ("ppo router tile", (2048, 128, 5120, False), (32, 128, 1024)),
    ("corpus b.f32", (2048, 2048, 2048, False), None),
    ("corpus m.fft", (4096, 128, 128, False), None),
)


def k1_f32_checks(gen) -> dict:
    """Phase 3's f32 checks beyond the routers: the variant at PPO's
    router tile and at the corpus's f32 sites (baseline tiles), each
    against the f32 product, timed beside torch.matmul in f32 and its
    bound; then the same bits at four tiles and at M = 4 against M = 2048
    for the three routers' (N, K) (Llama-4's, Jamba's, DeepSeek-V2's).
    Returns the records by label."""
    import torch
    from repro_torch.core.costmodel import baseline_matmul_tiles
    from repro_torch.kernels import ops
    out = {}
    for label, shape, tiles in F32_PHASE3:
        tiles = tiles or baseline_matmul_tiles(*shape[:3])
        out[label] = dict(k1_f32_check(shape, tiles, label, gen),
                          shape="x".join(map(str, shape[:3])),
                          tiles=tuple(tiles))
        torch.cuda.empty_cache()
    for N, K in ((128, 5120), (16, 4096), (160, 5120)):
        x = torch.randn((2048, K), generator=gen, device="cuda")
        w = torch.randn((K, N), generator=gen, device="cuda")
        y0 = ops.matmul(x, w, tiles=(128, 128, 512))
        tiles = [(32, 128, 1024), (16, 512, 128), (64, 256, 4096),
                 (256, 128, 512)]
        same = [bool(torch.equal(ops.matmul(x, w, tiles=t), y0))
                for t in tiles]
        rows = bool(torch.equal(
            ops.matmul(x[:4].clone(), w, tiles=(8, 128, 512)), y0[:4]))
        print(f"[k1f32:bits] M=2048 N={N} K={K}: the same bits as "
              f"(128, 128, 512) at {dict(zip(tiles, same))}; rows 0-3 at "
              f"M = 4 (8, 128, 512) the same bits as at M = 2048: {rows}",
              flush=True)
        if not all(same) or not rows:
            fail(f"K1 f32 at N={N} K={K}: a tile or M changed the bits")
    return out


def k1_operand_bytes(plan, K: int) -> float:
    """Bytes TMA moves into the SMs for one call under ``plan``: each CTA
    (those of a cluster that lie past M too) loads a (rows x 64) box of x
    per 64-deep step of its run of K, and each cluster of ``plan.cluster``
    CTAs a (64 x cols) slab of w, multicast to all of them (one CTA, one
    cluster, where ``cluster`` is 1)."""
    steps = sum(-(-(min(K, (z + 1) * plan.k_run) - z * plan.k_run) // 64)
                for z in range(plan.splits))
    c = plan.cluster
    ctas = -(-plan.grid_m // c) * c * plan.grid_n
    return steps * (ctas * plan.rows + ctas // c * plan.cols) * 128


def k1_sweep(site, gen):
    """Every legal tile of the action grid at one site gives the same
    function: compare each against the baseline tile's output.  Each
    legal tile is also timed, beside its layout (swapped below 64 CTA
    rows), its cluster and the rate at which its operands reach the SMs
    (``k1_operand_bytes``, a w slab once a cluster, over its ms); the
    summary groups the tiles by the rows a CTA loads."""
    import itertools

    import torch
    from repro_torch.configs.neurovec import DEFAULT as NV
    from repro_torch.core.costmodel import baseline_tiles
    from repro_torch.kernels import matmul as kmm
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
        plan = ops.matmul_launch_plan(M, N, K, t, sms)
        before = kmm.launches_by_layout[plan.layout]
        d = float((ops.matmul(x, w, tiles=t).float() - y0).abs().max())
        if kmm.launches_by_layout[plan.layout] != before + 1:
            fail(f"K1 at tile {t} did not run the {plan.layout} layout")
        worst = max(worst, d / scale)
        ms = time_ms_over(lambda a, b: ops.matmul(a, b, tiles=t), [(x, w)],
                          reps=5)
        nbytes = k1_operand_bytes(plan, K)
        rate = nbytes / (ms * 1e-3) / 1e12
        by_rows.setdefault(plan.rows, []).append((ms, rate, t))
        print(f"[k1:sweep] tiles={t} variant={plan.variant} CTA "
              f"{plan.rows}x{plan.cols} layout={plan.layout} "
              f"C={plan.cluster} CTAs/SM={plan.occupancy} ms={ms:.4f} "
              f"bytes_into_SMs="
              f"{nbytes / 1e6:.1f} MB operands_into_SMs={rate:.2f} TB/s",
              flush=True)
    torch.cuda.synchronize()
    if worst >= K1_TOL:
        fail(f"K1 tile sweep: max rel difference {worst:.3e}")
    for rows, recs in sorted(by_rows.items()):
        recs.sort()
        rates = [r for _, r, _ in recs]
        print(f"[k1:sweep] rows loaded {rows} ({len(recs)} tiles): ms "
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

def k2_call(q, k, v, tiles, causal=True):
    """One K2 call through ops.flash_attention; returns the output and
    the variant that ran."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    before = dict(kfa.launches_by_variant)
    y = ops.flash_attention(q, k, v, causal=causal,
                            scale=q.shape[-1] ** -0.5, tiles=tiles)
    torch.cuda.synchronize()
    ran = [x for x in kfa.VARIANTS
           if kfa.launches_by_variant[x] != before[x]]
    if len(ran) != 1 or sum(kfa.launches_by_variant.values()) != \
            sum(before.values()) + 1:
        fail(f"K2 did not launch once at tiles {tiles}: {ran}")
    return y, ran[0]


def k2_work(B, H, Hkv, Sq, Skv, D, causal=True, Dv=None):
    """Operations and bytes of one call: the causal half of the two
    products (Sq = Skv), Q.K^T at D and P.V at the value dim Dv (default
    D), q, k, v read once and out written once.  The bound is bytes at
    the Qwen3-8B prefill: 42 MB at 3.35 TB/s (0.0125 ms) against 8.6
    GFLOP at 989 TFLOP/s (0.0087 ms); at DeepSeek-V2's served mla.core (H
    = 128, D = 192, Dv = 128) 335 MB (0.100 ms) against 42.9 GFLOP (0.043
    ms)."""
    Dv = D if Dv is None else Dv
    pairs = Sq * (Sq + 1) / 2 if causal else Sq * Skv
    return (2.0 * B * H * (D + Dv) * pairs,
            2.0 * (B * H * Sq * (D + Dv) + B * Hkv * Skv * (D + Dv)))


def k2_plan(q, k, v, t):
    """K2's launch plan for a call, as the wrapper makes it."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    return ops.attention_launch_plan(
        q.shape[2], k.shape[2], q.shape[-1], *t,
        tuple(kfa._tma_strides(x) for x in (q, k, v)),
        aligned=all(x.data_ptr() % 16 == 0 for x in (q, k, v)),
        Dv=v.shape[-1])


def k2_launched(label, plan, variant):
    """What K2's tma_wgmma launch just ran at, read back from its C entry
    point (warpgroups, keys a stage, widths, ring, dynamic shared memory);
    fails where it is not the plan's.  ``None`` for the unaligned
    variant."""
    from repro_torch.kernels import flash_attention as kfa
    if variant != "tma_wgmma":
        return None
    ran = kfa.tma_last_launch()
    if any(ran[f] != getattr(plan, f) for f in ran):
        fail(f"K2 {label} launched at {ran}, not its plan {plan}")
    return ran


def k2_line(label, q, k, v, t, ref_out=None, causal=True):
    """K2 at tiles ``t`` against its plain version, with what the launch
    ran at (padded widths, keys a stage, ring, read back from the kernel's
    entry point and held against the plan), ms (events, 20 calls back to
    back), device ms (profiler), share of the bound at the true D and Dv
    and ratio to scaled_dot_product_attention on the same inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    B, H, S, D = q.shape
    Hkv, Dv = k.shape[1], v.shape[-1]
    scale = D ** -0.5
    plan = k2_plan(q, k, v, t)
    y, variant = k2_call(q, k, v, t, causal)
    ran = k2_launched(label, plan, variant)
    yp = kfa.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                   bq=t[0], bkv=t[1])
    err = float((y.float() - yp.float()).abs().max())
    if not torch.isfinite(y).all() or err >= K2_TOL:
        fail(f"K2 {label} tiles {t}: abs err {err:.3e} >= {K2_TOL}")
    err_ref = ""
    if ref_out is not None:
        err_ref = f"|k-ref_f32|={float((y.float() - ref_out).abs().max()):.3e} "
    del y, yp
    ms = time_ms_over(lambda: ops.flash_attention(
        q, k, v, causal=causal, scale=scale, tiles=t), [()])
    dev = sum(device_ms_by_kernel(lambda: ops.flash_attention(
        q, k, v, causal=causal, scale=scale, tiles=t)).values()) or None
    plain_ms = time_ms_over(lambda: kfa.flash_attention_plain(
        q, k, v, causal=causal, scale=scale, bq=t[0], bkv=t[1]), [()],
        reps=5, calls=1)
    def sdpa():
        return F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale, enable_gqa=H != Hkv)
    lib_ms = time_ms_over(sdpa, [()])
    lib_dev = sum(device_ms_by_kernel(sdpa).values()) or None
    flops, nbytes = k2_work(B, H, Hkv, S, k.shape[2], D, causal, Dv)
    b, by = bound_s(flops, nbytes)
    share_ms = dev if dev is not None else ms
    dev_ratio = (f"{dev / lib_dev:.2f}x" if dev and lib_dev
                 else "not measured")
    print(f"[k2:{label}] B={B} H={H} Hkv={Hkv} S={S} D={D}"
          f"{'' if Dv == D else f' Dv={Dv}'} "
          f"{'causal' if causal else 'non-causal'} "
          f"tiles={t} variant={variant} widths={plan.d_pad}x"
          f"{plan.dv_pad} stage_keys={plan.stage_keys} ring={plan.ring} "
          f"|k-plain|={err:.3e} {err_ref}"
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
            "flops": flops, "bytes": nbytes, "variant": variant,
            "plan": plan._asdict(), "launched": ran}


def k2_plan_line(label, S, D, t, strides=None, Dv=None):
    """K2's launch plan at a shape, printed; returns it."""
    from repro_torch.kernels import ops
    p = ops.attention_launch_plan(S, S, D, *t, strides, Dv=Dv)
    print(f"[k2-plan:{label}] S={S} D={D} Dv={Dv or D} tiles={t}: "
          f"variant={p.variant} widths={p.d_pad}x{p.dv_pad} warpgroups="
          f"{p.warpgroups} stage_keys={p.stage_keys} n_stages={p.n_stages} "
          f"ring={p.ring} smem={p.smem}", flush=True)
    return p


def mla_small_model_check() -> dict:
    """DeepSeek-V2 at a small width but MLA's full head dims (bf16, d
    256, 4 heads, D = 128 + 64, Dv = 128, 2 layers of 4 experts top-2):
    the prefill under the baseline program (K1, its f32 variant, K2 at D
    = 192, Dv = 128) against eager at LOGIT_TOL, where routing seldom
    flips (at full width, top-6 of 160, it flips on every batch row: phase
    12 holds no row there), then 3 absorbed decode steps, finite."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.extractor import extract_serve_sites
    from repro_torch.core.vectorizer import baseline_program, inject
    from repro_torch.models.lm import build_model
    cfg = get_config("deepseek_v2_236b").reduced(
        dtype="bfloat16", d_model=256, n_heads=4, qk_nope_dim=128,
        qk_rope_dim=64, v_head_dim=128, n_layers=2)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    prog = baseline_program(extract_serve_sites(model, 2, 128, 4))
    tok = torch.randint(0, cfg.vocab_size, (2, 128), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(1))
    with torch.inference_mode():
        le, _ = model.prefill(params, {"tokens": tok},
                              model.make_cache(2, 132, device="cuda"))
        with inject(prog):
            cache = model.make_cache(2, 132, device="cuda")
            lk, cache = model.prefill(params, {"tokens": tok}, cache)
            ld = lk
            for i in range(3):
                ld, cache = model.decode_step(params, ld.argmax(-1)[:, None],
                                              128 + i, cache)
        torch.cuda.synchronize()
    rel = float((lk - le).abs().max() / le.abs().max())
    print(f"[mla:small] deepseek_v2_236b at d 256, 4 heads, D=192 Dv=128, 2 "
          f"layers, bf16: injected vs eager prefill logits {rel:.4e} (tol "
          f"{LOGIT_TOL}); 3 absorbed decode steps finite: "
          f"{bool(torch.isfinite(ld).all())}", flush=True)
    if rel >= LOGIT_TOL or not torch.isfinite(ld).all():
        fail(f"MLA at a small width: injected logits {rel:.3e} off eager's")
    return {"logits_rel": rel}


def k2_mla_checks(gen):
    """K2 at MLA's head dims beyond phase 12's baseline tile: DeepSeek-V2's
    mla.core in the served layout (B=4, H=128, S=512, D=192, Dv=128,
    causal; q and k the contiguous concatenations, v the einsum's view) at
    a tile PPO can pick, and the measurement runner's layout (B=1, H=512,
    D=Dv=192, contiguous) at the baseline tile; each with its plan (64-key
    stages, at PPO's one warpgroup a ring of 4, at the runner's two 2; P.V
    at Dv's own width), against its plain version, timed beside SDPA;
    DeepSeek-V2 at a small width and MLA's full head dims, injected
    against eager (:func:`mla_small_model_check`).  Then the plan at the
    Qwen3-8B prefill (D = 128), which must be the one it had before K2
    took D > 128.  Returns the records by label."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()
    B, H, S, D, Dv = 4, 128, 512, 192, 128
    q, k = rnd(B, H, S, D), rnd(B, H, S, D)
    v = rnd(B, S, H, Dv).transpose(1, 2)
    t = MLA_PPO_TILE
    p = k2_plan_line("mla served", S, D, t, tuple(
        x.stride() for x in (q, k, v)), Dv)
    if (p.variant, p.stage_keys, p.ring, p.d_pad, p.dv_pad) != (
            "tma_wgmma", 64, 4, 192, 128):
        fail(f"K2's plan at mla.core {p}")
    out = {"served_ppo_tile": dict(k2_line("mla served", q, k, v, t),
                                   tiles=t)}
    del q, k, v
    torch.cuda.empty_cache()
    r = MLA_RUNNER
    q, k, v = (rnd(r["B"], r["H"], r["S"], d)
               for d in (r["D"], r["D"], r["Dv"]))
    p = k2_plan_line("mla runner", r["S"], r["D"], (128, 512), None, r["Dv"])
    if (p.variant, p.stage_keys, p.ring, p.d_pad, p.dv_pad) != (
            "tma_wgmma", 64, 2, 192, 192):
        fail(f"K2's plan in the runner's layout at D = 192 {p}")
    out["runner"] = dict(k2_line("mla runner", q, k, v, (128, 512)),
                         tiles=(128, 512))
    del q, k, v
    torch.cuda.empty_cache()
    out["small_model"] = mla_small_model_check()
    qwen = k2_plan_line("qwen3 prefill", 512, 128, (128, 512), (
        (32 * 512 * 128, 512 * 128, 128, 1), (8 * 512 * 128, 512 * 128, 128, 1),
        (512 * 8 * 128, 128, 8 * 128, 1)))
    before = ("tma_wgmma", 128, 512, 2, 128, 4, 2,
              2 * 2 * 64 * 128 * 2 + 2 * 4 * 128 * 128 + 1024)
    if tuple(qwen)[:len(before)] != before or (qwen.d_pad,
                                                qwen.dv_pad) != (128, 128):
        fail(f"K2's plan at D = 128 moved: {tuple(qwen)} != {before}")
    return out


def k2_width_inputs(shape, layout, gen):
    """q, k, v of a ``K2_WIDTH_SHAPES`` row in its layout."""
    import torch
    B, H, Hkv, S, D, Dv = shape

    def make(h, d, view):
        if view:
            return torch.randn((B, S, h, d), generator=gen,
                               device="cuda").bfloat16().transpose(1, 2)
        return torch.randn((B, h, S, d), generator=gen,
                           device="cuda").bfloat16()
    return (make(H, D, layout == "views"), make(Hkv, D, layout == "views"),
            make(Hkv, Dv, layout != "contig"))


def k2_width_checks(gen):
    """K2 at ``K2_WIDTH_SHAPES``: each against its plain version, through
    the tma_wgmma variant at the widths its plan passes the kernel (read
    back from the launch, :func:`k2_launched`), with its bound at the true
    D and Dv, and SDPA's time.  Returns the records by label."""
    import torch
    out = {}
    for label, shape, causal, layout, t in K2_WIDTH_SHAPES:
        q, k, v = k2_width_inputs(shape, layout, gen)
        r = k2_line(f"width {label}", q, k, v, t, causal=causal)
        if r["variant"] != "tma_wgmma":
            fail(f"K2 {label}: plan {r['plan']}, variant {r['variant']}")
        out[label] = dict(r, tiles=t)
        del q, k, v
        torch.cuda.empty_cache()
    return out


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
    """K2 at head dims other than 128.  At the StableLM-3B prefill (B=4,
    H=Hkv=32, S=512, D=80, causal; q and k contiguous, v the transposed
    view of its projection, as the model passes them) over every (bq, bkv)
    of the action space (the illegal ones must raise), each line with its
    bound at the true D and SDPA's time; once with q, k and v all the
    transposed views of their projections (strides (S*H*D, D, H*D, 1)),
    and once through the unaligned variant (q 2 bytes into its storage).
    Then D = 64, 96, 136 and 192 (each padded width of the TMA variant:
    64, 96 as a 64- and a 32-column slab, 192 partly past D and whole) at
    a small shape, both variants.  Returns the D = 80 records by tile and
    the largest error of the other checks."""
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
    for d in (64, 96, 136, 192):
        b, h, hkv, s_ = 2, 8, 2, 256
        qd, kd, vd = rnd(b, h, s_, d), rnd(b, hkv, s_, d), rnd(b, hkv, s_, d)
        checks += [(f"d{d}", d, qd, kd, vd, "tma_wgmma"),
                   (f"d{d} unaligned", d, rnd(b, h, s_, d + 1)[..., 1:], kd,
                    vd, "unaligned")]
    small = 0.0
    for label, d, qc, kc, vc, want in checks:
        y, variant = k2_call(qc, kc, vc, (128, 128))
        ran = k2_launched(label, k2_plan(qc, kc, vc, (128, 128)), variant)
        yp = kfa.flash_attention_plain(qc, kc, vc, causal=True,
                                       scale=d ** -0.5, bq=128, bkv=128)
        err = float((y.float() - yp.float()).abs().max())
        print(f"[k2:{label}] shape={tuple(qc.shape)} variant={variant} "
              f"launched={ran} |k-plain|={err:.3e} (tol {K2_TOL})",
              flush=True)
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
    the number of its launches the trace recorded.  A trace may drop the
    first launches after the profiler starts (all of them, for a few
    short calls), so each trace records a warmup step of ``reps`` calls
    that it discards before the step it keeps, and a trace that recorded
    no device time at all is taken again, up to eight times.  Each kernel
    here launches once per call of its wrapper."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    tot, cnt = {}, {}
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
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
    """K1's and K2's launches by variant (K1's also by layout) since
    zero_counts(), into ``counts``; a model path must never take an
    unaligned variant."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    for name, mod in (("matmul", kmm), ("flash_attention", kfa)):
        by = dict(mod.launches_by_variant)
        if by["unaligned"]:
            fail(f"{path}: {by['unaligned']} {name} launches took the "
                 f"unaligned variant")
        print(f"[{path}] {name} launches by variant: {by}", flush=True)
        counts[f"{name}_by_variant"] = by
    counts["matmul_by_layout"] = dict(kmm.launches_by_layout)
    print(f"[{path}] matmul launches by layout: "
          f"{counts['matmul_by_layout']}", flush=True)


def read_counts():
    from repro_torch.kernels import chunk_scan as kcs
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    return {"matmul": kmm.launches, "flash_attention": kfa.launches,
            "chunk_scan": kcs.launches}


def per_pass_launches(cfg):
    """Kernel launches of one prefill and of the GEN - 1 decode steps
    under --inject: K1 at every matmul of a block (4 in the attention, in
    MLA 4 with a query latent and 3 without, 2 in a Mamba mixer, 3 in a gated SiLU MLP, 2 in a GELU one, 1 in an MoE
    MLP, its f32 router, and 3 more for its shared experts), the head and
    a vision frontend's projection (prefill only); K2 at prefill
    attention.  An encoder-decoder's encoder runs in the prefill only,
    and each decoder layer's cross-attention adds 4 matmuls and K2 in the
    prefill, 2 matmuls (q, o: its k/v are cached) a decode step.  The
    mLSTM and SSD scans, the expert einsums and the other einsums (MLA's
    up-projections and its absorbed decode, which runs no K2) stay plain
    PyTorch."""
    attn_mm = 3 if cfg.mla and not cfg.q_lora_rank else 4
    mixer = {"attn": (attn_mm, 1), "mamba": (2, 0), "mlstm": (2, 0),
             "slstm": (3, 0)}
    mlp = {"dense": 3 if cfg.act == "silu" else 2, "none": 0,
           "moe": 1 + 3 * bool(cfg.n_shared_experts)}
    mm = sum(mixer[b.kind][0] + mlp[b.mlp] for b in cfg.period)
    att = sum(mixer[b.kind][1] for b in cfg.period)
    if cfg.enc_dec:
        n_enc = cfg.n_enc_layers // len(cfg.period)
        n_dec = cfg.n_dec_layers // len(cfg.period)
        pre_mm = 1 + n_enc * mm + n_dec * (mm + 4)
        pre_att = n_enc * att + 2 * n_dec * att
        dec_mm = 1 + n_dec * (mm + 2)
    else:
        pre_mm = 1 + cfg.n_periods * mm + (cfg.frontend == "vision")
        pre_att = cfg.n_periods * att
        dec_mm = 1 + cfg.n_periods * mm
    return ({"matmul": pre_mm, "flash_attention": pre_att, "chunk_scan": 0},
            {"matmul": dec_mm * (GEN - 1), "flash_attention": 0,
             "chunk_scan": 0})


def measured_path(arch, params=None, prompts=None, agent="ppo", extra=(),
                  worker_dir=None, eager=None):
    """serve --autotune ``agent`` --measured --inject at full width,
    counters zeroed just before and read just after; checked against eager
    mode on the same prompts.  With ``worker_dir`` the timings ran in
    worker processes, which wrote their launch counters there: this
    process must have launched nothing during the fit, and the workers
    every kernel of the path's sites.  ``eager``: an earlier eager run of
    the same weights and prompts (this function's third result), which
    then stands in for a new one.  Returns ``(result, counts, eager)``,
    ``eager`` a dict of the eager run's logits, tokens and times."""
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
    if eager is None:
        e = serve.run(serve.parse_args(argv[:argv.index("--autotune")]),
                      params=res.params, prompts=res.prompts)
        eager = {"logits": e.prefill_logits, "seq": e.seq,
                 "prefill_ms": e.prefill_ms,
                 "prefill_ms_runs": e.prefill_ms_runs,
                 "decode_tok_s": e.decode_tok_s,
                 "decode_tok_s_runs": e.decode_tok_s_runs, "run": "this"}
        del e
    else:
        eager = dict(eager, run="an earlier")
    rel = float((logits - eager["logits"]).abs().max()
                / eager["logits"].abs().max())
    agree = float((res.seq == eager["seq"]).float().mean())
    print(f"[measured:{arch}] kernel vs eager prefill logits: relative "
          f"{rel:.4e} (tol {LOGIT_TOL}); greedy tokens agree "
          f"{agree * 100:.1f}%; kernels: prefill ms {res.prefill_ms:.2f} of "
          f"{[round(t, 2) for t in res.prefill_ms_runs]}, decode tok/s "
          f"{res.decode_tok_s:.2f} of "
          f"{[round(t, 2) for t in res.decode_tok_s_runs]}; eager "
          f"({eager['run']} run): prefill ms {eager['prefill_ms']:.2f} of "
          f"{[round(t, 2) for t in eager['prefill_ms_runs']]}, decode tok/s "
          f"{eager['decode_tok_s']:.2f} of "
          f"{[round(t, 2) for t in eager['decode_tok_s_runs']]}; measured "
          f"H100 speedup of the tuned program {res.modelled_speedup:.3f}x",
          flush=True)
    if rel >= LOGIT_TOL:
        fail(f"{arch}: prefill logits differ from eager: {rel:.3e}")
    print(f"[measured:{arch}] tuned tiles: " + ", ".join(
        f"{s.site}@M={s.m}:{tuple(res.prog.tiles[s.key()])}"
        for s in res.sites), flush=True)
    return res, counts, eager


def worker_counts(worker_dir) -> dict:
    """The kernel launches that measurement workers reported: the sum of
    the ``worker-<pid>.json`` files they wrote under ``worker_dir``
    (``REPRO_TORCH_LAUNCH_DIR``), K1's and K2's by variant and K1's by
    layout too, and their
    use of the card's timing lock (acquisitions, seconds waited and
    held)."""
    total = {"matmul": 0, "flash_attention": 0, "chunk_scan": 0,
             "matmul_by_variant": {}, "flash_attention_by_variant": {},
             "matmul_by_layout": {},
             "timing_lock": {"acquires": 0, "wait_s": 0.0, "held_s": 0.0}}
    for f in sorted(Path(worker_dir).glob("worker-*.json")):
        c = json.loads(f.read_text())
        for k, v in c.items():
            if isinstance(v, dict):
                for var, n in v.items():
                    total[k][var] = total[k].get(var, 0) + n
            elif isinstance(v, (int, float)):
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
    # phase 5's measured Qwen3-8B serve of these weights and prompts is
    # held against this eager run
    return res, counts, {"logits": eager.prefill_logits, "seq": eager.seq,
                         "prefill_ms": eager.prefill_ms,
                         "prefill_ms_runs": eager.prefill_ms_runs,
                         "decode_tok_s": eager.decode_tok_s,
                         "decode_tok_s_runs": eager.decode_tok_s_runs}


def busy_by_kernel(prof, n_top: int = 6):
    """The device's busy ms in a ``torch.profiler`` trace and the
    ``n_top`` kernels that took the most of it, as (name, ms)."""
    by = {}
    for e in prof.key_averages():       # kernels only: an operator's
        # device time is its kernels', which would count twice
        if str(getattr(e, "device_type", "")).endswith("CUDA") and \
                e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0].split("::")[-1][:40]
            by[name] = by.get(name, 0.0) + e.self_device_time_total / 1e3
    return sum(by.values()), sorted(by.items(), key=lambda kv: -kv[1])[:n_top]


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
    busy, top = busy_by_kernel(prof)
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
    # the eager run that the measured runs of these weights and prompts
    # (here, phases 9 and 10) are held against
    eager = {"logits": eager.prefill_logits, "seq": eager.seq,
             "prefill_ms": eager.prefill_ms,
             "prefill_ms_runs": eager.prefill_ms_runs,
             "decode_tok_s": eager.decode_tok_s,
             "decode_tok_s_runs": eager.decode_tok_s_runs}
    del res
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
                                       extra=("--measure-db", str(db)),
                                       eager=eager)
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
    ref_pairs = b_res.tuning["stats"]["transport_timed_pairs_total"]
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
            "breakdown": breakdown, "db": db, "ref_pairs": ref_pairs,
            "eager": eager}


# ---------------------------------------------------------------------------
# phase 8: the facade
# ---------------------------------------------------------------------------

def take_counts(acc: dict) -> dict:
    """Add the launches since the last zero_counts() (and K1's and K2's by
    variant, K1's by layout) into ``acc``, zero the counters, and return
    the segment's."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    seg = read_counts()
    for k, v in seg.items():
        acc[k] = acc.get(k, 0) + v
    for key, counts in (("matmul_by_variant", kmm.launches_by_variant),
                        ("flash_attention_by_variant",
                         kfa.launches_by_variant),
                        ("matmul_by_layout", kmm.launches_by_layout)):
        by = acc.setdefault(key, {})
        for var, n in counts.items():
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
CHAOS_JOB_S = 5.0                           # a hang is killed after this


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


class ProfilingRunner:
    """The port's runner on the card that also takes, for every pair, the
    device ms of one call from a ``torch.profiler`` trace (under the
    card's lock, as the timing) and appends ``{"key", "host_ms",
    "device_ms"}`` to the JSON-lines file ``$CHIP_SMOKE_PROFILE_OUT``:
    the runner's host-clock median beside the kernels' own time.  Built
    in a worker by the pool's ``factory`` seam, or in this process."""

    def __init__(self):
        from repro_torch.measure.runner import MeasureRunner
        self.base = MeasureRunner(reps=3, warmup=1, device="cuda")

    backend_key = property(lambda self: self.base.backend_key)
    device = property(lambda self: self.base.device)

    def __call__(self, sites, tiles):
        import numpy as np
        from repro_torch.measure import timing
        out = []
        for site, t in zip(sites, tiles):
            fn = self.base._build(site, t)
            host = timing.median_time(fn, reps=self.base.reps,
                                      warmup=self.base.warmup,
                                      device=self.device)
            with timing.card_lock(self.device):
                dev = sum(device_ms_by_kernel(fn).values())
            with open(os.environ["CHIP_SMOKE_PROFILE_OUT"], "a") as f:
                f.write(json.dumps({
                    "key": f"{site.key()}|{tuple(int(x) for x in t)}",
                    "host_ms": host * 1e3, "device_ms": dev}) + "\n")
            out.append(host)
        return np.array(out, np.float64)


def profiling_runner():
    return ProfilingRunner()


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


def start_daemon(args: list, env: dict, tag: str = "fleet") -> tuple:
    """``python -m repro_torch.fleet <args>``, its output (and its
    workers') to a log under build/; returns (process, log, address) once
    the log holds the flushed ready line."""
    log = ROOT / "build" / f"{tag}_{args[0]}.log"
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


def transports_path(ref_db, xl_scan, k3_inproc: dict, ref_speedup: float,
                    eager: dict):
    """Phase 9: the measured oracle's transports on the card, each checked
    against phase 6's in-process run (its timing DB ``ref_db``, its brute
    pick's measured speedup ``ref_speedup``, its eager run of the same
    weights and prompts ``eager``); every timing holds the card's lock.  (1) serve --transport pool --workers 2 on StableLM-3B:
    the in-process keys, all finite, health ok, the same backend, no
    launch in this process during the fit, the injected prefill's
    launches and logits as phase 6's; (2) --workers 1, and the per-pair
    ratios to the in-process times with the fits' wall, spawn seconds and
    the workers' lock wait; (3) K3 at xLSTM's chunk-scan site, every
    chunk, in a pool of 2; (4) a worker's device-side assert, and a
    ChaosRunner over the card; (5) one worker against this process on the
    same pairs, host-clock ms beside profiled device ms; (6) the fleet:
    serve-worker and serve-artifacts daemons, serve --transport socket
    against them, and a warm rerun that times nothing.  Returns the
    launch counts by path (the workers' own) and the numbers."""
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
                                               extra=extra, worker_dir=wdir,
                                               eager=eager)
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
            "lock": wc["timing_lock"],
            "measured_speedup": res.modelled_speedup}
        print(f"[transports] {label}: {st['transport_timed_pairs_total']} "
              f"pairs timed in the workers, fit and tune "
              f"{res.tuning['fit_s']:.2f} s wall after the pool's start "
              f"({res.tuning['oracle_setup_s']:.2f} s wall, "
              f"{st['pool_spawn_seconds_total']:.2f} s of handshakes summed "
              f"over the workers); {st['pool_worker_restarts_total']} "
              f"restarts; worker launches {out[label]['worker_launches']}; "
              f"the card's lock: {wc['timing_lock']['acquires']} timed "
              f"calls, {wc['timing_lock']['wait_s']:.2f} s waited and "
              f"{wc['timing_lock']['held_s']:.2f} s held, summed over the "
              f"workers; measured speedup {res.modelled_speedup:.3f}x "
              f"(in process {ref_speedup:.3f}x)", flush=True)
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
    out["k3_pool_lock"] = wc["timing_lock"]
    # the lock's verdict: a pool of 2 against a pool of 1 and in process
    r2, r1 = (out[f"pool workers={w}"]["ratio"]["median"] for w in (2, 1))
    sp2 = out["pool workers=2"]["measured_speedup"]
    out["verdict"] = {"pool2_over_pool1_median": r2 / r1,
                      "pool2_speedup_over_inproc": sp2 / ref_speedup}
    print(f"[transports] under the lock: pool of 2 median ratio {r2:.4f} "
          f"against the pool of 1's {r1:.4f} ({r2 / r1:.4f}x; the target "
          f"is within 1.10x); the pool of 2's brute pick measures "
          f"{sp2:.3f}x against {ref_speedup:.3f}x in process "
          f"({sp2 / ref_speedup:.4f}; the target is within 10%)",
          flush=True)

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

    # (5) one worker against this process: host-clock ms beside the
    # profiled device ms of the same pairs
    prof = fresh_dir("gap_profile")
    gap_pairs = pairs[::max(1, len(pairs) // 12)]
    gap = {}
    for where in ("inproc", "worker"):
        os.environ["CHIP_SMOKE_PROFILE_OUT"] = str(prof / f"{where}.jsonl")
        try:
            if where == "inproc":
                ProfilingRunner()([p[0] for p in gap_pairs],
                                  np.array([p[1] for p in gap_pairs]))
            else:
                with WorkerPoolTransport(
                        workers=1, factory="chip_smoke:profiling_runner",
                        spawn_timeout=POOL_SPAWN_S,
                        job_timeout=POOL_JOB_S) as t:
                    [f.result() for f in t.submit(
                        [p[0] for p in gap_pairs],
                        np.array([p[1] for p in gap_pairs]))]
        finally:
            os.environ.pop("CHIP_SMOKE_PROFILE_OUT", None)
        gap[where] = {r["key"]: r for r in map(
            json.loads, (prof / f"{where}.jsonl").read_text().splitlines())}
    keys = sorted(gap["inproc"])
    empty = [f"{w} {k}" for w in gap for k in keys
             if gap[w][k]["device_ms"] <= 0]
    if empty:
        fail(f"transports: the profiler saw no device time for "
             f"{len(empty)} pair(s): {empty}")
    def ratios(f):
        return np.array([gap["worker"][k][f] / gap["inproc"][k][f]
                         for k in keys])
    host_r, dev_r = ratios("host_ms"), ratios("device_ms")
    host_gap = np.array([gap["inproc"][k]["host_ms"]
                         - gap["inproc"][k]["device_ms"] for k in keys])
    out["one_worker_gap"] = {
        "pairs": len(keys), "host_ratio_median": float(np.median(host_r)),
        "device_ratio_median": float(np.median(dev_r)),
        "inproc_host_over_device_ms_median": float(np.median(host_gap)),
        "worker_host_over_device_ms_median": float(np.median(
            [gap["worker"][k]["host_ms"] - gap["worker"][k]["device_ms"]
             for k in keys]))}
    print(f"[transports] one worker against this process on {len(keys)} "
          f"StableLM pairs: host-clock ms ratio median "
          f"{np.median(host_r):.4f} (p10 {np.quantile(host_r, 0.1):.4f}, "
          f"p90 {np.quantile(host_r, 0.9):.4f}); profiled device ms ratio "
          f"median {np.median(dev_r):.4f} (p10 "
          f"{np.quantile(dev_r, 0.1):.4f}, p90 "
          f"{np.quantile(dev_r, 0.9):.4f}); host ms beyond the device ms, "
          f"median: in process "
          f"{out['one_worker_gap']['inproc_host_over_device_ms_median']:.4f}"
          f", worker "
          f"{out['one_worker_gap']['worker_host_over_device_ms_median']:.4f}"
          + "; by pair (host / device ms, in process | worker): "
          + ", ".join(f"{k.split(':')[1]}{k.rsplit('|', 1)[1]} "
                      f"{gap['inproc'][k]['host_ms']:.4f}/"
                      f"{gap['inproc'][k]['device_ms']:.4f} | "
                      f"{gap['worker'][k]['host_ms']:.4f}/"
                      f"{gap['worker'][k]['device_ms']:.4f}"
                      for k in keys), flush=True)

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
                                       extra=fleet_extra, worker_dir=wdir,
                                       eager=eager)
        values, n_quar = read_db(f_db)
        check_like_inproc("fleet", values, n_quar, ref, res)
        q = ratio_line("fleet (pool of 2 behind serve-worker)", values, ref)
        st = res.tuning["stats"]
        wc = worker_counts(wdir)
        cold = {"timed": st["transport_timed_pairs_total"],
                "fit_s": res.tuning["fit_s"],
                "setup_s": res.tuning["oracle_setup_s"],
                "store": res.tuning["store"], "ratio": q,
                "lock": wc["timing_lock"],
                "measured_speedup": res.modelled_speedup}
        del res
        argv = ["--arch", STABLELM, "--full", "--batch", str(BATCH),
                "--prompt-len", str(PROMPT), "--gen", str(GEN),
                "--autotune", "brute", "--measured", *fleet_extra]
        zero_counts()
        warm = serve.run(serve.parse_args(argv))
        wst, store = warm.tuning["stats"], warm.tuning["store"]
        print(f"[transports] fleet: cold run {cold['timed']} pairs timed on "
              f"the serve-worker in {cold['fit_s']:.2f} s (setup "
              f"{cold['setup_s']:.2f} s), measured speedup "
              f"{cold['measured_speedup']:.3f}x, worker launches {wc}; warm "
              f"rerun "
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


# ---------------------------------------------------------------------------
# phase 10: the learned cost model on the card
# ---------------------------------------------------------------------------

PRUNE_TOPK = 4
RETIME_ROUNDS = 5


def _avg_ranks(x):
    import numpy as np
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), np.float64)
    ranks[order] = np.arange(len(x), dtype=np.float64)
    xs = x[order]
    i = 0
    while i < len(xs):          # ties share their mean rank
        j = i
        while j + 1 < len(xs) and xs[j + 1] == xs[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0
        i = j + 1
    return ranks


def spearman(a, b) -> float:
    """Spearman's rho over the entries finite in both, with tied entries
    sharing their mean rank; nan below 3 such entries."""
    import numpy as np
    ok = np.isfinite(a) & np.isfinite(b)
    if ok.sum() < 3:
        return float("nan")
    ra, rb = _avg_ranks(a[ok]), _avg_ranks(b[ok])
    ra, rb = ra - ra.mean(), rb - rb.mean()
    d = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / d) if d else float("nan")


def retime_programs(sites, programs: dict) -> dict:
    """Each site's baseline tile and each program's tile, timed by one
    runner in this process in ``RETIME_ROUNDS`` interleaved rounds (each
    a median of 3 under the card's lock); per program the summed
    baseline seconds over its summed seconds, as ``program_speedup``
    aggregates."""
    import numpy as np
    from repro_torch.core.costmodel import baseline_tiles
    from repro_torch.measure import timing
    from repro_torch.measure.runner import MeasureRunner
    runner = MeasureRunner(reps=3, warmup=1, device="cuda")
    tot = {name: 0.0 for name in ("baseline", *programs)}
    for s in sites:
        want = {"baseline": tuple(baseline_tiles(s))}
        want.update({n: tuple(p.tiles[s.key()]) for n, p in programs.items()})
        want = {n: (t + (1, 1, 1))[:3] for n, t in want.items()}
        fns = {t: runner._build(s, t) for t in set(want.values())}
        for fn in fns.values():
            timing.median_time(fn, reps=1, warmup=1, device=runner.device)
        times = {t: [] for t in fns}
        for _ in range(RETIME_ROUNDS):
            for t, fn in fns.items():
                times[t].append(timing.median_time(
                    fn, reps=3, warmup=0, device=runner.device))
        for n, t in want.items():
            tot[n] += float(np.median(times[t]))
    return {n: tot["baseline"] / tot[n] for n in programs}


def surrogate_path(sl, p5_db):
    """Phase 10: the learned cost model on the card.  (a) ``train_from_db``
    on the in-process timings of phase 5's two measured fits (Qwen3-8B and
    xLSTM-1.3B, K3's chunks among them); StableLM-3B's are held out.
    (b) Per StableLM-3B site, Spearman's rho of the surrogate's and of
    the analytic model's prices against phase 6's measured grid.  (c)
    ``serve --autotune brute --measured --prune-topk 4 --surrogate DIR
    --inject`` at full width: timed against phase 6's pairs, surrogate-
    priced pairs, the fit's wall, best tiles matching full brute force,
    the pruned and full picks re-timed interleaved in this process, and
    the injected prefill against eager.  (d) PPO fitted against
    ``oracle="surrogate"`` with phase 6's settings, its program priced by
    phase 6's timings beside PPO's on the cost model.  Returns the pruned
    serve's launch counts and the numbers."""
    from collections import Counter

    import numpy as np
    import torch
    from repro_torch.api import NeuroVectorizer
    from repro_torch.configs import get_config
    from repro_torch.configs.neurovec import DEFAULT, NeuroVecConfig
    from repro_torch.core import costmodel_vec, dataset
    from repro_torch.core.env import ActionSpace
    from repro_torch.core.extractor import extract_serve_sites
    from repro_torch.core.vectorizer import TileProgram, program_speedup
    from repro_torch.measure import make_key, make_measured_env
    from repro_torch.models.lm import build_model
    from repro_torch.surrogate import build_corpus, save_surrogate, \
        train_from_db
    out = {}
    # (a) the corpus of phase 5, trained on the card
    t0 = time.perf_counter()
    model = train_from_db(str(p5_db), device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if model is None:
        fail(f"surrogate: phase 5's DB {p5_db} is too cold to train on")
    corpus = build_corpus(str(p5_db), backend=model.backend)
    kinds = dict(Counter(s.kind for s in corpus.sites))
    if not kinds.get("chunk_scan") or not kinds.get("matmul"):
        fail(f"surrogate: the corpus lacks K1 or K3 pairs: {kinds}")
    ckpt = ROOT / "build" / "surrogate_ckpt"
    save_surrogate(model, str(ckpt))
    out["train"] = {"pairs": len(corpus.y), "by_kind": kinds,
                    "backend": model.backend, "ensemble": model.ensemble,
                    "hidden": model.hidden, "train_s": train_s}
    print(f"[surrogate] corpus: {len(corpus.y)} pairs of phase 5's "
          f"Qwen3-8B and xLSTM-1.3B fits ({kinds}), backend "
          f"{model.backend}; ensemble of {model.ensemble} tanh MLPs "
          f"{model.hidden} trained on {model.device} in {train_s:.2f} s "
          f"(500 full-batch AdamW steps each); StableLM-3B held out",
          flush=True)
    # (b) rank agreement with phase 6's measured grid
    sites = extract_serve_sites(build_model(get_config(STABLELM)), BATCH,
                                PROMPT, GEN)
    ref, _ = read_db(sl["db"])
    backend = next(iter(ref)).rsplit("|", 1)[1]
    space = ActionSpace(DEFAULT)
    rho = {"surrogate": {}, "analytic": {}}
    for s in sites:
        grid = costmodel_vec.action_tiles_grid(space, s.kind)
        meas = np.array([ref.get(make_key(s.key(), t, backend), np.inf)
                         for t in grid])
        label = f"{s.site}@m{s.m}"
        rho["surrogate"][label] = spearman(meas, model.predict_seconds(
            [s] * len(grid), grid, "h100"))
        rho["analytic"][label] = spearman(meas, costmodel_vec.costs_for_tiles(
            [s] * len(grid), grid, "h100"))
    means = {k: float(np.nanmean(list(v.values()))) for k, v in rho.items()}
    out["spearman"] = {"per_site": rho, "mean": means}
    print(f"[surrogate] Spearman rho against phase 6's measured grid, "
          f"StableLM-3B, per site (surrogate / analytic): " + ", ".join(
              f"{k} {rho['surrogate'][k]:.3f}/{rho['analytic'][k]:.3f}"
              for k in rho["surrogate"]) + f"; mean surrogate "
          f"{means['surrogate']:.4f}, analytic {means['analytic']:.4f}",
          flush=True)
    # (c) the pruned brute-force fit at full width
    db = ROOT / "build" / "pruned_measure.jsonl"
    db.unlink(missing_ok=True)
    res, counts, _ = measured_path(
        STABLELM, agent="brute",
        extra=("--measure-db", str(db), "--prune-topk", str(PRUNE_TOPK),
               "--surrogate", str(ckpt)), eager=sl["eager"])
    tun = res.tuning
    timed = tun["stats"]["transport_timed_pairs_total"]
    over = {k: p["n_timed"] for k, p in tun["picks"].items()
            if p["n_timed"] > PRUNE_TOPK + 1}
    if timed >= sl["ref_pairs"] or tun["pruned_pairs"] == 0 or over:
        fail(f"surrogate: the pruned fit timed {timed} pairs (full "
             f"{sl['ref_pairs']}), priced {tun['pruned_pairs']}, sites "
             f"over {PRUNE_TOPK + 1}: {over}")
    full = TileProgram(dict(sl["brute_tiles"]))
    match = {f"{s.site}@m{s.m}": tuple(res.prog.tiles[s.key()])
             == tuple(full.tiles[s.key()]) for s in sites}
    eager_logits = sl["eager"]["logits"]
    rel = float((res.prefill_logits - eager_logits).abs().max()
                / eager_logits.abs().max())
    retimed = retime_programs(sites, {"full": full, "pruned": res.prog})
    out["pruned"] = {
        "topk": PRUNE_TOPK, "timed": timed, "full_timed": sl["ref_pairs"],
        "priced": tun["pruned_pairs"], "fit_s": tun["fit_s"],
        "setup_s": tun["oracle_setup_s"], "best_tile_matches": sum(
            match.values()), "sites": len(sites), "match_by_site": match,
        "speedup_own_timings": res.modelled_speedup,
        "retimed_speedup": retimed, "prefill_ms": res.prefill_ms,
        "prefill_ms_runs": res.prefill_ms_runs, "logits_rel": rel}
    print(f"[surrogate] pruned brute force (top-{PRUNE_TOPK}): {timed} "
          f"pairs timed against phase 6's {sl['ref_pairs']}, "
          f"{tun['pruned_pairs']} surrogate-priced, fit and tune "
          f"{tun['fit_s']:.2f} s (oracle setup {tun['oracle_setup_s']:.2f} "
          f"s); best tile as full brute force's at {sum(match.values())} "
          f"of {len(sites)} sites; re-timed interleaved in this process "
          f"({RETIME_ROUNDS} rounds): pruned pick {retimed['pruned']:.3f}x, "
          f"full pick {retimed['full']:.3f}x over the baseline tiles "
          f"(by its own timings {res.modelled_speedup:.3f}x); injected "
          f"prefill {res.prefill_ms:.2f} ms, logits {rel:.4e} off eager "
          f"(tol {LOGIT_TOL})", flush=True)
    del res
    torch.cuda.empty_cache()
    # (d) PPO against the surrogate oracle, priced by phase 6's timings
    corpus_sites = dataset.generate(LOOP_CORPUS, seed=0, base=sites)
    t0 = time.perf_counter()
    with NeuroVectorizer(NeuroVecConfig(**LOOP_NV), agent="ppo",
                         oracle="surrogate", surrogate=str(ckpt),
                         lr=LOOP_LR, seed=0) as nv:
        nv.fit(corpus_sites, total_steps=LOOP_STEPS)
        prog = nv.tune_sites(sites)
        sur_sp = nv.speedup(prog, sites)
    fit_s = time.perf_counter() - t0
    menv = make_measured_env(DEFAULT, db_path=str(sl["db"]), device="cuda",
                             legality="h100")
    ppo_sp = program_speedup(prog, sites, menv)
    st = menv.measure_fn.transport.stats()
    menv.measure_fn.transport.close()
    out["ppo_surrogate"] = {
        "fit_s": fit_s, "surrogate_speedup": sur_sp,
        "measured_speedup": ppo_sp,
        "ppo_cost_model_measured_speedup": sl["ppo_measured_speedup"],
        "brute_measured_speedup": sl["brute_measured_speedup"],
        "timed_anew": st["transport_timed_pairs_total"]}
    print(f"[surrogate] PPO ({LOOP_STEPS} steps on the corpus) against "
          f"oracle='surrogate': fit and tune {fit_s:.1f} s, surrogate-"
          f"priced speedup {sur_sp:.3f}x; measured on the H100 (phase 6's "
          f"timings, {st['transport_timed_pairs_total']} pairs timed anew) "
          f"{ppo_sp:.3f}x, beside PPO on the cost model "
          f"{sl['ppo_measured_speedup']:.3f}x and brute force "
          f"{sl['brute_measured_speedup']:.3f}x; tiles: " + ", ".join(
              f"{s.site}@M={s.m}:{tuple(prog.tiles[s.key()])}"
              for s in sites), flush=True)
    torch.cuda.empty_cache()
    return counts, out


# ---------------------------------------------------------------------------
# phase 11: the train path
# ---------------------------------------------------------------------------

TRAIN_STEPS = 5             # launch.train --full steps at batch 4, seq 512
TRAIN_LOSS_RTOL = 5e-3      # injected vs eager train loss, the reference's
                            # tolerance (tests/test_system.py) for bf16
RESTART_RTOL = 1e-4         # resumed vs uninterrupted losses (the
                            # reference's test_trainer_restart_reproduces_loss)
RESTART_LAYERS = 2          # depth of the restart and accum runs: full
                            # width, about 4.2 GB a checkpoint
TRAIN_LOGIT_TOL = LOGIT_TOL  # injected vs eager logits of the train
                            # forward over max |eager logit|, every position
ACCUM_RTOL = 1e-4           # accum 2 vs accum 1, one step at depth
ACCUM_GNORM_RTOL = 1e-3     # RESTART_LAYERS: the loss, the grad norm, and
ACCUM_GRAD_RTOL = 2e-2      # each leaf's ||g2 - g1|| / ||g1||: accum 1's
                            # gradients are bf16, accum 2's two bf16 halves
                            # summed in f32; a step that saw half the
                            # batch is off by O(1)


def _train_argv(*extra):
    return ["--arch", STABLELM, "--full", "--batch", str(BATCH), "--seq",
            str(PROMPT), *extra]


def _cut_depth(n_layers):
    """StableLM-3B at its published widths with ``n_layers`` layers."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(STABLELM), n_layers=n_layers)


def _step_dir(ckpt, step):
    """A checkpoint's directory in ``CheckpointManager``'s on-disk layout."""
    return ckpt / f"step_{step:09d}"


def accum_check(cfg, batch):
    """One train step of ``cfg`` from the same weights (seed 0) at accum 1
    and at accum 2: the loss, the grad norm, and the gradients the
    optimizer gets, taken where the compressor hooks in."""
    import torch
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adamw import AdamWConfig, _leaves
    from repro_torch.train.steps import make_train_state, make_train_step
    runs = {}
    for accum in (1, 2):        # one at a time: a run's peak is its own
        held = torch.cuda.memory_allocated()    # the other run's gradients
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg)
        state = make_train_state(model, 0, AdamWConfig(), device="cuda")
        kept = {}

        def keep(grads):
            kept["grads"] = grads
            return grads, {}
        _, m = make_train_step(model, AdamWConfig(), accum=accum,
                               compression=keep)(state, batch)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        runs[accum] = (float(m["loss"]), float(m["grad_norm"]),
                       [g.float() for g in _leaves(kept["grads"])], peak)
        del model, state, kept, m
        torch.cuda.empty_cache()
    (l1, g1, gs1, m1), (l2, g2, gs2, m2) = runs[1], runs[2]
    leaf_rel = [float((b - a).norm() / a.norm()) for a, b in zip(gs1, gs2)]
    worst = max(range(len(leaf_rel)), key=leaf_rel.__getitem__)
    rec = {"loss_rel": abs(l2 - l1) / abs(l1), "gnorm_rel": abs(g2 - g1) / g1,
           "grad_rel_max": leaf_rel[worst], "grad_rel_worst_leaf": worst,
           "grad_rel_median": sorted(leaf_rel)[len(leaf_rel) // 2],
           "peak_gib": {1: m1, 2: m2}}
    print(f"[train] accum 2 vs 1 at depth {cfg.n_layers}: loss {l2:.6f} vs "
          f"{l1:.6f} (relative {rec['loss_rel']:.2e}, tol {ACCUM_RTOL}); "
          f"grad norm {g2:.6f} vs {g1:.6f} (relative {rec['gnorm_rel']:.2e}, "
          f"tol {ACCUM_GNORM_RTOL}); gradients, ||g2 - g1|| / ||g1|| by "
          f"leaf: largest {rec['grad_rel_max']:.2e} (leaf {worst} of "
          f"{len(leaf_rel)}), median {rec['grad_rel_median']:.2e} (tol "
          f"{ACCUM_GRAD_RTOL}); peak memory {m2:.2f} / {m1:.2f} GiB",
          flush=True)
    if rec["loss_rel"] >= ACCUM_RTOL or rec["gnorm_rel"] >= ACCUM_GNORM_RTOL \
            or not rec["grad_rel_max"] < ACCUM_GRAD_RTOL:
        fail(f"train: accum 2 vs accum 1: {rec}")
    return rec


def attention_backward_ms(cfg, gen):
    """One layer's memory-efficient attention at the train shape (batch 4,
    seq 512, causal, bf16), the port's autograd ``Function`` (plain
    PyTorch in the reference's op order; no kernel has a backward): the
    forward's ms and the forward and backward's, beside one
    ``scaled_dot_product_attention`` call's (a yardstick only)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import compute
    shape = (BATCH, cfg.n_heads, PROMPT, cfg.head_dim)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    qkv = [t.requires_grad_(True) for t in (q, k, v)]
    scale = cfg.head_dim ** -0.5

    def mea():
        return compute._mem_efficient_attention(*qkv, causal=True,
                                                scale=scale, bq=PROMPT,
                                                bkv=PROMPT)

    def sdpa():
        return F.scaled_dot_product_attention(*qkv, is_causal=True)

    rec = {}
    for name, fn in (("plain", mea), ("sdpa", sdpa)):
        with torch.no_grad():
            rec[f"{name}_fwd_ms"] = time_ms_over(fn, [()], reps=5, calls=10)
        rec[f"{name}_fwd_bwd_ms"] = time_ms_over(
            lambda: torch.autograd.grad(fn(), qkv, do), [()], reps=5,
            calls=10)
    rec["layers"] = cfg.n_layers
    print(f"[train] attention at the train shape {shape}, causal, one "
          f"layer: the port's Function forward {rec['plain_fwd_ms']:.3f} ms, "
          f"forward+backward {rec['plain_fwd_bwd_ms']:.3f} ms; SDPA forward "
          f"{rec['sdpa_fwd_ms']:.3f} ms, forward+backward "
          f"{rec['sdpa_fwd_bwd_ms']:.3f} ms; x {cfg.n_layers} layers: "
          f"{rec['plain_fwd_bwd_ms'] * cfg.n_layers:.1f} ms against SDPA's "
          f"{rec['sdpa_fwd_bwd_ms'] * cfg.n_layers:.1f}", flush=True)
    return rec


def train_path(sl, gen):
    """The train path on the full-width StableLM-3B (32 layers, bf16): (a)
    its train sites at batch 4, seq 512 tuned by brute force against phase
    6's timing DB (pairs it lacks timed now); (b) the program injected
    into ``train_loss`` under ``no_grad`` (counters zeroed just before,
    read just after): K1's and K2's launches by variant, the loss within
    TRAIN_LOSS_RTOL of eager mode's, the forward's logits at every
    position within TRAIN_LOGIT_TOL of eager's, and K1 at the train
    ``lm_head`` (2048x50304x2560, ``head.T``) against its bound and
    ``torch.matmul``; (c) kernel mode with grad must raise; (d)
    ``launch.train --full`` for TRAIN_STEPS steps: ms a step (CUDA events,
    forward + backward and optimizer apart), tokens/s, the losses, finite
    grad norms, peak memory, and one more step's device busy and idle
    share under ``torch.profiler``; (e) at depth RESTART_LAYERS: 6 steps
    with a checkpoint every 2, the steps above 4 dropped, a resume whose
    losses match within RESTART_RTOL, one save's bytes and seconds; accum
    2 against accum 1 (``accum_check``).  Returns the injected forward's
    counts and the record for the kernels line and the summary."""
    import shutil

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.core.agents import BruteForceAgent
    from repro_torch.core.costmodel import baseline_tiles
    from repro_torch.core.extractor import extract_arch_sites
    from repro_torch.core.vectorizer import (baseline_program, inject,
                                             program_speedup, tune)
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.launch import train
    from repro_torch.measure import make_measured_env
    from repro_torch.models import compute
    from repro_torch.models.lm import build_model, forward
    from repro_torch.optim.adamw import AdamWConfig, _leaves
    from repro_torch.train.steps import make_train_step
    out = {}
    torch.cuda.empty_cache()
    print(f"[train] resident before the phase: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

    # (a) the train sites, tuned by brute force against phase 6's DB (the
    # baseline tiles where there is none)
    sites = extract_arch_sites(STABLELM, batch=BATCH, seq=PROMPT)
    if Path(sl["db"]).exists():
        menv = make_measured_env(DEFAULT, db_path=str(sl["db"]),
                                 device="cuda", legality="h100")
        t0 = time.perf_counter()
        prog = tune(sites, BruteForceAgent().fit(sites, menv), menv.space,
                    menv)
        st = menv.measure_fn.transport.stats()
        out["tune_s"] = time.perf_counter() - t0
        out["measured_speedup"] = program_speedup(prog, sites, menv)
        menv.measure_fn.transport.close()
        out["db_hits"] = st["transport_hits_total"]
        out["timed_pairs"] = st["transport_timed_pairs_total"]
        how = (f"brute force against phase 6's DB: {out['db_hits']} DB "
               f"hits, {out['timed_pairs']} pairs timed anew, "
               f"{out['tune_s']:.1f} s; measured speedup over the baseline "
               f"tiles {out['measured_speedup']:.3f}x")
    else:
        prog, how = baseline_program(sites), f"no DB at {sl['db']}: baseline"
    print(f"[train] {len(sites)} train sites at batch {BATCH}, seq {PROMPT}; "
          f"{how}; tiles: " + ", ".join(
              f"{x.site}@M={x.m}:{tuple(prog.tiles[x.key()])}"
              for x in sites), flush=True)

    # (b) the program injected into the forward of train_loss
    cfg = get_config(STABLELM)
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    pipe = SyntheticPipeline(cfg, ShapeConfig("t", PROMPT, BATCH, "train"),
                             DataConfig(seed=0), device="cuda")
    batch = pipe.batch_at(0)
    with torch.no_grad():
        eager, _ = model.train_loss(params, batch)
        zero_counts()
        with inject(prog):
            tuned, _ = model.train_loss(params, batch)
        torch.cuda.synchronize()
        counts = read_counts()
    want = {"matmul": 1 + 7 * cfg.n_layers, "flash_attention": cfg.n_layers,
            "chunk_scan": 0}
    rel = abs(float(tuned) - float(eager)) / abs(float(eager))
    print(f"[train] injected train_loss (no_grad): launches {counts} "
          f"(want {want}); loss {float(tuned):.6f} against eager "
          f"{float(eager):.6f}, relative {rel:.3e} (tol "
          f"{TRAIN_LOSS_RTOL})", flush=True)
    if counts != want or not torch.isfinite(tuned) or \
            rel >= TRAIN_LOSS_RTOL:
        fail(f"train: injected loss {float(tuned)} vs eager "
             f"{float(eager)} ({rel:.3e}), launches {counts} != {want}")
    path_variants("train:injected", counts)
    out["loss_rel_err"] = rel

    def logits():       # the train forward's, at every position
        x, _, _ = forward(cfg, params, batch)
        return compute.matmul(x, params["head"].T, site="lm_head").float()
    with torch.no_grad():
        eager_logits = logits()
        with inject(prog):
            tuned_logits = logits()
        lrel = float((tuned_logits - eager_logits).abs().max()
                     / eager_logits.abs().max())
        finite = bool(torch.isfinite(tuned_logits).all())
    del eager_logits, tuned_logits
    print(f"[train] injected train forward's logits "
          f"{(BATCH, PROMPT, cfg.vocab_size)} against eager: max "
          f"|difference| over max |eager logit| "
          f"{lrel:.4e} (tol {TRAIN_LOGIT_TOL})", flush=True)
    if not finite or lrel >= TRAIN_LOGIT_TOL:
        fail(f"train: injected forward's logits differ from eager's: "
             f"{lrel:.3e}")
    out["logits_rel_err"] = lrel

    # (c) kernel mode refuses autograd on the card
    for p in _leaves(params):
        p.requires_grad_(True)
    try:
        with inject(prog):
            model.train_loss(params, batch)
        fail("train: kernel mode under autograd did not raise")
    except NotImplementedError as e:
        print(f"[train] kernel mode under autograd raises: {e}", flush=True)
    del params, batch, eager, tuned
    torch.cuda.empty_cache()
    out["attention"] = attention_backward_ms(cfg, gen)
    head = next(x for x in sites if x.site == "lm_head")
    shape = (head.m, head.n, head.k, True)
    out["lm_head"] = {"baseline": k1_check(shape, baseline_tiles(head),
                                           "train baseline:lm_head", gen),
                      "tuned": k1_check(shape, prog.tiles[head.key()],
                                        "train tuned:lm_head", gen)}

    # (d) launch.train at full depth
    argv = _train_argv("--steps", str(TRAIN_STEPS))
    print(f"[train] launch.train.run({argv}) (full depth: {cfg.n_layers} "
          f"layers)", flush=True)
    res = train.run(train.parse_args(argv))
    if len(res.losses) != TRAIN_STEPS or not all(
            map(math.isfinite, res.losses + res.grad_norms)):
        fail(f"train: losses {res.losses}, grad norms {res.grad_norms}")
    fb, opt = res.fwd_bwd_ms, res.optimizer_ms
    out.update(steps=TRAIN_STEPS, losses=res.losses,
               grad_norms=res.grad_norms, step_ms=res.step_ms,
               fwd_bwd_ms=fb, optimizer_ms=opt,
               tokens_s=BATCH * PROMPT / ((fb + opt) / 1e3),
               peak_gib=res.peak_bytes / 2**30)
    # one more step on the trained state (the optimizer's settings do not
    # change its work)
    step_fn = make_train_step(model, AdamWConfig())
    batch = pipe.batch_at(TRAIN_STEPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(res.state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, top = busy_by_kernel(prof, 8)
    out.update(profiled_wall_ms=wall, busy_ms=busy,
               idle_share=max(0.0, 1 - busy / wall), top=top)
    print(f"[train] full width: ms a step (median of {len(res.step_ms) - 1} "
          f"after the first, CUDA events): forward+backward {fb:.2f}, "
          f"optimizer {opt:.2f}; {out['tokens_s']:.0f} tokens/s; losses "
          f"{[round(x, 4) for x in res.losses]}; grad norms "
          f"{[round(x, 4) for x in res.grad_norms]}; peak memory "
          f"{out['peak_gib']:.2f} GiB; profiled step: wall {wall:.2f} ms, "
          f"device busy {busy:.2f} ms, idle "
          f"{out['idle_share'] * 100:.1f}%; top device ms: " + ", ".join(
              f"{k} {v:.2f}" for k, v in top), flush=True)
    del res, batch, prof, step_fn
    torch.cuda.empty_cache()

    # (e) restart and accumulation at full width, depth RESTART_LAYERS
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = _train_argv("--steps", "6", "--ckpt-dir", str(ckpt),
                       "--ckpt-every", "2")
    cut = _cut_depth(RESTART_LAYERS)
    full = train.run(train.parse_args(argv), cfg=cut).losses
    mgr = CheckpointManager(str(ckpt))
    for step in mgr.complete_steps():
        if step > 4:
            shutil.rmtree(_step_dir(ckpt, step))
    resumed = train.run(train.parse_args(argv), cfg=cut)
    if resumed.start_step != 4 or len(resumed.losses) != 2 or any(
            abs(a - b) > RESTART_RTOL * abs(b)
            for a, b in zip(resumed.losses, full[4:])):
        fail(f"train: resumed at {resumed.start_step} with "
             f"{resumed.losses}, uninterrupted {full[4:]}")
    t0 = time.perf_counter()
    mgr.save(resumed.state, 99)
    save_s = time.perf_counter() - t0
    sdir = _step_dir(ckpt, 99)
    save_bytes = sum(f.stat().st_size for f in sdir.iterdir())
    shutil.rmtree(ckpt)
    print(f"[train] restart at depth {RESTART_LAYERS}: losses "
          f"{[round(x, 6) for x in full]}, resumed from step 4 "
          f"{[round(x, 6) for x in resumed.losses]} (rtol {RESTART_RTOL}); "
          f"a save: {save_bytes / 1e9:.3f} GB in {save_s:.2f} s "
          f"(host copy and write)", flush=True)
    out.update(restart_losses=full, resumed_losses=resumed.losses,
               save_bytes=save_bytes, save_s=save_s)
    del resumed
    torch.cuda.empty_cache()
    out["accum"] = accum_check(
        cut, SyntheticPipeline(cut, ShapeConfig("t", PROMPT, BATCH, "train"),
                               DataConfig(seed=0), device="cuda").batch_at(0))
    return counts, out


# ---------------------------------------------------------------------------
# phases 3 and 12: the seven archs phase 12 serves
# ---------------------------------------------------------------------------

class CountingRecorder:
    """A site recorder that also counts the calls of each site."""

    def __init__(self):
        from repro_torch.models.compute import SiteRecorder
        self.rec, self.n = SiteRecorder(), {}

    def record(self, s):
        self.rec.record(s)
        self.n[s.key()] = self.n.get(s.key(), 0) + 1


def pass_site_counts(model):
    """The serve's sites and how often one prefill and one decode step
    call each, on ``meta`` tensors: ``(sites, prefill counts, decode
    counts)``, counts by site key."""
    import torch
    from repro_torch.core.extractor import META, serve_batch, serve_ctx
    from repro_torch.models import compute
    from repro_torch.train.steps import make_prefill_step, make_serve_step
    params = model.init(device=META)
    cache = model.make_cache(BATCH, serve_ctx(model.cfg, PROMPT, GEN),
                             device=META)
    prompts = torch.empty((BATCH, PROMPT), dtype=torch.long, device=META)
    sites, counts = {}, []
    for step, args in (
            (make_prefill_step(model), (serve_batch(model.cfg, prompts),)),
            (make_serve_step(model),
             (torch.empty((BATCH, 1), dtype=torch.long, device=META), 0))):
        rec = CountingRecorder()
        with compute.compute_mode("eager", recorder=rec), torch.no_grad():
            step(params, *args, cache)
        counts.append(rec.n)
        sites.update((s.key(), s) for s in rec.rec.unique_sites())
    return list(sites.values()), counts[0], counts[1]


def k2_inputs(cfg, site, gen):
    """q, k, v of an attention site in the layout the model passes them:
    q and k contiguous after RoPE, v the transposed view of its
    projection; without RoPE (or at the cross-attention) all three the
    transposed views.  MLA: q and k the contiguous concatenations at D =
    qk_nope + qk_rope, v the up-projection's view at v_head_dim."""
    import torch
    B, H, Hkv, D = BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Dv = D
    if cfg.mla:
        D, Dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim

    def view(h, s_, d=D):
        return torch.randn((B, s_, h, d), generator=gen,
                           device="cuda").bfloat16().transpose(1, 2)

    def contig(h, s_):
        return torch.randn((B, h, s_, D), generator=gen,
                           device="cuda").bfloat16()
    rot = cfg.rope != "none" and not site.site.startswith("xattn")
    mk = contig if rot else view
    return mk(H, site.m), mk(Hkv, site.k), view(Hkv, site.k, Dv)


def k2_key(cfg, site):
    return (cfg.n_heads, cfg.n_kv_heads, site.m, site.k, site.n,
            bool(site.causal))


def k2_phase3_tile(site, base):
    """The baseline tile, clamped to the sequence; where it does not
    divide the sequence (Phi-3's 768 positions against the baseline's 512
    keys: the reference's kernel refuses it too) the largest legal key
    block below it at the same query block."""
    from repro_torch.configs.neurovec import DEFAULT as NV
    from repro_torch.kernels import ops
    t = tuple(min(a, b) for a, b in zip(base, (site.m, site.k)))
    if ops.attention_tiles_legal(site.m, site.k, site.n, *t):
        return t
    legal = [min(b, site.k) for b in NV.bkv_choices
             if min(b, site.k) <= t[1] and
             ops.attention_tiles_legal(site.m, site.k, site.n, t[0], b)]
    print(f"[k2] {site.key()}: the baseline tile {t} does not divide the "
          f"sequence; checked at {(t[0], max(legal))}", flush=True)
    return t[0], max(legal)


def phase12_kernel_checks(gen, k1_seen):
    """Phase 3 at the phase-12 archs' serve shapes (at the depth they are
    served at): K1 under the baseline tile at every bf16 matmul shape not
    checked before (``k1_seen``) and its f32 variant at each f32 one (the
    MoE router), K2 at each (Hq, Hkv, Sq, Skv, D, causal) of their
    prefill attention at its baseline tile, in the served layout.
    Returns per arch the records and how often one prefill and one decode
    step launch each (their sum held against ``per_pass_launches``)."""
    from repro_torch.core.costmodel import baseline_tiles
    from repro_torch.models.lm import build_model
    out = {}
    for arch in PHASE12_ARCHS:
        cfg = served_cfg(arch)
        sites, n_pre, n_dec = pass_site_counts(build_model(cfg))
        want_pre, want_dec = per_pass_launches(cfg)
        k1_w, k2_w, f32_w = {}, {}, {}
        for s in sites:
            if s.kind == "matmul":
                shape = (s.m, s.n, s.k, s.site == "lm_head")
                w = f32_w if s.dtype == "float32" else k1_w
                w[shape] = (w.get(shape, 0) + n_pre.get(s.key(), 0)
                            + n_dec.get(s.key(), 0))
            elif s.kind == "attention" and s.m > 1:
                k2_w[k2_key(cfg, s)] = (k2_w.get(k2_key(cfg, s), 0)
                                        + n_pre.get(s.key(), 0))
        got = (sum(n for k, n in n_pre.items() if k.startswith("matmul")),
               sum(n for k, n in n_dec.items() if k.startswith("matmul")),
               sum(k2_w.values()))
        want = (want_pre["matmul"], want_dec["matmul"] // (GEN - 1),
                want_pre["flash_attention"])
        if got != want:
            fail(f"{arch}: a pass calls (K1 prefill, K1 decode, K2) {got} "
                 f"times, per_pass_launches says {want}")
        k1, k2, k1f = {}, {}, {}
        for s in sites:
            if s.kind == "matmul" and s.dtype == "float32":
                shape = (s.m, s.n, s.k, s.site == "lm_head")
                k1f[shape] = k1_f32_check(shape, baseline_tiles(s),
                                          f"{arch} baseline:{s.site}", gen)
            elif s.kind == "matmul":
                shape = (s.m, s.n, s.k, s.site == "lm_head")
                if shape in k1_seen:
                    k1[shape] = k1_seen[shape]
                elif shape not in k1:
                    k1[shape] = k1_check(shape, baseline_tiles(s),
                                         f"{arch} baseline:{s.site}", gen)
            elif s.kind == "attention" and s.m > 1 and \
                    k2_key(cfg, s) not in k2:
                q, k, v = k2_inputs(cfg, s, gen)
                t = k2_phase3_tile(s, baseline_tiles(s)[:2])
                k2[k2_key(cfg, s)] = dict(
                    k2_line(f"{arch} {s.site}", q, k, v, t,
                            causal=bool(s.causal)), tiles=t)
                del q, k, v
        k1_seen.update(k1)
        out[arch] = {"k1": k1, "k1_launches": k1_w, "k2": k2,
                     "k2_launches": k2_w, "k1_f32": k1f,
                     "k1_f32_launches": f32_w}
    return out


def init_seconds(arch):
    """The seed-0 init of ``arch`` on the card at its published widths and
    the depth it is served at (``served_cfg``): (params, seconds,
    parameters, config)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adamw import _leaves
    cfg = served_cfg(arch)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = sum(t.numel() for t in _leaves(params))
    size = sum(t.numel() * t.element_size() for t in _leaves(params))
    depth = ("full depth" if cfg.n_layers == get_config(arch).n_layers
             else f"cut to {cfg.n_layers} of {get_config(arch).n_layers} "
                  f"layers")
    print(f"[init] {arch}: seed-0 weights at full width, {depth}, on the "
          f"card in {dt:.2f} s ({n / 1e9:.3f} B parameters, "
          f"{size / 1e9:.2f} GB; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)", flush=True)
    return params, dt, n, cfg


class RouteTap:
    """Within ``with``: the experts each MoE layer's router picks for the
    tokens of the first prefill it sees, ``(T, K)`` on the host, one a
    layer in layer order (``models.moe.route`` wrapped; its result is
    passed through untouched)."""

    def __init__(self, n_layers: int, n_tokens: int):
        self.n, self.T, self.eidx = n_layers, n_tokens, []

    def __enter__(self):
        from repro_torch.models import moe
        self._route = route = moe.route

        def tapped(cfg, logits):
            out = route(cfg, logits)
            if logits.device.type != "meta" and \
                    logits.shape[0] == self.T and len(self.eidx) < self.n:
                self.eidx.append(out[0].cpu())
            return out
        moe.route = tapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._route


def routing_agreement(cfg, eager_tap, kernel_tap, logits, el,
                      batch=BATCH, prompt=PROMPT, tag="serve12"):
    """Per MoE layer, the share of (token, slot) choices the injected
    prefill shares with eager's; the batch rows whose tokens kept every
    choice in every layer, and the prefill logits' distance over those
    rows (held at LOGIT_TOL) and over all rows (reported)."""
    import torch
    if not eager_tap.eidx:
        return {}
    if len(eager_tap.eidx) != len(kernel_tap.eidx) or \
            len(eager_tap.eidx) != eager_tap.n:
        fail(f"{cfg.name}: tapped {len(eager_tap.eidx)} / "
             f"{len(kernel_tap.eidx)} MoE layers, want {eager_tap.n}")
    same = [(a == b) for a, b in zip(eager_tap.eidx, kernel_tap.eidx)]
    share = [float(m.float().mean()) for m in same]
    kept = torch.stack([m.reshape(batch, prompt, -1).all(-1).all(-1)
                        for m in same]).all(0)          # (B,)
    scale = float(el.abs().max())
    row_rel = [float((logits[b] - el[b]).abs().max()) / scale
               for b in range(batch)]
    kept_rel = max([r for r, k in zip(row_rel, kept.tolist()) if k],
                   default=None)
    print(f"[{tag}:{cfg.name}] routing, injected vs eager prefill: "
          f"(token, slot) choices that agree by MoE layer "
          f"{[round(x, 5) for x in share]}; {int(kept.sum())} of {batch} "
          f"rows kept every choice; logits off eager's over max |eager "
          f"logit| by row {[f'{r:.3e}' for r in row_rel]} (rows that kept "
          f"their choices held at {LOGIT_TOL}"
          f"{'' if kept_rel is None else f', worst {kept_rel:.3e}'}; a "
          f"flipped row is reported, not held)", flush=True)
    if kept_rel is not None and kept_rel >= LOGIT_TOL:
        fail(f"{cfg.name}: rows that kept their routing lie {kept_rel:.3e} "
             f"off eager's logits")
    return {"route_agree_by_layer": share, "rows_kept": int(kept.sum()),
            "logits_rel_by_row": row_rel, "logits_rel_kept_rows": kept_rel}


def serve_arch(arch, params, checked, gen, cfg):
    """Phase 12 for one arch at full width and the depth ``cfg`` has,
    batch 4, prompt 512, 16 tokens, seed-0 weights: serve eager, then
    --autotune ppo --inject against the cost model (legality h100), with
    the counters zeroed just before and read just after the injected run.
    Fails on launch counts other than a pass's (K1's f32 variant: one
    router matmul a MoE layer a pass), an unaligned variant, a tuned tile
    that cannot launch, or injected prefill logits farther than LOGIT_TOL
    from eager's (over their largest); with MoE layers only the batch
    rows whose tokens kept every routing choice are held, and the
    agreement is printed.  K1 and K2 are held against their plain
    versions at each tuned tile that phase 3 did not check (``checked``:
    its records of the arch, under the baseline tiles), K1 in f32 against
    the f32 product at K1_F32_TOL."""
    import torch
    from repro_torch.core.costmodel import baseline_tiles
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    base = ["--arch", arch, "--full", "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN)]
    n_moe = sum(b.mlp == "moe" for b in cfg.period) * cfg.n_periods
    zero_counts()
    with RouteTap(n_moe, BATCH * PROMPT) as eager_tap:
        eager = serve.run(serve.parse_args(base), params=params, cfg=cfg)
    if any(read_counts().values()):
        fail(f"{arch}: the eager serve launched {read_counts()}")
    argv = base + ["--autotune", "ppo", "--autotune-steps", str(STEPS_12),
                   "--inject"]
    print(f"[serve12] serve.run({argv}, cfg={cfg.n_layers} layers)",
          flush=True)
    zero_counts()
    t0 = time.perf_counter()
    with RouteTap(n_moe, BATCH * PROMPT) as kernel_tap:
        res = serve.run(serve.parse_args(argv), params=params,
                        prompts=eager.prompts, cfg=cfg)
    wall = time.perf_counter() - t0
    counts = read_counts()
    want_pre, want_dec = per_pass_launches(cfg)
    if res.launches != {"prefill": want_pre, "decode": want_dec}:
        fail(f"{arch}: launch counts by pass {res.launches}")
    n_pre = 1 + len(res.prefill_ms_runs)
    n_dec = 1 + len(res.decode_tok_s_runs)
    total = {k: res.tuning["launches"][k] + want_pre[k] * n_pre
             + want_dec[k] * n_dec for k in counts}
    if counts != total or counts["matmul"] == 0 or \
            counts["flash_attention"] == 0:
        fail(f"{arch}: total launch counts {counts} != {total}")
    path_variants(f"serve12:{arch}", counts)
    f32_want = n_moe * (n_pre + n_dec * (GEN - 1))
    if kmm.launches_by_variant["f32"] != f32_want:
        fail(f"{arch}: {kmm.launches_by_variant['f32']} launches of K1's "
             f"f32 variant, want {f32_want} (one router matmul a MoE layer "
             f"a pass)")
    bad = [s.key() for s in res.sites
           if not ops.tile_ok(s, res.prog.tiles[s.key()])]
    if bad:
        fail(f"{arch}: tuned tiles that cannot launch: {bad}")
    logits, el = res.prefill_logits, eager.prefill_logits
    if logits.shape != (BATCH, cfg.vocab_size) or \
            not torch.isfinite(logits).all() or \
            res.seq.shape != (BATCH, GEN):
        fail(f"{arch}: logits {tuple(logits.shape)} / tokens "
             f"{tuple(res.seq.shape)}")
    rel = float((logits - el).abs().max() / el.abs().max())
    agree = float((res.seq == eager.seq).float().mean())
    print(f"[serve12:{arch}] {cfg.n_layers} layers; wall {wall:.1f} s (PPO "
          f"{STEPS_12} steps against the cost model included); eager: "
          f"prefill ms {eager.prefill_ms:.2f} of "
          f"{[round(t, 2) for t in eager.prefill_ms_runs]}, decode tok/s "
          f"{eager.decode_tok_s:.2f} of "
          f"{[round(t, 2) for t in eager.decode_tok_s_runs]}; kernels: "
          f"prefill ms {res.prefill_ms:.2f} of "
          f"{[round(t, 2) for t in res.prefill_ms_runs]}, decode tok/s "
          f"{res.decode_tok_s:.2f} of "
          f"{[round(t, 2) for t in res.decode_tok_s_runs]}; "
          f"TPU-v5e-modelled speedup {res.modelled_speedup:.3f}x (cost "
          f"model, not measured); K1 f32 launches {f32_want}", flush=True)
    held = " on the rows that kept their routing" if n_moe else ""
    print(f"[serve12:{arch}] injected vs eager prefill logits: max "
          f"|difference| over max |eager logit| {rel:.4e} (tol "
          f"{LOGIT_TOL}{held}); greedy tokens agree {agree * 100:.1f}%; eager "
          f"tokens {eager.seq.tolist()}; injected tokens "
          f"{res.seq.tolist()}", flush=True)
    print(f"[serve12:{arch}] tuned tiles: " + ", ".join(
        f"{s.site}@M={s.m}:{tuple(res.prog.tiles[s.key()])}"
        for s in res.sites), flush=True)
    routing = routing_agreement(cfg, eager_tap, kernel_tap, logits, el)
    if not n_moe and rel >= LOGIT_TOL:
        fail(f"{arch}: injected prefill logits {rel:.3e} off eager's")
    k1_tuned, k2_tuned = {}, {}
    for s in res.sites:
        if s.kind != "matmul":
            continue
        shape = (s.m, s.n, s.k, s.site == "lm_head")
        t = tuple(res.prog.tiles[s.key()])
        f32 = s.dtype == "float32"
        seen = checked["k1_f32" if f32 else "k1"]
        if (shape, t) in k1_tuned or (shape in seen and
                                      t == tuple(baseline_tiles(s))):
            continue
        r = (k1_f32_agree(shape, t, gen)[2] if f32
             else k1_agree(shape, t, gen)[3])
        k1_tuned[(shape, t)] = r
        print(f"[k1{'f32' if f32 else ''}:{arch} tuned:{s.site}] M={s.m} "
              f"N={s.n} K={s.k}{' wT' if shape[3] else ''} tiles={t} "
              f"variant={r['variant']} rel_err={r['rel']:.2e} |k-plain|="
              f"{r['plain_err']:.3e} !=torch.matmul: {r['n_ne_lib']} of "
              f"{s.m * s.n}", flush=True)
    for s in res.sites:
        if s.kind != "attention" or s.m == 1:
            continue
        t = tuple(min(a, b) for a, b in zip(res.prog.tiles[s.key()][:2],
                                            (s.m, s.k)))
        key = (k2_key(cfg, s), t)
        if checked["k2"].get(k2_key(cfg, s), {}).get("tiles") != t and \
                key not in k2_tuned:
            q, k, v = k2_inputs(cfg, s, gen)
            k2_tuned[key] = k2_line(f"{arch} tuned {s.site}", q, k, v, t,
                                    causal=bool(s.causal))
            del q, k, v
    bf16 = [r for r in k1_tuned.values() if r["variant"] != "f32"]
    f32s = [r for r in k1_tuned.values() if r["variant"] == "f32"]
    out = {"layers": cfg.n_layers, "prefill_ms": res.prefill_ms,
           "eager_prefill_ms": eager.prefill_ms,
           "decode_tok_s": res.decode_tok_s,
           "eager_decode_tok_s": eager.decode_tok_s, "logits_rel": rel,
           "tokens_agree": agree, "wall_s": wall,
           "modelled_speedup": res.modelled_speedup,
           "k1_f32_launches": f32_want, **routing,
           "k1_tuned_checks": len(k1_tuned),
           "k1_tuned_max_abs_err": max([r["err"] for r in bf16],
                                       default=None),
           "k1_tuned_max_rel_err": max([r["rel"] for r in bf16],
                                       default=None),
           "k1_f32_tuned_max_rel_err": max([r["rel"] for r in f32s],
                                           default=None),
           "k2_tuned_max_abs_err": max([r["err"] for r in k2_tuned.values()],
                                       default=None)}
    del res, eager, logits, el
    return counts, out


def serve_phase12(gen, checked):
    """Phase 12: the seed-0 init time of every ported arch at full width
    and the depth it is served at, then the phase-12 archs served one
    after another, the card freed between them."""
    import torch
    from repro_torch.configs import PORTED_ARCHS
    by_path, summary = {}, {}
    for arch in PORTED_ARCHS:
        params, init_s, n, cfg = init_seconds(arch)
        summary[arch] = {"init_s": init_s, "parameters": n,
                         "layers": cfg.n_layers}
        if arch in PHASE12_ARCHS:
            by_path[f"{arch} ppo (cost model)"], rec = serve_arch(
                arch, params, checked[arch], gen, cfg)
            summary[arch].update(rec)
        del params
        torch.cuda.empty_cache()
    return by_path, summary


# ---------------------------------------------------------------------------
# phase 13: the tuning service and the latency-SLO serving layer
# ---------------------------------------------------------------------------

SERVING_STEPS = 300         # PPO steps of a serving-phase fit
N_BRUTE_SESSIONS = 8        # brute/model sessions on one TuningService
REQUESTS_PER_SESSION = 3    # tune_async requests a session's thread submits
REPLAY_REPS = 20            # CUDA-event timings of one fused replay


def _median_ms(fn, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return ts[len(ts) // 2]


def _replay_ms(tuner, reps: int = REPLAY_REPS) -> float:
    """Median device ms of one replay of ``tuner``'s only captured graph
    (CUDA events around each replay)."""
    import torch
    (graph, *_), = tuner._graphs.values()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    ts.sort()
    return ts[len(ts) // 2]


def expected_program(sites, oracle):
    """The brute-force program as the vectorizer assembles it: the argmin
    of ``oracle.cost_grid``, each action's tiles from the action space."""
    from repro_torch.core.agents.brute import brute_force_labels
    from repro_torch.core.vectorizer import TileProgram
    acts = brute_force_labels(oracle, sites)
    return TileProgram({s.key(): tuple(int(t) for t in
                                       oracle.space.tiles(s.kind, a))
                        for s, a in zip(sites, acts)})


def serving_serve(q_eager, k1_done, k2_done, gen):
    """(1) serve --autotune brute --serving --inject on the full-width
    Qwen3-8B, counters zeroed just before and read just after."""
    import torch
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.core.env import CostModelEnv
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--full", "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN), "--autotune", "brute",
            "--serving", "--inject"]
    print(f"[serving] serve.run({argv})", flush=True)
    zero_counts()
    t0 = time.perf_counter()
    res = serve.run(serve.parse_args(argv))
    wall = time.perf_counter() - t0
    counts = read_counts()
    cfg, tun = res.model.cfg, res.tuning
    st = tun["serving"]
    want = expected_program(res.sites, CostModelEnv(DEFAULT,
                                                    legality="h100"))
    if res.prog.tiles != want.tiles:
        diff = {k: (res.prog.tiles.get(k), v) for k, v in want.tiles.items()
                if res.prog.tiles.get(k) != v}
        fail(f"serving: the fused program differs from the host brute "
             f"force under h100 at {diff}")
    bad = [s.key() for s in res.sites
           if not ops.tile_ok(s, res.prog.tiles[s.key()])]
    if bad:
        fail(f"serving: tuned tiles that cannot launch: {bad}")
    if st["serving_fused_dispatches_total"] != 1 or \
            st["serving_fused_traces_total"] != 1 or tun["health"] != "ok":
        fail(f"serving: the tune took {st['serving_fused_dispatches_total']} "
             f"fused dispatches and {st['serving_fused_traces_total']} "
             f"graph captures (want 1 and 1), health {tun['health']}")
    want_pre, want_dec = per_pass_launches(cfg)
    if res.launches != {"prefill": want_pre, "decode": want_dec}:
        fail(f"serving: launch counts by pass {res.launches}")
    n_pre = 1 + len(res.prefill_ms_runs)
    n_dec = 1 + len(res.decode_tok_s_runs)
    total = {k: tun["launches"][k] + want_pre[k] * n_pre + want_dec[k] * n_dec
             for k in counts}
    if counts != total or any(tun["launches"].values()):
        fail(f"serving: total launch counts {counts} != {total} (tuning "
             f"{tun['launches']})")
    path_variants("serving:qwen3_8b:brute", counts)
    logits = res.prefill_logits
    if logits.shape != (BATCH, cfg.vocab_size) or \
            not torch.isfinite(logits).all() or res.seq.shape != (BATCH, GEN):
        fail(f"serving: logits {tuple(logits.shape)} / tokens "
             f"{tuple(res.seq.shape)}")
    rel = float((logits - q_eager["logits"]).abs().max()
                / q_eager["logits"].abs().max())
    agree = float((res.seq == q_eager["seq"]).float().mean())
    if rel >= LOGIT_TOL:
        fail(f"serving: injected prefill logits {rel:.3e} off eager's")
    print(f"[serving:qwen3_8b] launches in the run: {counts}; by pass "
          f"{res.launches}; wall {wall:.1f} s (fit and tune "
          f"{tun['fit_s']:.2f} s); fused dispatches "
          f"{st['serving_fused_dispatches_total']}, graph captures "
          f"{st['serving_fused_traces_total']}, tune p50 "
          f"{st['serving_tune_p50_ms']:.3f} ms, health {tun['health']}; "
          f"program = host brute force under h100 at {len(res.sites)} "
          f"sites; injected vs eager (phase 4) prefill logits relative "
          f"{rel:.4e} (tol {LOGIT_TOL}), greedy tokens agree "
          f"{agree * 100:.1f}%; prefill ms {res.prefill_ms:.2f} of "
          f"{[round(t, 2) for t in res.prefill_ms_runs]}, decode tok/s "
          f"{res.decode_tok_s:.2f} of "
          f"{[round(t, 2) for t in res.decode_tok_s_runs]}; "
          f"TPU-v5e-modelled speedup {res.modelled_speedup:.3f}x (cost "
          f"model, not measured)", flush=True)
    print(f"[serving:qwen3_8b] tuned tiles: " + ", ".join(
        f"{s.site}@M={s.m}:{tuple(res.prog.tiles[s.key()])}"
        for s in res.sites), flush=True)
    # K1 and K2 at each tuned tile no earlier phase held against its
    # plain version
    new_k1, new_k2 = {}, {}
    for s in res.sites:
        t = tuple(res.prog.tiles[s.key()])
        if s.kind == "matmul":
            shape = (s.m, s.n, s.k, s.site == "lm_head")
            if (shape, t) not in k1_done:
                _, _, _, rec = k1_agree(shape, t, gen)
                k1_done.add((shape, t))
                new_k1[f"{s.site}@M={s.m}:{t}"] = rec["rel"]
        elif s.kind == "attention" and s.m > 1:
            t_att = tuple(min(a, b) for a, b in zip(t[:2], (PROMPT, PROMPT)))
            if t_att not in k2_done:
                H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
                q = torch.randn((BATCH, H, PROMPT, D), generator=gen,
                                device="cuda").bfloat16()
                k = torch.randn((BATCH, Hkv, PROMPT, D), generator=gen,
                                device="cuda").bfloat16()
                v = torch.randn((BATCH, Hkv, PROMPT, D), generator=gen,
                                device="cuda").bfloat16()
                y, variant = k2_call(q, k, v, t_att)
                yp = kfa.flash_attention_plain(q, k, v, causal=True,
                                               scale=D ** -0.5,
                                               bq=t_att[0], bkv=t_att[1])
                err = float((y.float() - yp.float()).abs().max())
                if err >= K2_TOL:
                    fail(f"serving: K2 at {t_att}: abs err {err:.3e}")
                k2_done.add(t_att)
                new_k2[str(t_att)] = err
    print(f"[serving:qwen3_8b] K1 at the {len(new_k1)} tuned tiles no "
          f"earlier phase checked (rel err vs the f32 product, tol "
          f"{K1_TOL}): {new_k1}; K2 at {len(new_k2)} new tiles: {new_k2}",
          flush=True)
    out = {"wall_s": wall, "fit_and_tune_s": tun["fit_s"],
           "prefill_ms": res.prefill_ms,
           "prefill_ms_runs": res.prefill_ms_runs,
           "decode_tok_s": res.decode_tok_s,
           "decode_tok_s_runs": res.decode_tok_s_runs,
           "logits_rel": rel, "tokens_agree": agree,
           "fused_dispatches": st["serving_fused_dispatches_total"],
           "graph_captures": st["serving_fused_traces_total"],
           "tune_p50_ms": st["serving_tune_p50_ms"],
           "k1_new_tiles": new_k1, "k2_new_tiles": new_k2,
           "modelled_speedup": res.modelled_speedup}
    sites = res.sites
    del res
    torch.cuda.empty_cache()
    return counts, out, sites


def serving_fused_vs_host(corpus):
    """(2) The fused tuner on the card against the host's brute force over
    the ten-arch corpus, under h100 and tpu_v5e (and the CPU route under
    tpu_v5e); one replay's device ms beside the host argmin's ms."""
    import numpy as np
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.core.agents.brute import brute_force_labels
    from repro_torch.core.env import CostModelEnv
    from repro_torch.serving import FusedTuner
    out = {}
    for leg in ("h100", "tpu_v5e"):
        env = CostModelEnv(DEFAULT, legality=leg)
        tuner = FusedTuner(DEFAULT, legality=leg, device="cuda")
        got = tuner.actions(corpus)
        want = brute_force_labels(env, corpus)
        if not np.array_equal(got, want):
            rows = np.flatnonzero((got != want).any(1))
            fail(f"serving: the fused tuner ({leg}) differs from the host "
                 f"brute force at {[corpus[i].key() for i in rows[:5]]}")
        cpu = None
        if leg == "tpu_v5e":
            cpu = FusedTuner(DEFAULT, legality=leg, device="cpu")
            if not np.array_equal(got, cpu.actions(corpus)):
                fail("serving: the fused tuner on the card differs from its "
                     "CPU route under tpu_v5e")
        call_ms = _median_ms(lambda: tuner.actions(corpus), REPLAY_REPS)
        host_ms = _median_ms(lambda: brute_force_labels(env, corpus),
                             REPLAY_REPS)
        cpu_ms = (_median_ms(lambda: cpu.actions(corpus), REPLAY_REPS)
                  if cpu is not None else None)
        replay = _replay_ms(tuner)
        if tuner.trace_count != 1:
            fail(f"serving: {tuner.trace_count} graph captures for one "
                 f"bucket")
        out[leg] = {"sites": len(corpus), "bucket": tuner.last_padded_batch,
                    "replay_device_ms": replay, "call_ms": call_ms,
                    "host_argmin_ms": host_ms, "cpu_route_ms": cpu_ms}
        print(f"[serving:fused] {leg}: {len(corpus)} corpus sites (bucket "
              f"{tuner.last_padded_batch}) = host brute force"
              f"{' = the CPU route' if cpu is not None else ''}; one "
              f"replay {replay:.4f} device ms (CUDA events, median of "
              f"{REPLAY_REPS}); a whole call (pack, copy, replay, copy) "
              f"{call_ms:.3f} ms; the host grid and argmin {host_ms:.3f} ms"
              + (f"; the CPU route {cpu_ms:.3f} ms" if cpu_ms else ""),
              flush=True)
    return out


def serving_surrogate(sites):
    """(3) The fused surrogate route against SurrogateOracle's brute
    labels, with phase 10's surrogate."""
    import numpy as np
    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.core.agents.brute import brute_force_labels
    from repro_torch.serving import FusedTuner
    from repro_torch.surrogate import SurrogateOracle, load_surrogate
    model = load_surrogate(str(ROOT / "build" / "surrogate_ckpt"),
                           device="cuda")
    oracle = SurrogateOracle(DEFAULT, model, legality="h100")
    tuner = FusedTuner(DEFAULT, surrogate=model, legality="h100",
                       device="cuda")
    got = tuner.actions(sites)
    want = brute_force_labels(oracle, sites)
    if not np.array_equal(got, want):
        rows = np.flatnonzero((got != want).any(1))
        grid = oracle.cost_grid([sites[i] for i in rows])
        fail(f"serving: the fused surrogate route differs from "
             f"SurrogateOracle at {[sites[i].key() for i in rows]} "
             f"(oracle's best two: {np.sort(grid, 1)[:, :2].tolist()})")
    replay = _replay_ms(tuner)
    print(f"[serving:surrogate] phase 10's surrogate (ensemble "
          f"{model.ensemble}) in the fused route = SurrogateOracle's brute "
          f"labels at {len(sites)} sites; one replay {replay:.4f} device ms",
          flush=True)
    return {"sites": len(sites), "replay_device_ms": replay}


def _ppo_logit_spread(agent, sites, bucket):
    """Largest difference of the policy outputs of ``sites`` computed
    alone and in a batch of ``bucket`` rows (cuBLAS picks its algorithm by
    M)."""
    import torch
    ctx, mask, vs = agent.feats(sites)
    pad = bucket - len(sites)
    big = [torch.cat([t, t[:1].expand(pad, *t.shape[1:])])
           for t in (ctx, mask, vs)]
    with torch.no_grad():
        a, _ = agent._forward(ctx, mask, vs)
        b, _ = agent._forward(*big)
    if isinstance(a, list):
        a, b = torch.cat(a, 1), torch.cat(b, 1)[:len(sites)]
    else:
        b = b[:len(sites)]
    ok = a > -1e29
    return float((a - b)[ok].abs().max())


def serving_sessions(corpus, qsites, sl_sites, sl_db, brute_measured):
    """(4) concurrent sessions on one TuningService(serving=True); (5) a
    measured session through AsyncOracle against phase 6's DB; (6) each
    continuous PPO mode fitted and tuned through the server; (7) the
    MetricsServer scraped over localhost."""
    import threading
    import urllib.request

    from repro_torch.configs.neurovec import DEFAULT
    from repro_torch.core.agents import PPOAgent
    from repro_torch.core.env import CostModelEnv
    from repro_torch.core.protocols import AsyncOracle
    from repro_torch.core.vectorizer import program_speedup
    from repro_torch.kernels import ops
    from repro_torch.obs import MetricsRegistry, MetricsServer
    from repro_torch.service import TuningService
    from repro_torch.serving import bucket_size
    out = {}
    reg = MetricsRegistry()
    env = CostModelEnv(DEFAULT, legality="h100")
    with TuningService(DEFAULT, serving={"max_wait_ms": 20.0},
                       device="cuda", metrics=reg) as svc:
        sessions = []
        for i in range(N_BRUTE_SESSIONS):
            s = svc.open_session(agent="brute", oracle="model")
            sessions.append((s, corpus[i::N_BRUTE_SESSIONS]))
        fit_s = {}
        for j, mode in enumerate(("discrete", "cont2")):
            s = svc.open_session(agent=PPOAgent(DEFAULT, mode=mode,
                                                device="cuda"),
                                 oracle="model")
            t0 = time.perf_counter()
            s.fit(qsites, total_steps=SERVING_STEPS)
            fit_s[mode] = time.perf_counter() - t0
            sessions.append((s, corpus[j::2]))
        for s, sl in sessions[:N_BRUTE_SESSIONS]:
            s.fit(sl)
        # each session's solo tune, as it resolves without the server
        solo = {s.name: s._tune(sl).tiles for s, sl in sessions}
        parts = {s.name: [sl[k::REQUESTS_PER_SESSION]
                          for k in range(REQUESTS_PER_SESSION)]
                 for s, sl in sessions}
        order, results, errors = {}, {}, []
        barrier = threading.Barrier(len(sessions))

        def client(sess):
            try:
                barrier.wait()
                futs = []
                for k, p in enumerate(parts[sess.name]):
                    f = sess.tune_async(p, slo_ms=10_000.0)
                    f.add_done_callback(
                        lambda _f, k=k: order.setdefault(sess.name,
                                                         []).append(k))
                    futs.append(f)
                merged = {}
                for f in futs:
                    merged.update(f.result(timeout=300).tiles)
                results[sess.name] = merged
            except Exception as e:
                errors.append(e)
                barrier.abort()

        threads = [threading.Thread(target=client, args=(s,))
                   for s, _ in sessions]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        conc_wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        for s, sl in sessions:
            if results.get(s.name) != solo[s.name]:
                fail(f"serving: session {s.name} ({s.agent.name}) got "
                     f"another program under the server than solo")
            if order.get(s.name) != list(range(REQUESTS_PER_SESSION)):
                fail(f"serving: session {s.name} resolved in order "
                     f"{order.get(s.name)}, not FIFO")
        spread = {s.agent.mode: _ppo_logit_spread(
            s.agent, sl, bucket_size(len(corpus)))
            for s, sl in sessions[N_BRUTE_SESSIONS:]}
        st = svc.server.stats()
        health = svc.health()
        if health != "ok" or st["serving_shed_total"] or \
                st["serving_deadline_misses_total"]:
            fail(f"serving: health {health}, shed "
                 f"{st['serving_shed_total']}, deadline misses "
                 f"{st['serving_deadline_misses_total']}")
        out["concurrent"] = {
            "sessions": len(sessions),
            "requests": st["serving_requests_total"],
            "tune_p50_ms": st["serving_tune_p50_ms"],
            "tune_p99_ms": st["serving_tune_p99_ms"],
            "batches": st["serving_batches_total"],
            "batch_requests_max": st["serving_batch_requests_max"],
            "batch_requests_hist": st["serving_batch_requests_hist"],
            "fused_dispatches": st["serving_fused_dispatches_total"],
            "graph_captures": st["serving_fused_traces_total"],
            "agent_batches": st["serving_agent_batches_total"],
            "health": health, "wall_s": conc_wall,
            "ppo_fit_s": fit_s, "ppo_max_logit_diff_solo_vs_bucket": spread}
        print(f"[serving:sessions] {N_BRUTE_SESSIONS} brute/model sessions "
              f"and 2 PPO sessions (discrete, cont2; {SERVING_STEPS} steps "
              f"on Qwen3-8B's sites, fit {fit_s['discrete']:.2f} s and "
              f"{fit_s['cont2']:.2f} s), {REQUESTS_PER_SESSION} requests "
              f"each from its own thread over its slice of the {len(corpus)}"
              f"-site corpus: every program = the session's solo tune, FIFO "
              f"within each session; serving_tune_p50_ms "
              f"{st['serving_tune_p50_ms']:.3f}, p99 "
              f"{st['serving_tune_p99_ms']:.3f}; {st['serving_batches_total']}"
              f" batches (requests a batch {st['serving_batch_requests_hist']},"
              f" serving_batch_requests_max "
              f"{st['serving_batch_requests_max']}), fused dispatches "
              f"{st['serving_fused_dispatches_total']} (captures "
              f"{st['serving_fused_traces_total']}), agent forwards "
              f"{st['serving_agent_batches_total']}; PPO logits solo vs a "
              f"bucket of {bucket_size(len(corpus))}: largest difference "
              f"{spread}; health {health}; wall {conc_wall:.2f} s",
              flush=True)
        # (6) the continuous modes (and two_agents), each fitted on
        # Qwen3-8B's serve sites and tuned through the AgentBatch route
        modes = {}
        for mode in ("cont1", "cont2", "two_agents"):
            s = svc.open_session(agent=PPOAgent(DEFAULT, mode=mode,
                                                device="cuda"),
                                 oracle="model")
            t0 = time.perf_counter()
            s.fit(qsites, total_steps=SERVING_STEPS)
            fit = time.perf_counter() - t0
            prog = s.tune(qsites)
            bad = [x.key() for x in qsites
                   if not ops.tile_ok(x, prog.tiles[x.key()])]
            if bad:
                fail(f"serving: {mode} tuned tiles that cannot launch: {bad}")
            sp = program_speedup(prog, qsites, env)
            modes[mode] = {"fit_s": fit, "modelled_speedup": sp,
                           "reward_last": s.agent.history[-1]["reward_mean"]}
            print(f"[serving:ppo:{mode}] {SERVING_STEPS} steps on "
                  f"{len(qsites)} Qwen3-8B serve sites against "
                  f"CostModelEnv(h100): fit {fit:.2f} s, tuned through the "
                  f"server (AgentBatch), every tile launches; "
                  f"TPU-v5e-modelled speedup {sp:.3f}x (cost model, not an "
                  f"H100 measurement)", flush=True)
        out["ppo_modes"] = modes
        # (7) the registry over HTTP
        with MetricsServer(port=0, registry=reg) as srv:
            port = srv.port
            text = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=30
            ).read().decode()
        series = sorted({ln.split("{")[0].split(" ")[0]
                         for ln in text.splitlines()
                         if ln.startswith("serving_")})
        need = {"serving_requests_total", "serving_batches_total",
                "serving_fused_dispatches_total", "serving_queue_depth",
                "serving_tune_seconds_count", "serving_health"}
        if not need <= set(series):
            fail(f"serving: the scrape lacks {sorted(need - set(series))}")
        out["metrics_series"] = len(series)
        print(f"[serving:metrics] MetricsServer on 127.0.0.1:{port}: "
              f"{len(text)} bytes, {len(series)} serving_* series",
              flush=True)
    # (5) a measured session through AsyncOracle against phase 6's DB
    with TuningService(DEFAULT, transport="inproc", db_path=str(sl_db),
                       device="cuda", metrics=False) as svc:
        s = svc.open_session(agent="brute", oracle="measured")
        if not isinstance(s.oracle, AsyncOracle):
            fail("serving: the measured session holds no AsyncOracle")
        t0 = time.perf_counter()
        prog = s.fit(sl_sites).tune(sl_sites)
        wall = time.perf_counter() - t0
        tst = s.stats()["transport"]
        health = s.health()
    timed = tst["transport_timed_pairs_total"]
    if timed or health != "ok" or prog.tiles != brute_measured:
        fail(f"serving: the measured session timed {timed} pairs, health "
             f"{health}, program equal to phase 6's: "
             f"{prog.tiles == brute_measured}")
    out["measured_session"] = {"timed": timed,
                               "hits": tst["transport_hits_total"],
                               "health": health, "wall_s": wall}
    print(f"[serving:measured] StableLM-3B's {len(sl_sites)} serve sites, "
          f"brute force through AsyncOracle over phase 6's timing DB: "
          f"{timed} pairs timed, {tst['transport_hits_total']} DB hits, "
          f"health {health}, program = phase 6's measured brute program; "
          f"{wall:.2f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 14: several ranks and the dry-run
# ---------------------------------------------------------------------------

DIST_RTOL = 1e-5            # the mesh path's losses vs the plain path's
# (arch, shape, layers: None for full depth).  Qwen3-8B's train cell is
# cut to a third of its 36 layers so that its trace ends within phases
# 14 and 15 (its full depth traced in 124-202 s; PERF.md §6)
PRODUCTION_CELLS = (("qwen3_8b", "train_4k", 12),
                    ("deepseek_v2_236b", "decode_32k", None))
H100_BYTES = 80e9           # an H100's device memory (80 GB)

_TRAIN_RUN = r"""
import dataclasses, json, sys
sys.path.insert(0, "src")
import torch
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.optim.adamw import _leaves
cfg = dataclasses.replace(get_config("stablelm_3b"), n_layers=int(sys.argv[1]))
res = train.run(train.parse_args(sys.argv[2:]), cfg=cfg)
state_bytes = sum(
    (t.to_local() if type(t).__name__ == "DTensor" else t).nbytes
    for t in _leaves(res.state))
print("RESULT " + json.dumps({
    "losses": res.losses, "grad_norms": res.grad_norms,
    "fwd_bwd_ms": res.fwd_bwd_ms, "optimizer_ms": res.optimizer_ms,
    "peak_bytes": res.peak_bytes, "state_bytes": state_bytes,
    "mesh": None if res.mesh is None else list(res.mesh.mesh_dim_names)}))
"""

_CELL_RUN = r"""
import dataclasses, json, sys
sys.path.insert(0, "src")
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import run_cell
cfg = get_config(sys.argv[1])
if sys.argv[3] != "full":
    cfg = dataclasses.replace(cfg, n_layers=int(sys.argv[3]))
print("RESULT " + json.dumps(run_cell(sys.argv[1], sys.argv[2], False,
                                      cfg=cfg)))
"""


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _result(proc_out: str, label: str) -> dict:
    for ln in proc_out.splitlines():
        if ln.startswith("RESULT "):
            return json.loads(ln[len("RESULT "):])
    fail(f"{label}: no result")


def _train_subprocess(mesh: bool) -> dict:
    """Phase 11's depth-2 StableLM-3B, 5 steps, through the driver's mesh
    path on a one-rank NCCL group (torchrun's environment, set by hand)
    or through the plain one-card path."""
    env = dict(os.environ)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    argv = _train_argv("--steps", "5")
    if mesh:
        env.update(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
        argv += ["--model-parallel", "1"]
    r = subprocess.run([sys.executable, "-c", _TRAIN_RUN,
                        str(RESTART_LAYERS), *argv], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    label = "mesh" if mesh else "plain"
    if r.returncode != 0:
        fail(f"distribution: the {label} train run failed:\n"
             f"{r.stderr[-3000:]}")
    return _result(r.stdout, f"distribution {label} train")


def start_production_cells() -> dict:
    """Phase 14's production cells, each traced on the CPU in a process
    of its own while the card runs phases 14 and 15."""
    return {(a, s, n): subprocess.Popen(
        [sys.executable, "-c", _CELL_RUN, a, s, str(n or "full")], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for a, s, n in PRODUCTION_CELLS}


def production_cells(cells: dict) -> dict:
    """The production cells' counts (on fake tensors, per device)."""
    from repro_torch.configs import get_config
    out = {}
    for (a, s, n), proc in cells.items():
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode != 0:
            fail(f"distribution: dry-run {a} {s} failed:\n"
                 f"{stderr[-3000:]}")
        res = _result(stdout, f"dry-run {a} {s}")
        if res["status"] != "ok":
            fail(f"distribution: dry-run {a} {s}: {res}")
        pk = res["memory"]["peak_bytes"]
        coll = {k: round(v / 2**20, 1)
                for k, v in res["collectives"].items()}
        depth = (f" ({n} of {get_config(a).n_layers} layers)" if n
                 else " (full depth)")
        print(f"[dist] dry-run 16x16 {a} {s}{depth}: per device peak "
              f"{pk / 2**30:.2f} GiB ({pk / H100_BYTES * 100:.1f}% of an "
              f"H100's 80 GB), argument "
              f"{res['memory']['argument_bytes'] / 2**30:.2f} GiB, flops "
              f"{res['flops']:.4g}, collectives MiB {coll}, trace "
              f"{res['lower_s']:.1f} s (counts on fake tensors)",
              flush=True)
        out[f"{a} {s}"] = {
            "layers": n or get_config(a).n_layers,
            "peak_bytes": pk, "flops": res["flops"],
            "collectives": res["collectives"],
            "argument_bytes": res["memory"]["argument_bytes"],
            "lower_s": res["lower_s"]}
    return out


def distribution_phase() -> dict:
    """Phase 14: the train driver's mesh path against the plain path on
    the card, the dry-run's memory count against the card's, and
    ``compressed_psum`` on a one-rank NCCL mesh (the production cells:
    :func:`start_production_cells`)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import run_cell
    out = {}
    runs = {"plain": _train_subprocess(False),
            "mesh": _train_subprocess(True)}
    plain, mesh = runs["plain"], runs["mesh"]
    if mesh["mesh"] != ["data", "model"] or plain["mesh"] is not None:
        fail(f"distribution: paths {mesh['mesh']} / {plain['mesh']}")
    for a, b in zip(mesh["losses"], plain["losses"]):
        if not abs(a - b) <= DIST_RTOL * abs(b):
            fail(f"distribution: mesh losses {mesh['losses']} vs "
                 f"plain {plain['losses']}")
    if not all(math.isfinite(g) for r in runs.values()
               for g in r["grad_norms"]):
        fail("distribution: a grad norm is not finite")
    ms = {k: r["fwd_bwd_ms"] + r["optimizer_ms"] for k, r in runs.items()}
    print(f"[dist] StableLM-3B full width, depth {RESTART_LAYERS}, batch "
          f"{BATCH}, seq {PROMPT}, 5 steps: losses mesh "
          f"{[round(x, 6) for x in mesh['losses']]} plain "
          f"{[round(x, 6) for x in plain['losses']]} (rtol "
          f"{DIST_RTOL}); ms a step (CUDA events, median after the "
          f"first) mesh {ms['mesh']:.2f} (fwd+bwd "
          f"{mesh['fwd_bwd_ms']:.2f}, optimizer "
          f"{mesh['optimizer_ms']:.2f}) plain {ms['plain']:.2f} (fwd+bwd "
          f"{plain['fwd_bwd_ms']:.2f}, optimizer "
          f"{plain['optimizer_ms']:.2f}); DTensor host overhead "
          f"{ms['mesh'] - ms['plain']:.2f} ms a step; peak "
          f"(torch.cuda.max_memory_allocated) mesh "
          f"{mesh['peak_bytes'] / 2**30:.3f} GiB plain "
          f"{plain['peak_bytes'] / 2**30:.3f} GiB", flush=True)
    out["train"] = {"ms_mesh": ms["mesh"], "ms_plain": ms["plain"],
                    "overhead_ms": ms["mesh"] - ms["plain"],
                    "losses_mesh": mesh["losses"],
                    "losses_plain": plain["losses"],
                    "peak_mesh": mesh["peak_bytes"],
                    "peak_plain": plain["peak_bytes"]}

    # the dry-run's count at the same config, a one-rank fake mesh
    shape = ShapeConfig("train_card", PROMPT, BATCH, "train")
    cell = run_cell(STABLELM, shape.name, False, accum=1,
                    mesh_shape=(1, 1), cfg=_cut_depth(RESTART_LAYERS),
                    shape=shape)
    batch_bytes = 2 * BATCH * PROMPT * 4    # int32 tokens, targets
    arg = cell["memory"]["argument_bytes"]
    if arg != plain["state_bytes"] + batch_bytes or \
            plain["state_bytes"] != mesh["state_bytes"]:
        fail(f"distribution: dry-run argument bytes {arg} vs the card's "
             f"state {plain['state_bytes']} (mesh "
             f"{mesh['state_bytes']}) + batch {batch_bytes}")
    peak = cell["memory"]["peak_bytes"]
    print(f"[dist] dry-run on a 1x1 fake mesh: argument bytes {arg} = "
          f"the card's state {plain['state_bytes']} + the int32 batch "
          f"{batch_bytes}; peak {peak / 2**30:.3f} GiB (a count on fake "
          f"tensors) vs the card's {plain['peak_bytes'] / 2**30:.3f} "
          f"GiB, ratio {peak / plain['peak_bytes']:.3f}; trace "
          f"{cell['lower_s']:.1f} s", flush=True)
    out["dryrun_1x1"] = {"argument_bytes": arg,
                         "state_bytes": plain["state_bytes"],
                         "peak_bytes": peak,
                         "card_peak_bytes": plain["peak_bytes"],
                         "lower_s": cell["lower_s"]}

    # compressed_psum on a one-rank NCCL mesh: the int8 round trip
    import torch.distributed as dist
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.launch.mesh import make_local_mesh
    mesh1 = make_local_mesh(1, device="cuda")
    try:
        if dist.get_backend() != "nccl":
            fail(f"distribution: backend {dist.get_backend()}")
        x = torch.randn((4096, 1024), generator=torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        got = compressed_psum(x, mesh1)
        scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
        want = torch.clamp(torch.round(x / scale), -127, 127) * scale
        err = float((got - want).abs().max())
        if not err <= 1e-6:
            fail(f"distribution: compressed_psum off by {err}")
    finally:
        dist.destroy_process_group()
    print(f"[dist] compressed_psum on a one-rank NCCL mesh: max |psum - int8 "
          f"round trip| {err:.3g} over {x.numel()} elements", flush=True)
    out["compressed_psum_err"] = err
    return out


# ---------------------------------------------------------------------------
# phase 15: the last four examples and the seed's reference paths
# ---------------------------------------------------------------------------

EXAMPLE_TIMEOUT = 300       # seconds an example's process may take
SEED_FIT_STEPS = 8000       # each PPO fit of the seed-path comparison:
                            # two updates of DEFAULT's 4000-site batch


def run_example(script: str, *args, env=None) -> tuple:
    """``examples/<script> args`` in a process of its own: (its output,
    wall s); fails unless it exits 0 with ``OK`` at the end."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                        *args], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=EXAMPLE_TIMEOUT)
    wall = time.perf_counter() - t0
    if r.returncode != 0 or not r.stdout.rstrip().endswith("OK"):
        fail(f"{script} {' '.join(args)}: exit {r.returncode}\n"
             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    return r.stdout, wall


def _timed_pairs(out: str) -> int:
    return int(re.search(r"measurements: (\d+) timed", out).group(1))


def _example_launches(out: str) -> dict:
    m = re.search(r"kernel launches in this process: K1 (\d+), K2 (\d+), "
                  r"K3 (\d+)", out)
    return dict(zip(("K1", "K2", "K3"), map(int, m.groups())))


def _measured_example(d: Path) -> dict:
    """The measured example twice on one DB: in its process, then
    through a pool of 1 (one worker starts in a third of two's time,
    phase 9); the first times pairs and launches K1, K2 and K3, the
    second times none."""
    db = str(d / "measure.jsonl")
    common = ("--db", db, "--out", str(d / "measured_tiles.json"))
    first, w1 = run_example("torch_measured_autotune.py", *common)
    second, w2 = run_example("torch_measured_autotune.py", *common,
                             "--transport", "pool", "--workers", "1")
    n1, n2 = _timed_pairs(first), _timed_pairs(second)
    launches = _example_launches(first)
    if n1 == 0 or n2 != 0 or min(launches.values()) == 0:
        fail(f"measured autotune: timed {n1} then {n2} pairs, launches "
             f"{launches}")
    print(f"[examples] torch_measured_autotune.py: inproc {w1:.1f} s, "
          f"{n1} pairs timed, kernel launches {launches}; pool of 1 on the "
          f"same DB {w2:.1f} s, {n2} pairs timed", flush=True)
    return {"measured": {"wall_s": [w1, w2], "timed": [n1, n2],
                         "launches": launches}}


def _warmstart_example(d: Path) -> dict:
    """Fit, then warm in a fresh process: a store lookup, 0 agent
    inferences, the fit's program bitwise (the example asserts it)."""
    paths = ("--artifact", str(d / "artifact"), "--store",
             str(d / "programs.jsonl"), "--expect", str(d / "cold.json"))
    _, w1 = run_example("torch_warmstart_autotune.py", "--phase", "fit",
                        *paths)
    warm, w2 = run_example("torch_warmstart_autotune.py", "--phase", "warm",
                           *paths)
    if "tune 1: agent inferences 0, store hits 1" not in warm or \
            "tune 2: agent inferences 0" not in warm:
        fail(f"warm start:\n{warm[-2000:]}")
    print(f"[examples] torch_warmstart_autotune.py: fit {w1:.1f} s, warm "
          f"{w2:.1f} s: a store lookup, 0 agent inferences, the program "
          f"bitwise the fit's", flush=True)
    return {"warmstart": {"wall_s": [w1, w2]}}


def _fleet_example(d: Path) -> dict:
    """Two daemons on ports the OS picks, started together; run 1 times
    pairs on the worker and pushes its program to a second subscriber,
    run 2 times none and is a store lookup; both daemons exit 0."""
    from concurrent.futures import ThreadPoolExecutor
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(start_daemon, [
            "serve-worker", "--host", "127.0.0.1", "--port", "0",
            "--transport", "inproc", "--reps", "1"], env, "phase15"),
            pool.submit(start_daemon, [
                "serve-artifacts", "--host", "127.0.0.1", "--port", "0",
                "--measure-db", str(d / "fleet_measure.jsonl"),
                "--program-store", str(d / "fleet_programs.jsonl")], env,
                "phase15")]
    daemons = [f.result() for f in futs if f.exception() is None]
    if len(daemons) < 2:                # one failed: stop the other
        for proc, _, _ in daemons:
            proc.kill()
            proc.wait()
        for f in futs:
            f.result()
    (worker, w_log, w_addr), (arts, a_log, a_addr) = daemons
    start = time.perf_counter() - t0
    try:
        fargs = ("--hosts", w_addr, "--artifacts", a_addr, "--out",
                 str(d / "fleet_tiles.json"))
        first, w1 = run_example("torch_fleet_autotune.py", *fargs)
        second, w2 = run_example("torch_fleet_autotune.py", *fargs)
    finally:
        stop_daemon(worker, w_log, "serve-worker")
        stop_daemon(arts, a_log, "serve-artifacts")
    n1, n2 = _timed_pairs(first), _timed_pairs(second)
    if n1 == 0 or "push-invalidation: serving client observed" not in first \
            or n2 != 0 or "(0 agent inferences)" not in second:
        fail(f"fleet autotune: run 1 timed {n1}, run 2 timed {n2}:\n"
             f"{first[-1500:]}\n{second[-1500:]}")
    print(f"[examples] torch_fleet_autotune.py: daemons up in {start:.1f} "
          f"s; run 1 {w1:.1f} s, {n1} pairs timed on the serve-worker, the "
          f"program pushed to a second subscriber; run 2 {w2:.1f} s, 0 "
          f"pairs timed, the tune a store lookup", flush=True)
    return {"fleet": {"wall_s": [w1, w2], "timed": [n1, n2],
                      "daemons_s": start}}


def examples_phase() -> tuple:
    """Phase 15: the four examples ported last, on the card, each with
    its wall seconds and its invariant, then one PPO fit of the seed's
    path (``fused=False`` against ``CostModelEnv(vectorized=False)``)
    beside one of today's, each fit's seconds a record."""
    import importlib.util
    import types
    import numpy as np
    import torch
    out, by_path = {}, {}
    d = fresh_dir("phase15")

    # the three chains of examples at once (each a chain of processes;
    # the card's timing lock keeps their timings apart)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(3) as pool:
        futs = [pool.submit(f, d) for f in (_measured_example,
                                            _warmstart_example,
                                            _fleet_example)]
        t0 = time.perf_counter()
        for f in futs:
            out.update(f.result())
    out["examples_wall_s"] = time.perf_counter() - t0

    # fault-tolerant serving at Jamba's published widths, 8 of 32 layers,
    # in this process so that its launches count in the kernels line
    from repro_torch.kernels import matmul as kmm
    spec = importlib.util.spec_from_file_location(
        "torch_fault_tolerant_serving",
        ROOT / "examples" / "torch_fault_tolerant_serving.py")
    ft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ft)
    cfg = served_cfg(ft.ARCH)
    n_moe = sum(b.mlp == "moe" for b in cfg.period) * cfg.n_periods
    B, T = 4, 16                         # the example's batch and prompt
    zero_counts()
    t0 = time.perf_counter()
    # eager, the untimed injected pass, then the timed injected prefill
    with RouteTap(3 * n_moe, B * T) as tap:
        res = ft.main(["--full"])
    wall = time.perf_counter() - t0
    counts = read_counts()
    f32 = kmm.launches_by_variant["f32"]
    path_variants("examples:fault_tolerant", counts)
    if res["layers"] != cfg.n_layers or not res["injected"] or \
            counts["matmul"] == 0 or counts["flash_attention"] == 0 or \
            f32 == 0:
        fail(f"fault-tolerant serving: {cfg.n_layers} layers, launches "
             f"{counts}, K1 f32 {f32}")
    routing = routing_agreement(
        cfg, types.SimpleNamespace(eidx=tap.eidx[:n_moe], n=n_moe),
        types.SimpleNamespace(eidx=tap.eidx[2 * n_moe:], n=n_moe),
        res["logits"], res["eager_logits"], batch=B, prompt=T,
        tag="examples")
    # every row held too, the rows whose routing flipped among them
    if not res["logits_rel"] < LOGIT_TOL:
        fail(f"fault-tolerant serving: injected prefill logits "
             f"{res['logits_rel']:.3e} off eager's")
    print(f"[examples] torch_fault_tolerant_serving.py --full: "
          f"{cfg.name} {cfg.n_layers} layers, {len(res['prog'].tiles)} "
          f"sites planned by brute force (legality {res['legality']}), "
          f"injected; {wall:.1f} s; prefill {res['prefill_ms']:.2f} ms, "
          f"mean decode step {res['decode_step_ms']:.2f} ms, "
          f"{res['straggler_events']} straggler events; injected vs eager "
          f"prefill logits {res['logits_rel']:.4e} over all rows; launches "
          f"K1 {counts['matmul']} (f32 {f32}), K2 "
          f"{counts['flash_attention']}", flush=True)
    print(f"[examples] re-plans: {res['replans']}", flush=True)
    by_path["jamba_v0_1_52b fault-tolerant serving"] = counts
    out["fault_tolerant"] = {
        "wall_s": wall, "prefill_ms": res["prefill_ms"],
        "decode_step_ms": res["decode_step_ms"],
        "straggler_events": res["straggler_events"],
        "logits_rel": res["logits_rel"], "k1_f32": f32, **routing,
        **{k: v for k, v in counts.items() if not k.endswith("variant")}}
    del res, ft
    torch.cuda.empty_cache()

    # the seed's reference paths beside today's: one PPO fit each
    from repro_torch.configs.neurovec import DEFAULT as NV
    from repro_torch.core import dataset
    from repro_torch.core.agents.ppo import PPOAgent
    from repro_torch.core.env import CostModelEnv
    sites = dataset.generate(256, seed=0)
    if SEED_FIT_STEPS % NV.train_batch:
        fail("the seed-path fits must take whole batches")
    fits = {}
    for fused in (False, True):
        env = CostModelEnv(NV, legality="h100", vectorized=fused)
        agent = PPOAgent(NV, seed=0, fused=fused, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        agent.fit(sites, env, total_steps=SEED_FIT_STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        greedy = agent.act(sites)
        n_mb = agent.last_minibatch_count
        want = NV.ppo_epochs * (NV.train_batch // NV.sgd_minibatch)
        if not fused and n_mb != want:
            fail(f"seed path: {n_mb} minibatches an update, want {want}")
        legal = float(np.isfinite(env.costs_batch(sites, greedy)).mean())
        fits["seed" if not fused else "fused"] = {
            "fit_s": dt, "minibatches": n_mb, "legal_share": legal,
            "last_reward_mean": agent.history[-1]["reward_mean"]}
        print(f"[examples] PPO fused={fused} against CostModelEnv("
              f"vectorized={fused}, legality=h100): {SEED_FIT_STEPS} steps "
              f"on dataset.generate(256) in {dt:.2f} s ({n_mb} minibatches "
              f"an update; last batch's mean reward "
              f"{agent.history[-1]['reward_mean']:.4f}; greedy tiles legal "
              f"at {legal * 100:.1f}% of the sites; a record, not a "
              f"benchmark)", flush=True)
    out["ppo_fits"] = fits
    return by_path, out


def serving_phase(q_eager, k1_done, k2_done, gen, sl):
    """Phase 13: the service and serving layer.  Returns ``(counts,
    summary)``: the launches of the --serving --inject serve, and every
    step's numbers."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import dataset
    from repro_torch.core.extractor import extract_serve_sites
    from repro_torch.models.lm import build_model
    counts, out, qsites = serving_serve(q_eager, k1_done, k2_done, gen)
    t0 = time.perf_counter()
    corpus = dataset.arch_sites()
    print(f"[serving] the ten-arch corpus: {len(corpus)} sites extracted in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out["fused"] = serving_fused_vs_host(corpus)
    sl_sites = extract_serve_sites(build_model(get_config(STABLELM)), BATCH,
                                   PROMPT, GEN)
    out["surrogate"] = serving_surrogate(list(qsites) + list(sl_sites))
    out.update(serving_sessions(corpus, qsites, sl_sites, sl["db"],
                                sl["brute_tiles"]))
    torch.cuda.empty_cache()
    return counts, out


def sass_check() -> None:
    """K1's, K2's and K3's libraries must hold Hopper's wgmma (HGMMA) and
    TMA load (UTMALDG) instructions, K1's f32 library FFMA and no
    tensor-core product, and the f32, K2 and K3 builds no spilled
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
        if name == "matmul":
            multicast_check(sass)
    sass = subprocess.run([tool, "-sass", str(build._lib_path("matmul_f32"))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    # opcodes, not HFMA2.MMA (a move on the FMA pipe)
    n_ffma = len(re.findall(r"\bFFMA\b", sass))
    n_mma = len(re.findall(r"\b(?:HGMMA|HMMA|IMMA|DMMA)\b", sass))
    print(f"[build:matmul_f32] SASS: {n_ffma} FFMA, {n_mma} tensor-core "
          f"(HMMA, HGMMA) instructions", flush=True)
    if n_mma or not n_ffma:
        fail("libmatmul_f32 must be FFMA alone: a tensor-core product "
             "would round the f32 operands to TF32")
    for name in ("matmul_f32", "flash_attention", "chunk_scan"):
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


def multicast_check(sass: str) -> None:
    """K1's library must hold the TMA load multicast over a thread-block
    cluster (its swapped small-row tiles share each w slab so): a
    UTMALDG that SASS marks MULTICAST, or where SASS does not name it, a
    ``cp.async.bulk.tensor`` with ``.multicast::cluster`` in the PTX that
    nvcc makes of csrc/matmul.cu for sm_90a."""
    from repro_torch.kernels import build
    lines = [ln for ln in sass.splitlines() if "UTMALDG" in ln]
    n_mc = sum("MULTICAST" in ln for ln in lines)
    if n_mc:
        print(f"[build:matmul] SASS: {n_mc} multicast UTMALDG of "
              f"{len(lines)}", flush=True)
        return
    out = ROOT / "build" / "matmul_check.ptx"
    subprocess.run([build._nvcc(), "-arch=sm_90a", "-std=c++17", "-O3",
                    "-ptx", "-I", str(build.CSRC), "-o", str(out),
                    str(build.CSRC / "matmul.cu")],
                   check=True, timeout=600, capture_output=True)
    ptx = out.read_text()
    n_ptx = len(re.findall(r"cp\.async\.bulk\.tensor\.2d\S*"
                           r"multicast::cluster", ptx))
    print(f"[build:matmul] SASS names no multicast on its {len(lines)} "
          f"UTMALDG; PTX: {n_ptx} multicast::cluster TMA loads", flush=True)
    if not n_ptx:
        fail("libmatmul holds no TMA load multicast over a cluster")


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
    import itertools

    from repro_torch.configs import get_config
    from repro_torch.configs.neurovec import DEFAULT as NV
    from repro_torch.core.costmodel import baseline_tiles
    from repro_torch.kernels import ops
    from repro_torch.core.extractor import extract_serve_sites
    from repro_torch.kernels import build
    from repro_torch.kernels import matmul as kmm
    from repro_torch.models.lm import build_model

    walls, t_phase = {}, time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        walls[name] = time.perf_counter() - t_phase
        t_phase = time.perf_counter()
        print(f"[timing] phase {name}: {walls[name]:.1f} s", flush=True)

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
    phase_done("1-2 device and build")

    # ---- phase 3: kernels vs plain ----
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_model(get_config(ARCH))
    sites = extract_serve_sites(model, BATCH, PROMPT, GEN)
    shapes = k1_shapes(sites)
    k1_seen = {shape: k1_check(shape, baseline_tiles(s), "baseline", gen)
               for shape, s in shapes.items()}
    # a 16-row tile, swapped and multicast, at the four prefill shapes
    k1_rows16 = {shape: k1_check(shape, K1_ROWS16_TILE, "rows16", gen)
                 for shape in shapes if shape[0] > 8}
    sweep_site = next(s for s in sites if s.kind == "matmul" and s.m > 1
                      and s.site == "attn.q")
    k1_sweep(sweep_site, gen)
    # (shape, tiles) pairs K1 was held at, for phase 13
    k1_done = {(shape, tuple(baseline_tiles(s))) for shape, s in shapes.items()}
    k1_done |= {(shape, K1_ROWS16_TILE) for shape in k1_rows16}
    k1_done |= {((sweep_site.m, sweep_site.n, sweep_site.k, False), t)
                for t in itertools.product(NV.bm_choices, NV.bn_choices,
                                           NV.bk_choices)
                if ops.tile_ok(sweep_site, t)}
    k2 = k2_checks(gen)
    k2_d80, k2_small_err = k2_head_dim_checks(gen)
    torch.cuda.empty_cache()
    k2_mla = k2_mla_checks(gen)
    k2_widths = k2_width_checks(gen)
    xl_sites = extract_serve_sites(build_model(get_config(XLSTM)), BATCH,
                                   PROMPT, GEN)
    xl_scan = next(s for s in xl_sites if s.kind == "chunk_scan")
    k3, k3_mamba = k3_checks(xl_scan, gen)
    torch.cuda.empty_cache()
    p12_checks = phase12_kernel_checks(gen, k1_seen)
    torch.cuda.empty_cache()
    f32_more = k1_f32_checks(gen)
    phase_done("3 kernels")

    # ---- phase 4: the modelled main path ----
    res, counts, q_eager = main_path()
    prog = res.prog.tiles
    k1_tuned, per_site_launches = {}, {}
    for s in res.sites:          # each matmul site at its own tuned tile
        if s.kind == "matmul":
            shape = (s.m, s.n, s.k, s.site == "lm_head")
            k1_tuned[s.key()] = k1_check(shape, prog[s.key()],
                                         f"tuned:{s.site}", gen)
            k1_done.add((shape, tuple(prog[s.key()])))
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
    phase_done("4 modelled path")

    # ---- phase 5: the measured main paths (their timings kept in one DB,
    # phase 10's training corpus) ----
    p5_db = ROOT / "build" / "phase5_measure.jsonl"
    p5_db.unlink(missing_ok=True)
    p5_extra = ("--measure-db", str(p5_db))
    by_path = {"qwen3_8b modelled": counts}
    q_res, by_path["qwen3_8b measured"], _ = measured_path(
        ARCH, params, prompts, extra=p5_extra, eager=q_eager)
    # phase 13 serves these seeded weights and prompts again
    q_eager = {"logits": q_eager["logits"], "seq": q_eager["seq"]}
    del q_res, params, prompts
    torch.cuda.empty_cache()
    x_res, by_path["xlstm_1_3b measured"], x_eager = measured_path(
        XLSTM, extra=p5_extra)
    xlstm_model_checks(x_res, x_eager["logits"])
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
    phase_done("5 measured paths")

    # ---- phase 6: the main-path loop on StableLM-3B ----
    sl = stablelm_path(gen)
    by_path["stablelm_3b ppo (corpus)"] = sl["ppo"]
    by_path["stablelm_3b brute measured"] = sl["brute"]
    if sl["t_att"] not in k2_d80:
        fail(f"StableLM's tuned attention tile {sl['t_att']} was not "
             f"checked at D = 80")
    phase_done("6 StableLM loop")

    # ---- phase 8: the facade (before the kernels line: its launches
    # count into the line's) ----
    by_path["stablelm_3b facade"], facade = facade_path()
    print("[facade] summary " + json.dumps(facade, default=str), flush=True)
    phase_done("8 facade")

    # ---- phase 9: the transports on the card (before the kernels line:
    # the launches its workers reported count into the line's) ----
    t0 = time.perf_counter()
    t_paths, transports = transports_path(sl["db"], xl_scan, by_q,
                                          sl["brute_measured_speedup"],
                                          sl["eager"])
    by_path.update(t_paths)
    transports["wall_s"] = time.perf_counter() - t0
    print("[transports] summary " + json.dumps(transports, default=str),
          flush=True)
    phase_done("9 transports")

    # ---- phase 10: the learned cost model (before the kernels line: the
    # pruned serve's launches count into the line's) ----
    by_path["stablelm_3b pruned brute measured"], sur = surrogate_path(
        sl, p5_db)
    print("[surrogate] summary " + json.dumps(sur, default=str), flush=True)
    phase_done("10 surrogate")

    # ---- phase 11: the train path (before the kernels line: the
    # injected forward's launches count into the line's) ----
    by_path["stablelm_3b train (injected forward)"], tr = train_path(sl, gen)
    print("[train] summary " + json.dumps(tr, default=str), flush=True)
    phase_done("11 train path")

    # ---- phase 12: seven more archs served (before the kernels
    # line: their launches count into the line's) ----
    p12_paths, p12 = serve_phase12(gen, p12_checks)
    by_path.update(p12_paths)
    print("[serve12] summary " + json.dumps(p12, default=str), flush=True)
    phase_done("12 seven archs served")

    # ---- phase 13: the tuning service and the serving layer (before the
    # kernels line: the --serving --inject serve's launches count there) ----
    t0 = time.perf_counter()
    by_path["qwen3_8b serving brute"], serving = serving_phase(
        q_eager, k1_done, set(k2), gen, sl)
    serving["wall_s"] = time.perf_counter() - t0
    print("[serving] summary " + json.dumps(serving, default=str),
          flush=True)
    phase_done("13 service and serving")

    # ---- phases 14 and 15: several ranks and the dry-run; the last four
    # examples and the seed paths (before the kernels line: the
    # fault-tolerant serve's launches count there), while the dry-run's
    # production cells trace on the CPU ----
    cells = start_production_cells()
    try:
        dist_out = distribution_phase()
        phase_done("14 distribution")
        ex_paths, examples = examples_phase()
        by_path.update(ex_paths)
        print("[examples] summary " + json.dumps(examples, default=str),
              flush=True)
        phase_done("15 examples and seed paths")
        dist_out["production"] = production_cells(cells)
        phase_done("14 dry-run cells (after 15)")
    finally:
        for proc in cells.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print("[dist] summary " + json.dumps(dist_out, default=str), flush=True)
    print(f"[timing] all phases: {sum(walls.values()):.1f} s", flush=True)
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

    def f32_records(rec):
        """K1's f32 variant at an arch's router shapes (phase 3, baseline
        tiles), summed over one prefill and one decode step, the bound at
        the FP32 rate."""
        recs, w = rec["k1_f32"], rec["k1_f32_launches"]
        if not recs:
            return None
        tot = {k: sum(recs[s][k] * n for s, n in w.items())
               for k in ("ms", "plain_ms", "lib_ms")}
        by_time = {"operations": 0.0, "bytes": 0.0}
        for s, n in w.items():
            b, by = bound_s(recs[s]["flops"], recs[s]["bytes"], PEAK_F32)
            by_time[by] += b * n
        return {"ms": tot["ms"], "plain_ms": tot["plain_ms"],
                "bound_ms": sum(by_time.values()) * 1e3,
                "bound_by": max(by_time, key=by_time.get),
                "library_ms": tot["lib_ms"],
                "max_abs_err": max(r["err"] for r in recs.values()),
                "max_rel_err": max(r["rel"] for r in recs.values()),
                "launches_per_pass": {f"{m}x{n}x{k}": c
                                      for (m, n, k, _), c in w.items()},
                "by_shape": {f"{m}x{n}x{k}": f32_summary(r)
                             for (m, n, k, _), r in recs.items()},
                "work": "the moe.router matmuls of one prefill + one decode "
                        "step at the baseline tiles; library: torch.matmul "
                        "in f32, TF32 off"}

    def arch_records(kind):
        """Per phase-12 arch: K1 (``k1``) or K2 (``k2``) at the baseline
        tiles of phase 3, summed over one prefill and one decode step."""
        out = {}
        for arch, rec in p12_checks.items():
            tot, b, by = agg(rec[kind], rec[f"{kind}_launches"])
            out[arch] = {
                "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                "bound_ms": b * 1e3, "bound_by": by,
                "library_ms": tot["lib_ms"],
                "max_abs_err": max(r["err"] for r in rec[kind].values()),
                "launches": by_path[f"{arch} ppo (cost model)"][
                    "matmul" if kind == "k1" else "flash_attention"],
                "work": ("one prefill + one decode step" if kind == "k1"
                         else "one prefill") + f" of {arch} at the "
                "baseline tiles" + (" (bf16 sites)" if kind == "k1" else "")}
            if kind == "k1" and f32_records(rec) is not None:
                out[arch]["router_f32"] = f32_records(rec)
        return out
    f32_recs = [r for a in p12_checks.values()
                for r in a["k1_f32"].values()]
    f32_tuned = [a["k1_f32_tuned_max_rel_err"] for a in p12.values()
                 if a.get("k1_f32_tuned_max_rel_err") is not None]
    line = {"kernels": [
        {"name": "tiled_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/matmul.cu",
         "replaces": "src/repro/kernels/matmul.py:32",
         "launches": total["matmul"],
         "launches_by_path": path_counts("matmul"),
         "launches_by_variant": by_variant("matmul"),
         "launches_by_variant_by_path": path_counts("matmul_by_variant"),
         "launches_by_layout": {
             v: sum(c.get("matmul_by_layout", {}).get(v, 0)
                    for c in by_path.values()) for v in kmm.LAYOUTS},
         "launches_by_layout_by_path": {
             p: c["matmul_by_layout"] for p, c in by_path.items()
             if "matmul_by_layout" in c},
         "rows16": {f"{m}x{n}x{k}": {
             "ms": r["ms"], "device_ms": r["device_ms"],
             "library_ms": r["lib_ms"], "bound_ms": r["bound_s"] * 1e3,
             "layout": r["layout"], "max_abs_err": r["err"]}
             for (m, n, k, _), r in k1_rows16.items()},
         "f32_variant": {
             "source": "src/repro_torch/csrc/matmul_f32.cu",
             "launches": by_variant("matmul")["f32"],
             "max_abs_err": max(r["err"] for r in f32_recs
                                + list(f32_more.values())),
             "max_rel_err": max([r["rel"] for r in f32_recs
                                 + list(f32_more.values())] + f32_tuned),
             "tolerance": f"{K1_F32_TOL} of the largest |output| vs the f32 "
                          f"product (TF32 off)",
             "phase3": {label: f32_summary(r)
                        for label, r in f32_more.items()},
             "bound_rate": f"FP32 {PEAK_F32:.3g} FLOP/s, {HBM_BPS:.3g} B/s"},
         "max_abs_err": max([r["err"] for r in k1_tuned.values()]
                            + [r["err"] for r in tr["lm_head"].values()]
                            + [r["err"] for a in p12_checks.values()
                               for r in a["k1"].values()]
                            + [a["k1_tuned_max_abs_err"] for a in p12.values()
                               if a.get("k1_tuned_max_abs_err") is not None]),
         "max_rel_err": max([r["rel"] for r in k1_tuned.values()]
                            + [r["rel"] for r in tr["lm_head"].values()]
                            + [r["rel"] for a in p12_checks.values()
                               for r in a["k1"].values()]
                            + [a["k1_tuned_max_rel_err"] for a in p12.values()
                               if a.get("k1_tuned_max_rel_err") is not None]),
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
                     "PPO (corpus) tiles"},
         "stablelm_3b_train_lm_head": {
             k: {"ms": r["ms"], "device_ms": r["device_ms"],
                 "plain_ms": r["plain_ms"], "library_ms": r["lib_ms"],
                 "bound_ms": r["bound_s"] * 1e3,
                 "bound_by": bound_s(r["flops"], r["bytes"])[1],
                 "variant": r["variant"], "max_abs_err": r["err"]}
             for k, r in tr["lm_head"].items()},
         **arch_records("k1")},
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
                            + [r["err"] for label, r in k2_mla.items()
                               if label != "small_model"]
                            + [r["err"] for r in k2_widths.values()]
                            + [k2_small_err]
                            + [r["err"] for a in p12_checks.values()
                               for r in a["k2"].values()]
                            + [a["k2_tuned_max_abs_err"] for a in p12.values()
                               if a.get("k2_tuned_max_abs_err") is not None]),
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
                     f"at head dim 80, tiles {sl['t_att']})"},
         "mla": {label: {
             "ms": r["ms"], "device_ms": r["device_ms"],
             "plain_ms": r["plain_ms"], "library_ms": r["lib_ms"],
             "library_device_ms": r["lib_device_ms"],
             "bound_ms": r["bound_s"] * 1e3,
             "bound_by": bound_s(r["flops"], r["bytes"])[1],
             "max_abs_err": r["err"], "tiles": r["tiles"],
             "launched": r["launched"]}
             for label, r in k2_mla.items() if label != "small_model"},
         "mla_small_model_logits_rel": k2_mla["small_model"]["logits_rel"],
         "widths": {label: {
             "ms": r["ms"], "device_ms": r["device_ms"],
             "plain_ms": r["plain_ms"], "library_ms": r["lib_ms"],
             "library_device_ms": r["lib_device_ms"],
             "bound_ms": r["bound_s"] * 1e3,
             "bound_by": bound_s(r["flops"], r["bytes"])[1],
             "max_abs_err": r["err"], "tiles": r["tiles"],
             "launched": r["launched"]}
             for label, r in k2_widths.items()},
         **arch_records("k2")},
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
