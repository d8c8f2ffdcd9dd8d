"""Synthetic kernel-site corpus — the analogue of the paper's >10k generated
loops (§3.2); the port of ``repro/core/dataset.py``.  It draws only from
Python's ``random``, so for the same seed and base the site keys are
bitwise the reference's.

Two sources:
 1. *Real* sites extracted from the 10 assigned architectures' step
    functions (the analogue of the LLVM vectorizer test suite the paper
    seeded from).
 2. Generated variants: dim/dtype/flag perturbations of those sites plus
    random shape families — the paper's renamed/re-strided/re-nested loop
    generators (which it found crucial against embedding bias).

Held-out evaluation suites (paper §4):
 * ``twelve_benchmarks()``  — 12 diverse held-out sites        (Fig. 7)
 * ``polybench()``          — matrix-op-dominated workloads    (Fig. 8)
 * ``mibench()``            — workloads where tunable kernels are a minor
   fraction of total time (``fixed_frac``)                     (Fig. 9)
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.models.compute import KernelSite

_DTYPES = ("bfloat16", "float32")
# include SMALL dims: embedded-style workloads (the MiBench transfer set)
# live at the bottom of this range, and the paper's generators stressed
# diverse trip counts for exactly this reason (§3.2)
_MODEL_DIMS = (8, 16, 32, 64, 128, 256, 512, 1024, 1536, 2048, 2560, 3072,
               4096, 4608, 5120, 6912, 8192, 12288, 13696, 14336, 16384,
               18432)
_TOKEN_COUNTS = (8, 32, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
                 32768, 65536)
_SEQS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
_HEAD_DIMS = (64, 80, 96, 128, 192)
# the reference's ten assigned architectures, in its order
_ARCHS = ("starcoder2_7b", "qwen3_8b", "stablelm_3b", "chatglm3_6b",
          "deepseek_v2_236b", "llama4_maverick_400b", "xlstm_1_3b",
          "phi3_vision_4_2b", "seamless_m4t_medium", "jamba_v0_1_52b")


def _mm(site, m, n, k, dtype="bfloat16", fused=0):
    return KernelSite(site=site, kind="matmul", m=m, n=n, k=k,
                      dtype=dtype, fused_ops=fused)


def _attn(site, sq, skv, d, bh, causal=True, dtype="bfloat16"):
    return KernelSite(site=site, kind="attention", m=sq, n=d, k=skv,
                      batch=bh, causal=causal, dtype=dtype)


def _scan(site, q, p, n, batch, dtype="bfloat16"):
    return KernelSite(site=site, kind="chunk_scan", m=q, n=p, k=n,
                      batch=batch, dtype=dtype)


def arch_sites() -> List[KernelSite]:
    """Extract real sites from every architecture the port has (reduced
    batch dims to keep extraction instant; shapes of the weights are
    exact).  The reference's ``arch_sites`` walks its ten assigned
    architectures; this one walks the same list, in the same order, cut
    to ``PORTED_ARCHS``, and an extraction that fails raises."""
    from repro_torch.configs.base import PORTED_ARCHS
    from repro_torch.core.extractor import extract_arch_sites
    out = []
    for arch in _ARCHS:
        if arch in PORTED_ARCHS:
            out.extend(extract_arch_sites(arch))
    return out


def generate(n: int, seed: int = 0,
             base: Optional[List[KernelSite]] = None) -> List[KernelSite]:
    """Generate ``n`` synthetic sites (mix of perturbed-real and random)."""
    rng = random.Random(seed)
    base = list(base or [])
    out: List[KernelSite] = []
    while len(out) < n:
        r = rng.random()
        if base and r < 0.4:
            s = rng.choice(base)
            out.append(_perturb(s, rng))
        elif r < 0.75:
            m = rng.choice(_TOKEN_COUNTS)
            nn = rng.choice(_MODEL_DIMS)
            k = rng.choice(_MODEL_DIMS)
            out.append(_mm("gen.mm", m, nn, k, rng.choice(_DTYPES),
                           rng.randint(0, 2)))
        elif r < 0.92:
            sq = rng.choice(_SEQS)
            out.append(_attn("gen.attn", sq, sq, rng.choice(_HEAD_DIMS),
                             rng.choice((8, 16, 32, 64, 128, 256)),
                             causal=rng.random() < 0.7,
                             dtype=rng.choice(_DTYPES)))
        else:
            out.append(_scan("gen.scan", rng.choice((64, 128, 256, 512)),
                             rng.choice((32, 64, 128)),
                             rng.choice((16, 64, 128)),
                             rng.choice((64, 256, 1024, 4096))))
    return out[:n]


def _perturb(s: KernelSite, rng: random.Random) -> KernelSite:
    def jig(v):
        f = rng.choice((1, 1, 2, 2, 4)) / rng.choice((1, 2))
        return max(8, int(v * f))
    kw = dict(site=s.site + ".v", kind=s.kind, m=jig(s.m), n=jig(s.n),
              k=jig(s.k), batch=max(1, jig(s.batch) // 8),
              dtype=rng.choice(_DTYPES), transpose=s.transpose,
              causal=s.causal, fused_ops=rng.randint(0, 3))
    return KernelSite(**kw)


def split(sites: List[KernelSite], test_frac: float, seed: int = 0):
    rng = random.Random(seed)
    s = list(sites)
    rng.shuffle(s)
    n_test = int(len(s) * test_frac)
    return s[n_test:], s[:n_test]


# ---------------------------------------------------------------------------
# held-out evaluation suites (the paper's benchmark sets)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Workload:
    """A benchmark = a bag of tunable sites + a fixed (non-tunable) fraction
    of total baseline runtime, mirroring whole-program measurement."""
    name: str
    sites: Tuple[KernelSite, ...]
    fixed_frac: float = 0.0


def twelve_benchmarks() -> List[Workload]:
    """12 held-out benchmarks with diverse functionality (paper Fig. 7):
    predicates/strides/reductions/type conversions map to causality,
    layouts, fusions and dtypes in our site space."""
    bs = [
        Workload("dot_product", (_mm("b.dot", 8, 128, 4096),)),
        Workload("skinny_gemm", (_mm("b.skinny", 64, 8192, 1024),)),
        Workload("wide_gemm", (_mm("b.wide", 16384, 512, 512),)),
        Workload("square_gemm", (_mm("b.square", 4096, 4096, 4096),)),
        Workload("ffn_fused", (_mm("b.ffn", 8192, 13696, 4096, fused=2),
                               _mm("b.ffn2", 8192, 4096, 13696),)),
        Workload("qkv_proj", (_mm("b.qkv", 16384, 6144, 4096),)),
        Workload("f32_gemm", (_mm("b.f32", 2048, 2048, 2048, "float32"),)),
        Workload("prefill_attn", (_attn("b.pre", 8192, 8192, 128, 64),)),
        Workload("bidir_attn", (_attn("b.bi", 4096, 4096, 64, 32,
                                      causal=False),)),
        Workload("long_attn", (_attn("b.long", 32768, 32768, 128, 16),)),
        Workload("ssd_scan", (_scan("b.ssd", 256, 64, 16, 2048),)),
        Workload("mlstm_scan", (_scan("b.mlstm", 256, 512, 512, 64),)),
    ]
    return bs


def polybench() -> List[Workload]:
    """Matrix-op suite (Fig. 8): gemm chains / decompositions — large loop
    trip counts, kernels dominate runtime."""
    return [
        Workload("2mm", (_mm("p.2mm_a", 4096, 4096, 4096),
                         _mm("p.2mm_b", 4096, 4096, 4096))),
        Workload("3mm", tuple(_mm(f"p.3mm_{i}", 2048, 2048, 2048)
                              for i in range(3))),
        Workload("gemver", (_mm("p.gemver", 8192, 8192, 128),
                            _mm("p.gemver2", 8192, 128, 8192))),
        Workload("syrk", (_mm("p.syrk", 4096, 4096, 1024),)),
        Workload("atax", (_mm("p.atax", 16384, 128, 4096),
                          _mm("p.atax2", 128, 4096, 16384))),
        Workload("correlation", (_mm("p.corr", 2048, 2048, 8192),),
                 fixed_frac=0.1),
    ]


def mibench() -> List[Workload]:
    """Embedded-style suite (Fig. 9): kernels are a minor part of the
    program (high fixed_frac), and some workloads barely vectorize."""
    return [
        Workload("susan", (_mm("m.susan", 1024, 128, 128),),
                 fixed_frac=0.85),
        Workload("jpeg", (_mm("m.jpeg", 512, 512, 64),), fixed_frac=0.80),
        Workload("typeset", (_mm("m.typeset", 256, 128, 256),),
                 fixed_frac=0.92),
        Workload("qsort_partition", (_mm("m.qsort", 2048, 128, 8),),
                 fixed_frac=0.90),
        Workload("fft", (_mm("m.fft", 4096, 128, 128, "float32"),),
                 fixed_frac=0.70),
        Workload("gsm", (_mm("m.gsm", 1024, 256, 64),), fixed_frac=0.88),
    ]
