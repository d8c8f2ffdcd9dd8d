"""Analytic kernel cost model — the reward source (the port of
``repro/core/costmodel.py``).

For a kernel site and a tile choice it returns modelled seconds, or
``None`` when the tile is illegal (the paper's compile timeout, penalised
with -9 by the environment).  The time formula and its constants are the
reference's TPU v5e ones, unchanged: every modelled time or speedup is
TPU-v5e-modelled and says nothing about the H100.

``legality`` picks which tiles are illegal:

* ``"tpu_v5e"`` — VMEM overflow, exactly as the reference (parity);
* ``"h100"`` — the Hopper kernel cannot launch the tile at the site's
  dtype and head dim (``repro_torch.kernels.ops.tile_ok``), so "fails to
  compile" means the same to the oracle and to the kernel, for all three
  kernels (K1, K2, K3); a site the kernels refuse has no legal tile;
* ``"cpu"`` — the CPU route, where the kernels' plain versions run: the
  same rule without its dtype clause (``tile_ok(..., route="cpu")``), so
  a reduced f32 config tunes on the CPU to the tiles the card would
  launch at its shapes.

Also provides the heuristic baseline tile pickers, verbatim.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.kernels import ops
from repro_torch.models.compute import KernelSite

# ---- TPU v5e constants of the reference model (not H100 numbers) ----
PEAK_FLOPS_BF16 = 197e12
PEAK_FLOPS_F32 = 49.25e12
HBM_BW = 819e9
VMEM_BYTES = 16 * 2 ** 20
MXU = 128
SUBLANE = 8
LANE = 128
GRID_STEP_OVERHEAD = 3e-7
FIXED_OVERHEAD = 2e-6

LEGALITIES = ("tpu_v5e", "h100", "cpu")
ROUTE = {"h100": "cuda", "cpu": "cpu"}     # legality -> ops.tile_ok route
DEFAULT_LEGALITY = "h100"


def check_legality(legality: str) -> str:
    if legality not in LEGALITIES:
        raise ValueError(f"legality {legality!r} not in {LEGALITIES}")
    return legality


def _dtype_bytes(dtype: str) -> int:
    return {"bfloat16": 2, "float32": 4, "float16": 2, "int8": 1}.get(
        str(dtype), 2)


def _peak(dtype: str) -> float:
    return PEAK_FLOPS_F32 if "32" in str(dtype) else PEAK_FLOPS_BF16


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _mxu_util(bm: int, bn: int, bk: int) -> float:
    u = min(bm, MXU) / MXU * (min(bn, LANE) / LANE)
    if bm % SUBLANE:
        u *= 0.6
    if bn % LANE:
        u *= 0.5
    u *= bk / (bk + MXU)
    return max(u, 1e-3)


def _legal(site: KernelSite, tiles, vmem: int, legality: str) -> bool:
    if check_legality(legality) == "tpu_v5e":
        return vmem <= VMEM_BYTES
    return ops.tile_ok(site, tiles, ROUTE[legality])


def matmul_cost(site: KernelSite, tiles: Tuple[int, int, int],
                legality: str = DEFAULT_LEGALITY) -> Optional[float]:
    M, N, K = site.m, site.n, site.k
    bm, bn, bk = tiles
    s = _dtype_bytes(site.dtype)
    if bm <= 0 or bn <= 0 or bk <= 0:
        return None
    tm, tn, tk = _ceil(M, bm), _ceil(N, bn), _ceil(K, bk)
    vmem = 2 * (bm * bk + bk * bn) * s + bm * bn * 4 + bm * bn * s
    if not _legal(site, tiles, vmem, legality):
        return None
    grid = tm * tn * tk
    flops = 2.0 * (tm * bm) * (tn * bn) * (tk * bk)
    t_compute = flops / (_peak(site.dtype) * _mxu_util(bm, bn, bk))
    bytes_ = (tm * bm) * (tk * bk) * tn * s \
        + (tk * bk) * (tn * bn) * tm * s \
        + (tm * bm) * (tn * bn) * s
    t_mem = bytes_ / HBM_BW
    return (max(t_compute, t_mem) + grid * GRID_STEP_OVERHEAD
            + FIXED_OVERHEAD)


def baseline_matmul_tiles(M: int, N: int, K: int) -> Tuple[int, int, int]:
    """The heuristic "LLVM cost model": fixed square-ish aligned tiles."""
    bm = min(128, _ceil(M, SUBLANE) * SUBLANE)
    bn = min(128, _ceil(N, LANE) * LANE)
    bk = min(512, _ceil(K, LANE) * LANE)
    return bm, bn, bk


def attention_cost(site: KernelSite, tiles: Tuple[int, int],
                   legality: str = DEFAULT_LEGALITY) -> Optional[float]:
    Sq, Skv, D, BH = site.m, site.k, site.n, site.batch
    bq, bkv = tiles
    s = _dtype_bytes(site.dtype)
    if bq <= 0 or bkv <= 0:
        return None
    tq, tkv = _ceil(Sq, bq), _ceil(Skv, bkv)
    vmem = 2 * (bq * D + 2 * bkv * D) * s + bq * D * 4 + 2 * bq * 4 \
        + bq * bkv * 4
    if not _legal(site, tiles, vmem, legality):
        return None
    grid = BH * tq * tkv
    frac = 0.5 * (1 + 1 / max(tq, 1)) if site.causal else 1.0
    flops = 4.0 * BH * (tq * bq) * (tkv * bkv) * D * frac
    vpu_ops = 6.0 * BH * (tq * bq) * (tkv * bkv) * frac
    t_compute = (flops / (_peak(site.dtype) * _mxu_util(bq, bkv, D))
                 + vpu_ops / (PEAK_FLOPS_BF16 / 16))
    bytes_ = BH * s * ((tq * bq) * D
                       + 2 * (tkv * bkv) * D * tq * frac
                       + (tq * bq) * D)
    t_mem = bytes_ / HBM_BW
    return (max(t_compute, t_mem) + grid * frac * GRID_STEP_OVERHEAD
            + FIXED_OVERHEAD)


def baseline_attn_tiles(Sq: int, Skv: int) -> Tuple[int, int]:
    """Heuristic: fixed 128/512 blocks (shape-oblivious)."""
    bq = min(128, _ceil(Sq, SUBLANE) * SUBLANE)
    bkv = min(512, _ceil(Skv, LANE) * LANE)
    return bq, bkv


def chunk_scan_cost(site: KernelSite, tiles: Tuple[int],
                    legality: str = DEFAULT_LEGALITY) -> Optional[float]:
    Q = tiles[0]
    P, N = site.n, site.k
    tokens = site.batch * site.m
    s = _dtype_bytes(site.dtype)
    if Q <= 0:
        return None
    vmem = 2 * Q * (P + 2 * N) * s + P * N * 4 + Q * Q * 4
    if not _legal(site, tiles, vmem, legality):
        return None
    chunks_total = _ceil(tokens, Q)
    per_chunk = 2.0 * Q * Q * N + 2.0 * Q * Q * P + 4.0 * Q * P * N
    flops = per_chunk * chunks_total
    t_compute = flops / (_peak(site.dtype) * _mxu_util(Q, max(P, N), Q))
    bytes_ = tokens * (P + 2 * N) * s * 2
    t_mem = bytes_ / HBM_BW
    return (max(t_compute, t_mem) + chunks_total * GRID_STEP_OVERHEAD
            + FIXED_OVERHEAD)


def baseline_chunk(S: int) -> Tuple[int]:
    return (min(256, S),)


def site_cost(site: KernelSite, tiles: Tuple[int, ...],
              legality: str = DEFAULT_LEGALITY) -> Optional[float]:
    if site.kind == "matmul":
        return matmul_cost(site, tiles[:3], legality)
    if site.kind == "attention":
        return attention_cost(site, tiles[:2], legality)
    if site.kind == "chunk_scan":
        return chunk_scan_cost(site, tiles[:1], legality)
    raise ValueError(site.kind)


def baseline_tiles(site: KernelSite) -> Tuple[int, ...]:
    if site.kind == "matmul":
        return baseline_matmul_tiles(site.m, site.n, site.k)
    if site.kind == "attention":
        return baseline_attn_tiles(site.m, site.k)
    if site.kind == "chunk_scan":
        return baseline_chunk(site.m)
    raise ValueError(site.kind)


def baseline_cost(site: KernelSite,
                  legality: str = DEFAULT_LEGALITY) -> float:
    c = site_cost(site, baseline_tiles(site), legality)
    if c is None:
        raise ValueError(f"baseline tiles illegal ({legality}) for {site}")
    return c
