"""Hardware measurement runner: turn ``(KernelSite, tiles)`` into seconds
(the port of ``repro/measure/runner.py``).

The real ``measure_fn`` of :class:`~repro_torch.core.env.MeasuredEnv`
(paper eq. 2: the reward is *measured* execution time).  For every pair it
materialises inputs from the site's shapes and dtype with a
``torch.Generator`` on the runner's device, calls the port's kernel
wrapper (``kernels.ops``) with the candidate tiles, the same entry points
``inject`` routes through, and times it with warmup, a device synchronise
and the median of reps (:mod:`repro_torch.measure.timing`).

On the card (``device="cuda"``, the default) the Hopper kernels run at the
sites' full shapes.  With ``device="cpu"``, asked for explicitly, the
wrappers take their plain PyTorch versions and the site dimensions are
capped as the reference caps them in interpret mode (128, and 2 on
batch): a proxy that exercises every seam, not a device time.
``max_dim``/``max_batch`` set the caps on either device.  There is no
quiet fall back from the card to the CPU.

Failure isolation is per pair: a tile whose kernel raises (a tile the
kernel refuses, a CUDA error, out of memory) yields ``inf``, the
fail-closed marker the oracle maps to the paper's compile-timeout
penalty, is counted in ``failed_pairs`` and keeps its exception in
``failures``.  A failure never aborts the batch.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.measure import timing

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
MAX_FAILURES_KEPT = 64
# the reference's interpret-mode caps, applied on the CPU only
CPU_MAX_DIM, CPU_MAX_BATCH = 128, 2


def _ceil_mult(x: int, m: int) -> int:
    return -(-x // m) * m


class MeasureRunner:
    """Batched build-and-time hook: ``runner(sites, tiles) -> (n,) s``.

    ``reps``/``warmup``: the timing loop.  ``device``: ``"cuda"`` (the
    kernels) or ``"cpu"`` (the plain versions).  ``max_dim``/``max_batch``
    cap every dimension and the batch (0: uncapped); ``None`` takes the
    device's default, uncapped on the card and ``CPU_MAX_DIM``/
    ``CPU_MAX_BATCH`` on the CPU.  Capped lengths are snapped to tile
    multiples, so every tile the predicate admits runs.  ``seed``: of
    every pair's inputs."""

    def __init__(self, *, reps: int = 3, warmup: int = 1, device="cuda",
                 max_dim: Optional[int] = None,
                 max_batch: Optional[int] = None, seed: int = 0):
        if reps < 1:
            raise ValueError(f"reps must be >= 1, got {reps}")
        self.device = resolve_device(device)
        plain = self.device.type == "cpu"
        self.max_dim = (CPU_MAX_DIM if plain else 0) if max_dim is None \
            else max_dim
        self.max_batch = (CPU_MAX_BATCH if plain else 0) \
            if max_batch is None else max_batch
        self.reps = reps
        self.warmup = warmup
        self.seed = seed
        self.timed_pairs = 0            # successful timings performed
        self.failed_pairs = 0           # pairs that raised (-> inf)
        self.failures: list = []        # (site key, tiles, "Type: message")

    # -- identity ------------------------------------------------------------
    @property
    def backend_key(self) -> str:
        """Measurement-conditions fingerprint for the persistent DB key:
        torch and CUDA versions, the device's name and the mode, with the
        caps wherever they apply and a seed other than 0 (an uncapped
        card at seed 0 keeps the key it always had)."""
        caps = f"(dim<={self.max_dim},b<={self.max_batch})"
        if self.device.type == "cuda":
            name = torch.cuda.get_device_name(self.device)
            mode = "kernels" + (caps if self.max_dim or self.max_batch
                                else "")
        else:
            name, mode = "cpu", "plain" + caps
        if self.seed:
            mode += f":seed{self.seed}"
        return (f"torch{torch.__version__}:cuda{torch.version.cuda or '-'}"
                f":{name}:{mode}")

    # -- shape capping -------------------------------------------------------
    def _cap(self, v: int) -> int:
        return min(v, self.max_dim) if self.max_dim else v

    def _cap_b(self, v: int) -> int:
        return min(v, self.max_batch) if self.max_batch else v

    # -- per-kind kernel closures --------------------------------------------
    def _build(self, site, tiles):
        """A zero-argument callable running the site's kernel under the
        candidate tiles, its inputs already on the device."""
        from repro_torch.kernels import ops
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        dt = _DTYPES.get(str(site.dtype), torch.bfloat16)
        t = tuple(int(x) for x in tiles)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=self.device,
                               dtype=dt)

        if site.kind == "matmul":
            M, N, K = self._cap(site.m), self._cap(site.n), self._cap(site.k)
            x, w = randn(M, K), randn(K, N)
            return lambda: ops.matmul(x, w, tiles=t[:3])

        if site.kind == "attention":
            # site semantics: m=Sq, k=Skv, n=D, batch=B*H
            H = self._cap_b(site.batch)
            D = self._cap(site.n)
            bq, bkv = max(t[0], 1), max(t[1], 1)
            # blocks must divide the lengths: snap capped lengths up to the
            # tile multiple, as the reference does
            Sq = _ceil_mult(self._cap(site.m), min(bq, self._cap(site.m)))
            Skv = _ceil_mult(self._cap(site.k), min(bkv, self._cap(site.k)))
            q, k, v = randn(1, H, Sq, D), randn(1, H, Skv, D), \
                randn(1, H, Skv, D)
            scale = 1.0 / math.sqrt(D)
            return lambda: ops.flash_attention(
                q, k, v, causal=site.causal, scale=scale, tiles=t[:2])

        if site.kind == "chunk_scan":
            # site semantics: m=configured chunk, n=P, k=N,
            # batch=#instances; total scanned positions = batch * m
            P, N = self._cap(site.n), self._cap(site.k)
            S = self._cap(site.batch * site.m)
            Q = max(t[0], 1)
            S = _ceil_mult(S, min(Q, S))
            x = randn(1, S, P)
            Bm, Cm = randn(1, S, N) * 0.3, randn(1, S, N) * 0.3
            la = (-F.softplus(torch.randn((1, S), generator=gen,
                                          device=self.device))).to(dt)
            return lambda: ops.chunk_scan(x, Bm, Cm, la, chunk=Q)

        raise ValueError(site.kind)

    # -- measurement ---------------------------------------------------------
    def measure_one(self, site, tiles) -> float:
        """Seconds for one (site, tile) pair; ``inf`` on any failure."""
        try:
            fn = self._build(site, tiles)
            s = timing.median_time(fn, reps=self.reps, warmup=self.warmup,
                                  device=self.device)
        except Exception as e:         # fail closed, keep what went wrong
            self.failed_pairs += 1
            if len(self.failures) < MAX_FAILURES_KEPT:
                self.failures.append(
                    (site.key(), tuple(int(x) for x in tiles),
                     f"{type(e).__name__}: {str(e)[:300]}"))
            return float("inf")
        self.timed_pairs += 1
        return s

    def __call__(self, sites: Sequence, tiles) -> np.ndarray:
        """The batched ``MeasuredEnv.measure_fn`` hook: ``(n,) seconds``."""
        tiles = np.asarray(tiles, np.int64)
        return np.array([self.measure_one(s, t)
                         for s, t in zip(sites, tiles)], np.float64)
