"""Fused tune path: the cost grid, the legality mask and the greedy argmin
as one device dispatch (the port of ``repro/serving/fused.py``).

``core/costmodel_vec.py`` prices ``(n_sites, n_actions)`` grids in float64
NumPy; brute force is then a host argmin and a decode loop.  For serving
this module runs the same pipeline as tensor code on one device:

* the three per-kind cost kernels, op for op as the reference's (float32;
  every division by a constant divides by a device tensor, so that CUDA
  divides instead of multiplying by a reciprocal);
* every kind's tile grid padded into one ``(3, a_max, 3)`` tensor, the
  columns past a kind's action count set to ``inf``, so that a row argmin
  (first minimum on ties, as NumPy's) is the flat action;
* the head decode and the tile lookup on the device.

Which tiles are legal is ``legality``'s, as in
:class:`~repro_torch.core.env.CostModelEnv`: ``"tpu_v5e"`` is the
reference's VMEM mask exactly (the parity profile); ``"h100"`` and
``"cpu"`` are the Hopper kernels' launch rule (``kernels/ops.py``:
``matmul_tiles_legal``, ``attention_tiles_legal``, ``chunk_tiles_legal``,
the decode clause and the head-dim clause included), in integer tensor
arithmetic; its dtype clause is one bool per site and kind, computed on
the host while packing.  A site whose best cost is ``inf`` has no legal
tile: :meth:`FusedTuner.tune` raises ``ValueError`` for it.

On the card a call is one host-to-device copy of the packed columns, one
replay of a ``torch.cuda.CUDAGraph`` captured for the batch's bucket at
its first use, and one device-to-host copy of the results; a capture that
fails raises.  The batch is padded to a power-of-two bucket (rows repeat
row 0).  ``trace_count`` counts captures (on the CPU, the first use of
each bucket) and ``dispatch_count`` calls.

``surrogate=`` prices the legal tiles with the learned cost model
(:class:`~repro_torch.surrogate.model.SurrogateModel`) inside the same
pipeline: the 19 features in float64 as ``surrogate/features.py`` builds
them, the members' forward in float32 with TF32 off, so that the argmin is
:class:`~repro_torch.surrogate.SurrogateOracle`'s.
"""
from __future__ import annotations

import copy
import threading
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core import costmodel as cm
from repro_torch.core import costmodel_vec
from repro_torch.core.env import ActionSpace
from repro_torch.core.vectorizer import TileProgram
from repro_torch.device import resolve_device
from repro_torch.kernels import chunk_scan as kcs
from repro_torch.kernels import ops
from repro_torch.models.site import KernelSite
from repro_torch.surrogate.features import N_FEATURES
from repro_torch.surrogate.model import _full_f32

KINDS = ("matmul", "attention", "chunk_scan")
_KIND_IDX = {k: i for i, k in enumerate(KINDS)}
# the packed host columns, one float64 row a site
_COLS = ("m", "n", "k", "batch", "causal", "s", "peak", "kind",
         "dok0", "dok1", "dok2")
_LOG_CLAMP = 64.0           # surrogate prior stand-in for log2(inf)


def bucket_size(n: int, floor: int = 8) -> int:
    """Next power of two >= max(n, floor): bounds the distinct shapes."""
    b = floor
    while b < n:
        b *= 2
    return b


def _ceil(a, b):
    return -(-a // b)


def _pack_sites(sites: Sequence[KernelSite], pad_to: int,
                legality: str) -> np.ndarray:
    """(pad_to, len(_COLS)) float64: each site's dims, dtype bytes and
    peak, kind, and the launch rule's dtype clause for each kind (all true
    under ``"tpu_v5e"``); rows past ``len(sites)`` repeat row 0."""
    route = cm.ROUTE.get(legality)
    rows, dtypes = [], {}
    for s in sites:
        meta = dtypes.get(s.dtype)
        if meta is None:
            dok = [True] * 3 if route is None else [
                bool(ops.dtype_ok(s.dtype, route, k)) for k in KINDS]
            meta = dtypes[s.dtype] = (*costmodel_vec._dtype_meta(s.dtype),
                                      *dok)
        sb, peak, *dok = meta
        rows.append((s.m, s.n, s.k, s.batch, s.causal, sb, peak,
                     _KIND_IDX[s.kind], *dok))
    rows += [rows[0]] * (pad_to - len(rows))
    return np.asarray(rows, np.float64)


class FusedTuner:
    """Cost-model or surrogate tuning as one device dispatch.

    ``actions(sites)`` returns the ``(n, 3)`` head indices of the argmin
    over ``CostModelEnv(cfg, legality=legality).cost_grid`` (flat-action
    order and first-minimum ties kept); ``tune(sites)`` wraps them into a
    :class:`TileProgram`.  ``device`` is ``"cuda"`` (default) or
    ``"cpu"``; without CUDA a ``"cuda"`` tuner raises."""

    def __init__(self, cfg, surrogate=None, legality: str = "h100",
                 device="cuda"):
        self.cfg = cfg
        self.legality = cm.check_legality(legality)
        self.device = resolve_device(device)
        self.space = ActionSpace(cfg)
        self.surrogate = surrogate
        grids = {k: costmodel_vec.action_tiles_grid(self.space, k)
                 for k in KINDS}
        self._a_max = max(len(g) for g in grids.values())
        G = np.ones((3, self._a_max, 3), np.int64)
        NA = np.zeros((3,), np.int64)
        VS = np.ones((3, 3), np.int64)
        for i, k in enumerate(KINDS):
            G[i, :len(grids[k])] = grids[k]
            NA[i] = len(grids[k])
            VS[i] = self.space.valid_sizes(k)
        dev = self.device
        self._G = torch.as_tensor(G, device=dev)
        self._NA = torch.as_tensor(NA, device=dev)
        self._VS = torch.as_tensor(VS, device=dev)
        # doublings that take 1 to the widest tile: the exact integer
        # _pow2_at_least of the launch rule
        self._n_pow2 = int(G.max()).bit_length()
        self._consts: Dict[tuple, torch.Tensor] = {}
        if surrogate is not None:
            self._sur_stats = tuple(
                torch.as_tensor(np.asarray(x, np.float64), device=dev)
                for x in (surrogate.x_mean, surrogate.x_std))
            self._members = [m if surrogate.device == dev
                             else copy.deepcopy(m).to(dev)
                             for m in surrogate.members]
        self._graphs: Dict[int, tuple] = {}
        self._seen: set = set()
        self._lock = threading.Lock()
        self.trace_count = 0      # graph captures (CPU: new buckets)
        self.dispatch_count = 0   # tune/actions calls
        self.sites_tuned = 0
        self.last_padded_batch = 0

    # -- the pipeline (all of it on self.device) ----------------------------
    def _c(self, value: float, dtype=torch.float32) -> torch.Tensor:
        """A constant divisor as a 0-d device tensor (made before any
        capture, reused by every replay)."""
        key = (value, dtype)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.tensor(value, dtype=dtype,
                                                 device=self.device)
        return t

    def _mxu_util(self, bm, bn, bk, ft):
        mxu, lane = self._c(cm.MXU, ft), self._c(cm.LANE, ft)
        u = (torch.clamp_max(bm, cm.MXU).to(ft) / mxu
             * (torch.clamp_max(bn, cm.LANE).to(ft) / lane))
        u = torch.where(bm % cm.SUBLANE != 0, u * 0.6, u)
        u = torch.where(bn % cm.LANE != 0, u * 0.5, u)
        u = u * (bk.to(ft) / (bk + cm.MXU).to(ft))
        return torch.clamp_min(u, 1e-3)

    def _pow2_at_least(self, x, lo: int):
        p = torch.full_like(x, lo)
        for _ in range(self._n_pow2):
            p = torch.where(p < x, p * 2, p)
        return p

    def _matmul(self, c, t0, t1, t2, ft, legality):
        M, N, K, s, peak = c["m"], c["n"], c["k"], c["s"], c["peak"].to(ft)
        tm, tn, tk = _ceil(M, t0), _ceil(N, t1), _ceil(K, t2)
        if legality == "tpu_v5e":
            vmem = 2 * (t0 * t2 + t2 * t1) * s + t0 * t1 * 4 + t0 * t1 * s
            legal = vmem <= cm.VMEM_BYTES
        else:
            rows = self._pow2_at_least(
                torch.minimum(t0, _ceil(M, 8) * 8), 16)
            cols = self._pow2_at_least(
                torch.minimum(t1, _ceil(N, 128) * 128), 128)
            legal = (c["dok0"] & (t0 > 0) & (t1 > 0) & (t2 > 0)
                     & (rows <= ops.MM_MAX_ROWS) & (cols <= ops.MM_MAX_COLS)
                     & (rows * cols <= ops.MM_ACC_LIMIT))
        pm, pn, pk = (tm * t0).to(ft), (tn * t1).to(ft), (tk * t2).to(ft)
        grid = tm.to(ft) * tn.to(ft) * tk.to(ft)
        flops = 2.0 * pm * pn * pk
        t_compute = flops / (peak * self._mxu_util(t0, t1, t2, ft))
        sf, tmf, tnf = s.to(ft), tm.to(ft), tn.to(ft)
        bytes_ = pm * pk * tnf * sf + pk * pn * tmf * sf + pm * pn * sf
        t_mem = bytes_ / self._c(cm.HBM_BW, ft)
        cost = (torch.maximum(t_compute, t_mem)
                + grid * cm.GRID_STEP_OVERHEAD + cm.FIXED_OVERHEAD)
        return cost, legal

    def _attention(self, c, t0, t1, t2, ft, legality):
        # site semantics: m=Sq, k=Skv, n=D, batch=B*H; tiles (bq, bkv, 1)
        Sq, Skv, D, BH = c["m"], c["k"], c["n"], c["batch"]
        causal, s, peak = c["causal"], c["s"], c["peak"].to(ft)
        bq, bkv = t0, t1
        tq, tkv = _ceil(Sq, bq), _ceil(Skv, bkv)
        if legality == "tpu_v5e":
            vmem = (2 * (bq * D + 2 * bkv * D) * s + bq * D * 4 + 2 * bq * 4
                    + bq * bkv * 4)
            legal = vmem <= cm.VMEM_BYTES
        else:
            bq_e = torch.clamp_min(torch.minimum(bq, Sq), 1)
            bkv_e = torch.clamp_min(torch.minimum(bkv, Skv), 1)
            head_ok = (D >= 8) & (D % 8 == 0) & (D <= ops.ATTN_D_MAX)
            launched = (head_ok & (bq_e <= ops.ATTN_MAX_BQ)
                        & (Sq % bq_e == 0) & (Skv % bkv_e == 0))
            legal = c["dok1"] & (bq > 0) & (bkv > 0) & ((Sq == 1) | launched)
        pq, pkv = (tq * bq).to(ft), (tkv * bkv).to(ft)
        BHf, Df, sf = BH.to(ft), D.to(ft), s.to(ft)
        grid = BHf * tq.to(ft) * tkv.to(ft)
        one = self._c(1.0, ft)
        frac = torch.where(
            causal, 0.5 * (1 + one / torch.clamp_min(tq, 1).to(ft)), one)
        flops = 4.0 * BHf * pq * pkv * Df * frac
        vpu_ops = 6.0 * BHf * pq * pkv * frac
        t_compute = (flops / (peak * self._mxu_util(bq, bkv, D, ft))
                     + vpu_ops / self._c(cm.PEAK_FLOPS_BF16 / 16, ft))
        bytes_ = BHf * sf * (pq * Df + 2 * pkv * Df * tq.to(ft) * frac
                             + pq * Df)
        t_mem = bytes_ / self._c(cm.HBM_BW, ft)
        cost = (torch.maximum(t_compute, t_mem)
                + grid * frac * cm.GRID_STEP_OVERHEAD + cm.FIXED_OVERHEAD)
        return cost, legal

    def _chunk_scan(self, c, t0, t1, t2, ft, legality):
        # tiles (chunk, 1, 1); P=site.n, N=site.k
        m, P, N, batch, s = c["m"], c["n"], c["k"], c["batch"], c["s"]
        peak = c["peak"].to(ft)
        Q = t0
        tokens = batch * m
        if legality == "tpu_v5e":
            vmem = 2 * Q * (P + 2 * N) * s + P * N * 4 + Q * Q * 4
            legal = vmem <= cm.VMEM_BYTES
        else:
            q_e = torch.minimum(Q, tokens)
            legal = (c["dok2"] & (Q > 0) & (q_e <= kcs.Q_MAX) & (N >= 8)
                     & (N % 8 == 0) & (N <= kcs.N_MAX))
        chunks_total = _ceil(tokens, Q)
        Qf, Nf, Pf = Q.to(ft), N.to(ft), P.to(ft)
        per_chunk = (2.0 * Qf * Qf * Nf + 2.0 * Qf * Qf * Pf
                     + 4.0 * Qf * Pf * Nf)
        flops = per_chunk * chunks_total.to(ft)
        t_compute = flops / (peak * self._mxu_util(Q, torch.maximum(P, N),
                                                   Q, ft))
        bytes_ = tokens.to(ft) * (P + 2 * N).to(ft) * s.to(ft) * 2
        t_mem = bytes_ / self._c(cm.HBM_BW, ft)
        cost = (torch.maximum(t_compute, t_mem)
                + chunks_total.to(ft) * cm.GRID_STEP_OVERHEAD
                + cm.FIXED_OVERHEAD)
        return cost, legal

    def _grid(self, c, kidx, t, ft, legality):
        """(B, a_max) costs and legality, each kind's formulas selected by
        the row's kind."""
        t0, t1, t2 = t[..., 0], t[..., 1], t[..., 2]
        cost = legal = None
        for i, fn in enumerate((self._matmul, self._attention,
                                self._chunk_scan)):
            ci, li = fn(c, t0, t1, t2, ft, legality)
            sel = (kidx == i)[:, None]
            cost = ci if cost is None else torch.where(sel, ci, cost)
            legal = li if legal is None else torch.where(sel, li, legal)
        return cost, legal

    def _surrogate_seconds(self, c, kidx, t):
        """(B, a_max) predicted seconds: ``surrogate/features.py``'s 19
        features in float64, the members' forward in float32."""
        f64 = torch.float64
        B, A = kidx.shape[0], self._a_max

        def col(x):                         # (B, 1) -> (B, a_max, 1)
            return x.to(f64).expand(B, A)[..., None]

        def log2(x):
            return torch.log2(torch.clamp_min(x, 1e-300))

        tf = t.to(f64)
        dims = torch.cat([c["m"], c["n"], c["k"], c["batch"]], 1).to(f64)
        ldims = log2(dims)                                      # (B, 4)
        lt = log2(tf)
        t0, t1, t2 = tf[..., 0], tf[..., 1], tf[..., 2]
        m, n, k, b = (dims[:, i:i + 1] for i in range(4))
        s = c["s"].to(f64)
        vmem = torch.where(
            kidx[:, None] == 0,
            2 * (t0 * t2 + t2 * t1) * s + t0 * t1 * 4 + t0 * t1 * s,
            torch.where(
                kidx[:, None] == 1,
                (2 * (t0 * n + 2 * t1 * n) * s + t0 * n * 4 + 2 * t0 * 4
                 + t0 * t1 * 4),
                2 * t0 * (n + 2 * k) * s + n * k * 4 + t0 * t0 * 4))
        steps = torch.where(
            kidx[:, None] == 0,
            torch.ceil(m / t0) * torch.ceil(n / t1) * torch.ceil(k / t2),
            torch.where(kidx[:, None] == 1,
                        b * torch.ceil(m / t0) * torch.ceil(k / t1),
                        torch.ceil(b * m / t0)))
        steps = torch.clamp_min(steps, 1.0)
        prior, prior_legal = self._grid(c, kidx, t, f64, "tpu_v5e")
        prior = torch.where(prior_legal, prior, torch.inf)
        feats = ([col(kidx[:, None] == i) for i in range(3)]
                 + [col(ldims[:, i:i + 1]) for i in range(4)]
                 + [col(c["s"]), col(c["causal"]), lt,
                    lt - ldims[:, None, :3],
                    log2(vmem)[..., None],
                    (vmem / self._c(float(cm.VMEM_BYTES), f64))[..., None],
                    log2(steps)[..., None],
                    torch.where(torch.isfinite(prior), log2(prior),
                                self._c(_LOG_CLAMP, f64))[..., None]])
        X = torch.cat(feats, -1).reshape(-1, N_FEATURES)
        x_mean, x_std = self._sur_stats
        Xn = ((X - x_mean) / x_std).to(torch.float32)
        pred = torch.stack([m_(Xn).to(f64) for m_ in self._members]).mean(0)
        pred = pred * self.surrogate.y_std + self.surrogate.y_mean
        return torch.exp(pred).reshape(B, A)

    def _impl(self, packed: torch.Tensor) -> torch.Tensor:
        """packed (B, len(_COLS)) float64 -> (B, 7) float64: head indices,
        tiles and the best cost.  ``peak`` stays float64 here: each cost
        kernel rounds it to its own precision."""
        c = {name: packed[:, i:i + 1] for i, name in enumerate(_COLS)}
        for name in ("m", "n", "k", "batch", "s"):
            c[name] = c[name].long()
        for name in ("causal", "dok0", "dok1", "dok2"):
            c[name] = c[name] != 0
        kidx = packed[:, _COLS.index("kind")].long()
        t = self._G[kidx]                                # (B, a_max, 3)
        cost, legal = self._grid(c, kidx, t, torch.float32, self.legality)
        if self.surrogate is not None:
            cost = self._surrogate_seconds(c, kidx, t)
        cost = torch.where(legal, cost, torch.inf)
        pad = (torch.arange(self._a_max, device=self.device)[None, :]
               >= self._NA[kidx][:, None])
        cost = torch.where(pad, torch.inf, cost)
        flat = torch.argmin(cost, dim=1)                 # first minimum
        tiles = torch.gather(t, 1, flat[:, None, None].expand(-1, 1, 3))[:, 0]
        vs = self._VS[kidx]
        heads = torch.stack([torch.div(flat, vs[:, 1] * vs[:, 2],
                                       rounding_mode="floor"),
                             torch.div(flat, vs[:, 2],
                                       rounding_mode="floor") % vs[:, 1],
                             flat % vs[:, 2]], -1)
        best = torch.gather(cost, 1, flat[:, None])
        return torch.cat([heads.double(), tiles.double(), best.double()], 1)

    def _nograd_impl(self, packed):
        with torch.no_grad(), _full_f32(self.device):
            return self._impl(packed)

    # -- dispatch --------------------------------------------------------------
    def _capture(self, b: int, packed_host: torch.Tensor) -> tuple:
        """Capture the pipeline for bucket ``b`` in a CUDA graph: static
        input and output buffers, a pinned host buffer for each copy."""
        static_in = torch.empty((b, len(_COLS)), dtype=torch.float64,
                                device=self.device)
        static_in.copy_(packed_host)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._nograd_impl(static_in)   # load the kernels, size the pool
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            static_out = self._nograd_impl(static_in)
        host_in = torch.empty((b, len(_COLS)), dtype=torch.float64,
                              pin_memory=True)
        host_out = torch.empty(tuple(static_out.shape), dtype=torch.float64,
                               pin_memory=True)
        self.trace_count += 1
        return graph, static_in, static_out, host_in, host_out

    def _run(self, sites: Sequence[KernelSite]) -> np.ndarray:
        n = len(sites)
        b = bucket_size(n)
        packed = torch.from_numpy(_pack_sites(sites, b, self.legality))
        with self._lock:
            if self.device.type == "cuda":
                g = self._graphs.get(b)
                if g is None:
                    g = self._graphs[b] = self._capture(b, packed)
                graph, static_in, static_out, host_in, host_out = g
                host_in.copy_(packed)
                static_in.copy_(host_in, non_blocking=True)
                graph.replay()
                host_out.copy_(static_out, non_blocking=True)
                torch.cuda.current_stream(self.device).synchronize()
                out = host_out.numpy().copy()
            else:
                if b not in self._seen:
                    self._seen.add(b)
                    self.trace_count += 1
                out = self._nograd_impl(packed).numpy()
            self.dispatch_count += 1
            self.sites_tuned += n
            self.last_padded_batch = b
        return out[:n]

    # -- host entry points ---------------------------------------------------
    def actions(self, sites: Sequence[KernelSite]) -> np.ndarray:
        """(n, 3) greedy head indices: the argmin on the device (a site
        with no legal tile gets action 0, as brute-force labels do)."""
        if not len(sites):
            return np.zeros((0, 3), np.int64)
        return self._run(sites)[:, :3].astype(np.int64)

    def tune(self, sites: Sequence[KernelSite]) -> TileProgram:
        """Greedy tiles for ``sites`` as one device dispatch; ``ValueError``
        for a site with no legal tile."""
        out = self.tune_each([sites])[0]
        if isinstance(out, Exception):
            raise out
        return out

    def tune_many(self, site_lists) -> List[TileProgram]:
        """One program per request from one dispatch over the
        concatenation; the per-site costs are row-independent, so each
        slice is what tuning that request alone gives.  Raises the first
        request's ``ValueError`` for a site with no legal tile."""
        out = self.tune_each(site_lists)
        for p in out:
            if isinstance(p, Exception):
                raise p
        return out

    def tune_each(self, site_lists) -> list:
        """As :meth:`tune_many`, but a request with a site that has no
        legal tile gets its ``ValueError`` in its place, and the rest
        their programs."""
        site_lists = [list(sl) for sl in site_lists]
        flat = [s for sl in site_lists for s in sl]
        if not flat:
            return [TileProgram() for _ in site_lists]
        out = self._run(flat)
        tiles, best = out[:, 3:6].astype(np.int64), out[:, 6]
        res, off = [], 0
        for sl in site_lists:
            rows = slice(off, off + len(sl))
            off += len(sl)
            bad = [s for s, c in zip(sl, best[rows]) if not np.isfinite(c)]
            if bad:
                res.append(ValueError(f"no legal action for site "
                                      f"{bad[0].key()}"))
                continue
            res.append(TileProgram({s.key(): tuple(int(x) for x in tv)
                                    for s, tv in zip(sl, tiles[rows])}))
        return res

    def stats(self) -> Dict[str, float]:
        return {"serving_fused_dispatches_total": self.dispatch_count,
                "serving_fused_traces_total": self.trace_count,
                "serving_fused_sites_total": self.sites_tuned}
