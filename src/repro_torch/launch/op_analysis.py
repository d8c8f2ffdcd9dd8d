"""Per-device op accounting of a step run on fake tensors (the
counterpart of ``repro/launch/hlo_analysis.py``).  The port has no HLO:
it runs the step eagerly, so :func:`analyze` runs it once under a
counting ``FakeTensorMode`` and reads the ops it executes.  Every count
is per device, as the reference's are (the module it reads is the
partitioned program): on DTensors the counted ops are the local ones
that DTensor dispatches on each rank's shards.

* ``flops``       — matmul-class ops only (``mm``, ``bmm``, ``addmm``,
                    ``baddbmm``): 2·M·N·K on the local shards, as the
                    reference counts dot ops alone.
* ``bytes``       — every executed op that moves data (views, factory
                    calls and metadata ops excluded): its tensor reads
                    plus its writes.  That is un-fused eager traffic, what
                    the port runs, and not XLA's post-fusion figure.
* ``collectives`` — the bytes of each c10d collective the rank issues
                    (the result's size, as the reference counts), by kind
                    (``all_gather``, ``all_reduce``, ``reduce_scatter``,
                    ``all_to_all``) and ``total``; ``top_collectives``
                    the largest sites.

Loops need no trip counts: Python runs every iteration, so a layer
recomputed under ``torch.utils.checkpoint`` is counted as executed.  The
one exception is the sLSTM's loop over time, which at a long sequence is
millions of fake dispatches: while counting it runs as a batched body
over blocks of the time axis (``models/xlstm.py:_slstm_counted``, taken
only where :func:`counting_active` holds for the step's fake tensors),
the way the reference counts a ``lax.scan`` body once times its trip
count.  Its flops and collectives are the stepwise loop's exactly.  The
bytes the loop moves beyond the body are added by :func:`add_bytes`, in
the forward and in the backward, and what it saves for the backward
beyond the body is held as one live fake buffer: R's re-reads among them
(each of S steps copies the recurrent weight R into the product's
layout, reads the copy and keeps it for the backward, which writes the
step's part of dR and adds it into the sum, where the body touches R
once or twice), and each step's gradient the size of the whole input
projection.  The loop is counted at 3, 4 and 5 steps on fake tensors and
extended to S as the polynomial of degree 2 in S that these bytes are.
DTensor's sharding propagation runs each op once on global-shape fake
tensors to learn its output's shape; those runs are not counted.  Nor
are the ops the fake mode runs to decompose an op it was handed (it does
so the first time it meets a signature, and then caches the result), so
a count does not depend on what the process ran before.

The mode also follows the bytes of live fake storage (``peak_bytes``):
each storage counts from the op that makes it until its last tensor is
freed.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import traceback
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._pytree import tree_flatten, tree_map

_MATMUL = {"aten.mm.default", "aten.bmm.default", "aten.addmm.default",
           "aten.baddbmm.default"}
_COLLECTIVE = {"all_gather_into_tensor": "all_gather",
               "all_reduce": "all_reduce",
               "reduce_scatter_tensor": "reduce_scatter",
               "all_to_all_single": "all_to_all"}
# ops that read or write no tensor data
_NO_DATA = {"empty", "empty_strided", "empty_like", "new_empty",
            "new_empty_strided", "device", "detach", "lift_fresh",
            "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
            "is_same_size", "_to_copy_meta", "wait_tensor"}

_TLS = threading.local()
_ACTIVE: list = []               # the counters counting, innermost last


def counting_active(t: torch.Tensor = None) -> bool:
    """True while an :class:`OpCounter` counts in this process (and, with
    ``t``, when ``t`` is one of its fake tensors): the predicate of the
    count-only stand-ins.  A real tensor never satisfies it."""
    if not _ACTIVE:
        return False
    return t is None or isinstance(t, torch._subclasses.FakeTensor)


def active_counter() -> "OpCounter":
    """The innermost counter counting (``None`` when none is)."""
    return _ACTIVE[-1] if _ACTIVE else None


def add_bytes(n: float) -> None:
    """Add ``n`` bytes of traffic to the counting counter (a stand-in's
    share of work it did not dispatch)."""
    if _ACTIVE and not _in_propagation():
        _ACTIVE[-1].bytes += n


def _in_propagation() -> bool:
    return getattr(_TLS, "propagating", 0) > 0


@contextlib.contextmanager
def _dtensor_patched():
    """Three changes to DTensor's internals while counting: mark its shape
    propagation, whose global-shape runs of each op are not the rank's
    work; run its index arithmetic for strided shards on real tensors (it
    reads their values, which a fake tensor has not); and plan every
    redistribution greedily, mesh dim by mesh dim (its search over
    placement graphs, which it takes for strided shards, does not end in
    useful time on a 3-D mesh)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _redistribute
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name)
    orig_offsets = _StridedShard.local_shard_size_and_offset
    orig_plan = _redistribute._gen_transform_infos_non_cached

    def greedy_plan(src, dst, use_graph_based_transform=None):
        drp = _redistribute.get_redistribute_planner(src.device_mesh,
                                                     src.tensor_meta)
        return drp.generate_greedy_transform_infos(src, dst)

    def marked(self, *a, **k):
        _TLS.propagating = getattr(_TLS, "propagating", 0) + 1
        try:
            return orig(self, *a, **k)
        finally:
            _TLS.propagating -= 1

    def real_offsets(self, *a, **k):
        with unset_fake_temporarily():
            return orig_offsets(self, *a, **k)
    setattr(ShardingPropagator, name, marked)
    _StridedShard.local_shard_size_and_offset = real_offsets
    _redistribute._gen_transform_infos_non_cached = greedy_plan
    _redistribute._gen_transform_infos.cache_clear()
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)
        _StridedShard.local_shard_size_and_offset = orig_offsets
        _redistribute._gen_transform_infos_non_cached = orig_plan
        _redistribute._gen_transform_infos.cache_clear()


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _site() -> str:
    """The two innermost frames of the port's own code that issued an op,
    innermost first."""
    frames = [f"{fr.filename.rsplit('repro_torch/', 1)[-1]}:{fr.lineno}"
              for fr in reversed(traceback.extract_stack(limit=48))
              if "repro_torch" in fr.filename
              and "op_analysis" not in fr.filename]
    return " < ".join(frames[:2]) or "?"


class OpCounter(FakeTensorMode):
    """A ``FakeTensorMode`` that counts the local ops it executes (see
    the module's docstring).  Create tensors under it (``with counter:``),
    then :meth:`reset` and run the step."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self._depth = 0           # plain ops being dispatched, nested
        self.reset()

    def reset(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = defaultdict(float)
        self.coll_sites = defaultdict(float)
        self._live = {}           # storage id -> [bytes, live tensors]
        self.live_bytes = 0
        self.peak_bytes = 0

    def snapshot(self) -> tuple:
        """The counts, to :meth:`restore` after a probe whose ops must
        not count (its tensors freed by then)."""
        return (self.flops, self.bytes, dict(self.coll),
                dict(self.coll_sites), self.live_bytes, self.peak_bytes)

    def restore(self, snap: tuple) -> None:
        flops, nbytes, coll, sites, live, peak = snap
        if self.live_bytes != live:        # a probe tensor in a cycle
            gc.collect()
        if self.live_bytes != live:
            raise RuntimeError("a probe's fake tensors outlived it")
        self.flops, self.bytes, self.peak_bytes = flops, nbytes, peak
        self.coll = defaultdict(float, coll)
        self.coll_sites = defaultdict(float, sites)

    # -- live storage -----------------------------------------------------
    def _release(self, key):
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._live[key]

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until its last tracked tensor is
        freed (a DTensor by its local shard)."""
        if _is_dtensor(t):
            t = t._local_tensor
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [st.nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    # -- dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(_is_dtensor(a) for a in flat):
            return super().__torch_dispatch__(func, types, args, kwargs)
        self._depth += 1
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if not self._depth and not _in_propagation():
            self._count(func, flat, out)
        return out

    def _count(self, func, flat_in, out):
        name = str(func)
        ns, op = name.split(".")[0], name.split(".")[1]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if ns == "_c10d_functional" and op in _COLLECTIVE:
            b = sum(_nbytes(t) for t in outs)
            kind = _COLLECTIVE[op]
            self.coll[kind] += b
            self.coll_sites[(kind, _site())] += b
        if name in _MATMUL:
            a, b = [t for t in flat_in if isinstance(t, torch.Tensor)][-2:]
            k = a.shape[-1]
            self.flops += 2.0 * outs[0].numel() * k
        if not (getattr(func, "is_view", False) or op in _NO_DATA
                or ns == "prim"):
            self.bytes += sum(_nbytes(t) for t in flat_in
                              if isinstance(t, torch.Tensor))
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self.track(t)

    def result(self) -> dict:
        coll = dict(self.coll)
        coll["total"] = sum(coll.values())
        top = sorted(self.coll_sites.items(), key=lambda kv: -kv[1])[:12]
        return {"flops": self.flops, "bytes": self.bytes,
                "collectives": coll,
                "top_collectives": [{"kind": k, "bytes": v, "op": t}
                                    for (k, t), v in top]}

    @contextlib.contextmanager
    def counting(self):
        """Count what runs inside (this mode active, DTensor's shape
        propagation left out)."""
        with self, _dtensor_patched():
            _ACTIVE.append(self)
            try:
                yield self
            finally:
                _ACTIVE.remove(self)


def analyze(fn, *args, counter: OpCounter = None) -> dict:
    """Run ``fn(*args)`` once under a counting fake mode and return the
    reference's keys: ``flops``, ``bytes``, ``collectives`` and
    ``top_collectives``, per device.  Real tensor arguments are faked
    first; fake and DTensor arguments must come from ``counter``."""
    counter = counter or OpCounter()
    with counter.counting():
        args = tree_map(
            lambda t: counter.from_tensor(t)
            if isinstance(t, torch.Tensor) and not _is_dtensor(t)
            and not isinstance(t, torch._subclasses.FakeTensor) else t,
            args)
        counter.reset()
        for t in tree_flatten(args)[0]:
            if isinstance(t, torch.Tensor):
                counter.track(t)
        fn(*args)
    return counter.result()
