"""K2's share of its roofline in the traced prefills, in %: the bound
of every call one prefill makes to it (``perfbench.work``: operations at
989 TFLOP/s or bytes at 3.35 TB/s, whichever is longer, a call at a
time) times the prefills, over the device time of its kernels
(``perfbench.work.KERNELS["k2"]``) in the trace."""
from perfbench import timeline, work


def read(rec):
    t = rec.trace
    if t is None or not t.prefills:
        return None
    us = timeline.device_us_by_family(t.events, t.t0, t.t1).get("k2", 0.0)
    if us <= 0:
        return None
    bound = work.engine_bound_s(rec.spec, rec.batch, rec.seq, "k2")
    return 100.0 * bound * t.prefills / (us * 1e-6)
