"""The share of the traced window, in %, in which nothing ran on the
card: one less the union of its kernels, copies and fills over the
window from the first traced prefill's start to the last one's end."""
from perfbench import timeline


def read(rec):
    t = rec.trace
    if t is None or t.t1 <= t.t0:
        return None
    busy = timeline.busy_us(t.events, t.t0, t.t1)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (t.t1 - t.t0))
