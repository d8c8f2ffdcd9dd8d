"""Device idle ms a traced prefill while the host ran the port's own
Python: the traced window's idle gaps (``timeline.idle_by_host_op``)
whose innermost host range is one of the program's ``nv.*`` spans, with
no PyTorch op or runtime call open, over the traced prefills.  Nothing
where the trace holds no ``nv.*`` range (a program without the spans) or
no device activity (a CPU run)."""
from perfbench import timeline

PREFIX = "nv."


def read(rec):
    t = rec.trace
    if t is None or not t.prefills or \
            timeline.busy_us(t.events, t.t0, t.t1) <= 0 or not any(
                not e.device and e.name.startswith(PREFIX)
                for e in t.events):
        return None
    idle = timeline.idle_by_host_op(t.events, t.t0, t.t1)
    return sum(us for name, us in idle.items()
               if name.startswith(PREFIX)) * 1e-3 / t.prefills
