"""Device ms a prefill in what is not the port's K1, K2 or K3: PyTorch's
own kernels (elementwise ops, norms, einsums through cuBLAS, the MoE's
gathers), copies and fills, from the trace."""
from perfbench import timeline


def read(rec):
    t = rec.trace
    if t is None or not t.prefills:
        return None
    fam = timeline.device_us_by_family(t.events, t.t0, t.t1)
    if not fam:
        return None
    return fam.get("other", 0.0) * 1e-3 / t.prefills
