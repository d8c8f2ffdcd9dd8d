"""Set-up time: process start to the first timed prefill (host clock):
imports, weights, site extraction, the fit and the tune, warm-up and, on
a checkout's first run, the kernels' build."""


def read(rec):
    return rec.setup_s
