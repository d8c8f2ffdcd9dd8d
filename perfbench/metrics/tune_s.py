"""The tuner's share of set-up: the facade's fit and tune of the serve
sites (host clock)."""


def read(rec):
    return rec.tune_s
