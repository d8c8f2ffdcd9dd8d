"""The 95th percentile of every prefill's latency in the window, in ms
(host clock, each prefill from its cache's reset to its logits on the
host's side of a synchronise): the time to first token of a batch of
requests.  Nearest rank: the ceil(0.95 n)-th smallest."""
import math


def read(rec):
    lat = sorted(rec.latencies_s)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
