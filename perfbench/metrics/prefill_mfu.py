"""The whole prefill's share of the card's bf16 peak, in %: the model's
operations in one prefill (counted from the configuration, useful work
only: ``perfbench.work.prefill_flops``) times the prefills, over their
time on the host's clock, over 989 TFLOP/s.  Read over the traced run's
untraced prefills, after the profiler has stopped."""
from perfbench import work


def read(rec):
    n, seconds = rec.after_trace
    if n < 1 or seconds <= 0:
        return None
    flops = work.prefill_flops(rec.spec, rec.batch, rec.seq) * n
    return 100.0 * flops / seconds / work.PEAK_BF16
