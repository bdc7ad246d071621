"""95th percentile of the traced window's step latencies, ms (too spread
between runs of a host-bound step to hold to a bound)."""

from hgnnbench import readers


def read(r):
    return readers.p95_ms(r, "train")
