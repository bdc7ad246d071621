"""95th percentile (nearest rank) of every forward's latency in the
window, ms."""


def read(q):
    return q["p95_ms"]
