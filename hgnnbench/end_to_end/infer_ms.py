"""A full-graph forward, ending in a synchronise: the window's wall time
over the forwards it completed, ms."""


def read(q):
    return q["mean_ms"]
