"""A metapath model's training step (HAN: every semantic graph's NA in one
launch): the window's wall time over the steps it completed, ms."""


def read(q):
    return q["mean_ms"]
