"""A relation model's training step (R-GAT: the kernels once a relation
and layer): the window's wall time over the steps it completed, ms."""


def read(q):
    return q["mean_ms"]
